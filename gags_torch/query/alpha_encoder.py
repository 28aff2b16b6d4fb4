"""AlphaCLIP encoder: region-focused CLIP embeddings through an alpha mask
(port of gags_tpu.query.alpha_encoder).

The vision tower is `models.clip.VisionTowerAlpha` (the open_clip ViT
plus a single-channel patch conv of the mask); the relevancy math is the
OpenCLIP path's (`query.relevancy`). Weights are the user's (alpha_clip
checkpoints; none ships with the repository): `AlphaClipEncoder.
from_checkpoint`. Images are NCHW and CLIP-normalised, masks NCHW after
`mask_transform`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from gags_torch import resolve_device
from gags_torch.models.clip import (
    CLIPConfig,
    TextTower,
    VisionTowerAlpha,
    _as_state,
    load_alphaclip_state_dict,
)
from gags_torch.query.relevancy import DEFAULT_NEGATIVES, max_across_levels, relevancy

# alpha_clip mask transform: ToTensor -> resize -> Normalize(0.5, 0.26)
_MASK_MEAN = 0.5
_MASK_STD = 0.26


def mask_transform(alpha):
    """[0, 1] mask → the normalised alpha channel alpha_clip feeds its conv."""
    if isinstance(alpha, torch.Tensor):
        return (alpha.to(torch.float32) - _MASK_MEAN) / _MASK_STD
    return (np.asarray(alpha, np.float32) - _MASK_MEAN) / _MASK_STD


def load_text_tower(state, cfg: CLIPConfig, device="cuda") -> TextTower:
    """The text keys of an open_clip-layout checkpoint (everything but
    `visual.*` and `logit_scale`) → a float32 TextTower, loaded strictly."""
    text = {k: v for k, v in _as_state(state).items()
            if not k.startswith("visual.") and k != "logit_scale"}
    model = TextTower(cfg, device="meta").to_empty(device=resolve_device(device))
    model.load_state_dict(text, strict=True)
    return model.eval()


class AlphaClipEncoder:
    """Reference API: set_positives / encode_image / get_relevancy /
    get_max_across."""

    def __init__(self, cfg: CLIPConfig, visual: VisionTowerAlpha, text: TextTower,
                 tokenizer=None):
        self.cfg = cfg
        self.visual = visual.eval()
        self.text = text.eval()
        self.tokenizer = tokenizer
        self._neg_embeds: Optional[torch.Tensor] = None
        self.pos_embeds: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.visual.proj.device

    @property
    def neg_embeds(self) -> torch.Tensor:
        # lazy: a tokenizer needs the BPE merges file
        if self._neg_embeds is None:
            self._neg_embeds = self.encode_text(list(DEFAULT_NEGATIVES))
        return self._neg_embeds

    @classmethod
    def from_checkpoint(cls, path: str, cfg: Optional[CLIPConfig] = None, tokenizer=None,
                        device="cuda") -> "AlphaClipEncoder":
        cfg = cfg or CLIPConfig.vit_b_16()
        state = torch.load(path, map_location="cpu", weights_only=True)
        return cls(cfg, load_alphaclip_state_dict(state, cfg, device=device),
                   load_text_tower(state, cfg, device=device), tokenizer)

    @torch.no_grad()
    def encode_text(self, texts: Sequence[str]) -> torch.Tensor:
        if self.tokenizer is None:
            from gags_torch.models.tokenizer import ClipTokenizer

            self.tokenizer = ClipTokenizer()
        tokens = np.asarray(self.tokenizer(list(texts)))
        cl = self.cfg.context_length
        if tokens.shape[1] > cl:
            tokens = tokens[:, :cl]
        elif tokens.shape[1] < cl:
            tokens = np.pad(tokens, ((0, 0), (0, cl - tokens.shape[1])))
        emb = self.text(torch.as_tensor(tokens, device=self.device))
        return emb / torch.linalg.norm(emb, dim=-1, keepdim=True)

    def set_positives(self, texts: Sequence[str]) -> None:
        self.pos_embeds = self.encode_text(texts)

    @torch.no_grad()
    def encode_image(self, images: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
        """images (B, 3, S, S) CLIP-normalised; alpha (B, 1, S, S) after
        mask_transform → (B, D) unit-norm embeddings."""
        emb = self.visual(images.to(self.device), alpha.to(self.device))
        return emb / torch.linalg.norm(emb, dim=-1, keepdim=True)

    def get_relevancy(self, embeds: torch.Tensor, positive_id: int) -> torch.Tensor:
        if self.pos_embeds is None:
            raise ValueError("call set_positives first")
        return relevancy(embeds, self.pos_embeds[positive_id:positive_id + 1], self.neg_embeds)

    def get_max_across(self, sem_map: torch.Tensor) -> torch.Tensor:
        if self.pos_embeds is None:
            raise ValueError("call set_positives first")
        return max_across_levels(sem_map, self.pos_embeds, self.neg_embeds)
