"""CLIP (OpenCLIP-compatible) image and text towers (port of
gags_tpu.models.clip).

Submodules and parameters carry open_clip's state-dict names
(`visual.conv1.weight`, `visual.transformer.resblocks.{i}.attn.in_proj_weight`,
`transformer.resblocks.{i}...`, `token_embedding.weight`, `text_projection`,
`logit_scale`), which is why they look as they do: an open_clip ViT-B-16
checkpoint loads with `load_state_dict(strict=True)` and
`ckpt_inventory.openclip_inventory` is a check of `state_dict()` shapes.
The text tower's parts sit at the top level of CLIP, as in open_clip, so
`CLIP` extends `TextTower`. AlphaCLIP's visual tower adds `conv1_alpha`.

Images are NCHW and CLIP-normalised (`preprocess_images`). No weights ship
with the repository; tests use small random configurations.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gags_torch import resolve_device
from gags_torch.utils.image import resize_like_jax

CLIP_IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int = 512
    # vision
    image_size: int = 224
    patch_size: int = 16
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    # text
    vocab_size: int = 49408
    context_length: int = 77
    text_width: int = 512
    text_heads: int = 8
    text_layers: int = 12

    @staticmethod
    def vit_b_16() -> "CLIPConfig":
        return CLIPConfig()

    @staticmethod
    def vit_l_14_336() -> "CLIPConfig":
        """AlphaCLIP's tower: ViT-L/14 at 336 px, OpenAI-CLIP text stack."""
        return CLIPConfig(embed_dim=768, image_size=336, patch_size=14, vision_width=1024,
                          vision_layers=24, vision_heads=16, text_width=768, text_heads=12,
                          text_layers=12)

    @staticmethod
    def tiny() -> "CLIPConfig":  # for tests
        return CLIPConfig(embed_dim=16, image_size=32, patch_size=8, vision_width=32,
                          vision_layers=2, vision_heads=2, vocab_size=64, context_length=12,
                          text_width=24, text_heads=2, text_layers=2)


class MultiheadAttention(nn.Module):
    """nn.MultiheadAttention's parameters (in_proj_weight, in_proj_bias,
    out_proj) with JAX's arithmetic: scores q k^T / sqrt(hd) (+ causal
    mask), softmax, weighted sum."""

    def __init__(self, width: int, heads: int, device=None):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width, device=device))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width, device=device))
        self.out_proj = nn.Linear(width, width, device=device)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        b, n, c = x.shape
        hd = c // self.heads
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = (t.reshape(b, n, self.heads, hd).transpose(1, 2) for t in qkv.chunk(3, -1))
        att = (q @ k.transpose(-2, -1)) / math.sqrt(hd)
        if causal:
            att = att.masked_fill(torch.ones(n, n, dtype=torch.bool, device=x.device).triu(1),
                                  float("-inf"))
        out = (torch.softmax(att, dim=-1) @ v).transpose(1, 2).reshape(b, n, c)
        return self.out_proj(out)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, device=None):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, device=device)
        self.attn = MultiheadAttention(width, heads, device=device)
        self.ln_2 = nn.LayerNorm(width, device=device)
        self.mlp = nn.Sequential()
        self.mlp.add_module("c_fc", nn.Linear(width, 4 * width, device=device))
        self.mlp.add_module("gelu", nn.GELU())
        self.mlp.add_module("c_proj", nn.Linear(4 * width, width, device=device))

    def forward(self, x, causal: bool = False):
        x = x + self.attn(self.ln_1(x), causal)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, device=None):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, device=device) for _ in range(layers))

    def forward(self, x, causal: bool = False):
        for blk in self.resblocks:
            x = blk(x, causal)
        return x


class VisionTower(nn.Module):
    """(B, 3, S, S) CLIP-normalised images → (B, embed_dim)."""

    def __init__(self, cfg: CLIPConfig, device=None):
        super().__init__()
        w, p = cfg.vision_width, cfg.patch_size
        n_patch = (cfg.image_size // p) ** 2
        self.conv1 = nn.Conv2d(3, w, p, stride=p, bias=False, device=device)
        self.class_embedding = nn.Parameter(torch.zeros(w, device=device))
        self.positional_embedding = nn.Parameter(torch.zeros(n_patch + 1, w, device=device))
        self.ln_pre = nn.LayerNorm(w, device=device)
        self.transformer = Transformer(w, cfg.vision_layers, cfg.vision_heads, device=device)
        self.ln_post = nn.LayerNorm(w, device=device)
        self.proj = nn.Parameter(torch.zeros(w, cfg.embed_dim, device=device))

    def _tokens(self, x: torch.Tensor) -> torch.Tensor:
        x = x.flatten(2).transpose(1, 2)  # (B, patches, width), row-major patches
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        return torch.cat([cls, x], 1) + self.positional_embedding

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = self.transformer(self.ln_pre(x))
        return self.ln_post(x[:, 0]) @ self.proj

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self._head(self._tokens(self.conv1(images)))


class VisionTowerAlpha(VisionTower):
    """AlphaCLIP's visual tower: a single-channel patch conv of the alpha
    mask is added to the RGB patch embedding, so the embedding can focus on
    a region."""

    def __init__(self, cfg: CLIPConfig, device=None):
        super().__init__(cfg, device=device)
        p = cfg.patch_size
        self.conv1_alpha = nn.Conv2d(1, cfg.vision_width, p, stride=p, bias=False, device=device)

    def forward(self, images: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
        """images (B, 3, S, S) CLIP-normalised; alpha (B, 1, S, S) in [0, 1]."""
        return self._head(self._tokens(self.conv1(images) + self.conv1_alpha(alpha)))


class TextTower(nn.Module):
    """(B, context) token ids → (B, embed_dim), pooled at the highest id
    (the end-of-text token) of each row."""

    def __init__(self, cfg: CLIPConfig, device=None):
        super().__init__()
        tw = cfg.text_width
        self.token_embedding = nn.Embedding(cfg.vocab_size, tw, device=device)
        self.positional_embedding = nn.Parameter(torch.zeros(cfg.context_length, tw, device=device))
        self.transformer = Transformer(tw, cfg.text_layers, cfg.text_heads, device=device)
        self.ln_final = nn.LayerNorm(tw, device=device)
        self.text_projection = nn.Parameter(torch.zeros(tw, cfg.embed_dim, device=device))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        tokens = tokens.long()
        x = self.token_embedding(tokens) + self.positional_embedding[: tokens.shape[1]]
        x = self.ln_final(self.transformer(x, causal=True))
        pooled = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(-1)]
        return pooled @ self.text_projection


class CLIP(TextTower):
    def __init__(self, cfg: CLIPConfig, device=None):
        super().__init__(cfg, device=device)
        self.cfg = cfg
        self.visual = VisionTower(cfg, device=device)
        self.logit_scale = nn.Parameter(torch.full((), math.log(1 / 0.07), device=device))

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        return self.visual(images)

    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        return TextTower.forward(self, tokens)

    def forward(self, images, tokens):
        return self.encode_image(images), self.encode_text(tokens)


def preprocess_images(images: torch.Tensor, size: int = 224) -> torch.Tensor:
    """(B, H, W, 3) uint8, or float in [0, 1] → (B, 3, size, size)
    CLIP-normalised; resized as jax.image.resize(..., "bilinear") resizes
    (antialiased where an axis shrinks)."""
    if images.dtype == torch.uint8:
        images = images.to(torch.float32) / 255.0
    x = resize_like_jax(images.permute(0, 3, 1, 2), (size, size))
    mean = torch.as_tensor(CLIP_IMAGE_MEAN, device=x.device)[:, None, None]
    std = torch.as_tensor(CLIP_IMAGE_STD, device=x.device)[:, None, None]
    return (x - mean) / std


def _as_state(state) -> dict:
    """A checkpoint's tensors (torch or numpy) with open_clip's names: the
    `state_dict` wrapper and DataParallel's `module.` prefix removed."""
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return {k.replace("module.", ""): torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v)
            else v for k, v in state.items()}


def load_openclip_state_dict(state, cfg: Optional[CLIPConfig] = None, device="cuda") -> CLIP:
    """An open_clip ViT state dict (torch tensors or numpy arrays, fp16 or
    f32) → a float32 CLIP on `device`, loaded strictly."""
    model = CLIP(cfg or CLIPConfig.vit_b_16(), device="meta")
    model = model.to_empty(device=resolve_device(device))
    model.load_state_dict(_as_state(state), strict=True)
    return model.eval()


def load_openclip_checkpoint(path: str, cfg: Optional[CLIPConfig] = None, device="cuda"):
    """Load an open_clip .pt/.bin checkpoint; returns (CLIP, cfg)."""
    cfg = cfg or CLIPConfig.vit_b_16()
    state = torch.load(path, map_location="cpu", weights_only=True)
    return load_openclip_state_dict(state, cfg, device), cfg


def load_alphaclip_state_dict(state, cfg: Optional[CLIPConfig] = None,
                              device="cuda") -> VisionTowerAlpha:
    """The `visual.*` keys of an alpha_clip checkpoint (open_clip's visual
    layout plus `visual.conv1_alpha.weight`) → a float32 VisionTowerAlpha,
    loaded strictly; text keys, where present, are not read."""
    state = _as_state(state)
    visual = {k[len("visual."):]: v for k, v in state.items() if k.startswith("visual.")}
    model = VisionTowerAlpha(cfg or CLIPConfig.vit_l_14_336(), device="meta")
    model = model.to_empty(device=resolve_device(device))
    model.load_state_dict(visual, strict=True)
    return model.eval()
