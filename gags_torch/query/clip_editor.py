"""CLIPEditor: CLIP text and image embeddings, the image ones averaged
over stochastic augmentations (port of gags_tpu.query.clip_editor).

`encode_image(..., stochastic=k)` scores k augmented views of an image:
a random horizontal flip, colour jitter 0.1 (brightness, contrast,
saturation), a random rotation up to 20 degrees (bilinear, zero-filled
corners), a 3-tap Gaussian blur with sigma ~ U[0.01, 2], and a resize to
the tower's input size with jax.image.resize's "cubic" (Keys' cubic,
a = -0.5, antialiased where it shrinks; `resize_cubic_like_jax`). Where
JAX takes a PRNG key, the draws here come from a torch.Generator
(`draw_augment`), or are passed in as `AugmentDraws`.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from gags_torch.models.clip import CLIP, CLIP_IMAGE_MEAN, CLIP_IMAGE_STD, CLIPConfig


class AugmentDraws(NamedTuple):
    """One view's random draws."""

    flip: bool
    brightness: float  # factor, U[1 - jitter, 1 + jitter]
    contrast: float
    saturation: float
    angle: float  # radians
    sigma: float  # blur


def draw_augment(generator: torch.Generator, jitter: float = 0.1,
                 max_rot_deg: float = 20.0) -> AugmentDraws:
    """One view's draws from `generator` (on the CPU)."""
    u = torch.rand(6, generator=generator, dtype=torch.float64).tolist()
    lo, hi = 1 - jitter, 1 + jitter
    return AugmentDraws(
        flip=u[0] < 0.5,
        brightness=lo + (hi - lo) * u[1],
        contrast=lo + (hi - lo) * u[2],
        saturation=lo + (hi - lo) * u[3],
        angle=(-max_rot_deg + 2 * max_rot_deg * u[4]) * (math.pi / 180.0),
        sigma=0.01 + (2.0 - 0.01) * u[5],
    )


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel, a = -0.5 (jax.image's "cubic")."""
    x = x.abs()
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    return torch.where(x >= 2.0, torch.zeros_like(x), torch.where(x >= 1.0, far, near))


def _cubic_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) float32 weights of jax.image.scale_and_translate with
    the cubic kernel, antialiased: half-pixel centres, the kernel widened
    by the scale where it shrinks, columns normalised, samples outside
    the input zeroed."""
    scale = n_out / n_in
    inv = 1.0 / scale
    kernel_scale = max(inv, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None]).abs()
    w = _keys_cubic(x / kernel_scale)
    total = w.sum(0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_cubic_like_jax(img: torch.Tensor, out_hw) -> torch.Tensor:
    """(..., H, W, C) float → (..., h, w, C), as jax.image.resize(...,
    "cubic") computes it (F.interpolate's bicubic uses a = -0.75 and no
    antialiasing, so it differs)."""
    h, w = img.shape[-3], img.shape[-2]
    if (h, w) == tuple(out_hw):
        return img
    wh = _cubic_weights(h, out_hw[0], img.device)
    ww = _cubic_weights(w, out_hw[1], img.device)
    return torch.einsum("...hwc,hH,wW->...HWc", img, wh, ww)


def _rotate_bilinear(img: torch.Tensor, angle: float) -> torch.Tensor:
    """Rotate (H, W, C) about its centre by `angle` radians, bilinear,
    zero-filled corners."""
    h, w = img.shape[0], img.shape[1]
    dev = img.device
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    a = torch.tensor(angle, dtype=torch.float32)
    ca, sa = float(torch.cos(a)), float(torch.sin(a))
    sx = cx + (xx - cx) * ca - (yy - cy) * sa
    sy = cy + (xx - cx) * sa + (yy - cy) * ca
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0

    def at(yi, xi):
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        v = img[yi.clamp(0, h - 1).long(), xi.clamp(0, w - 1).long()]
        return torch.where(inside[..., None], v, torch.zeros_like(v))

    return (at(y0, x0) * ((1 - fx) * (1 - fy))[..., None]
            + at(y0, x0 + 1) * (fx * (1 - fy))[..., None]
            + at(y0 + 1, x0) * ((1 - fx) * fy)[..., None]
            + at(y0 + 1, x0 + 1) * (fx * fy)[..., None])


def _gaussian_blur3(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """3-tap separable Gaussian blur with reflect padding."""
    s = torch.tensor(max(sigma, 1e-6), dtype=torch.float32)
    x = torch.exp(-0.5 / s ** 2)
    k = torch.stack([x, torch.ones(()), x])
    k = (k / k.sum()).tolist()
    pad_h = F.pad(img.permute(2, 0, 1)[None], (0, 0, 1, 1), mode="reflect")[0].permute(1, 2, 0)
    img = pad_h[:-2] * k[0] + pad_h[1:-1] * k[1] + pad_h[2:] * k[2]
    pad_w = F.pad(img.permute(2, 0, 1)[None], (1, 1, 0, 0), mode="reflect")[0].permute(1, 2, 0)
    return pad_w[:, :-2] * k[0] + pad_w[:, 1:-1] * k[1] + pad_w[:, 2:] * k[2]


def augment_image(img: torch.Tensor, draws: AugmentDraws, out_size: int) -> torch.Tensor:
    """One augmented view of an (H, W, 3) float image in [0, 1]:
    flip, jitter, rotate, blur, resize to (out_size, out_size, 3), not
    normalised."""
    if draws.flip:
        img = img.flip(1)
    img = torch.clamp(img * draws.brightness, 0.0, 1.0)
    img = torch.clamp((img - img.mean()) * draws.contrast + img.mean(), 0.0, 1.0)
    grey = img.mean(dim=-1, keepdim=True)
    img = torch.clamp(grey + (img - grey) * draws.saturation, 0.0, 1.0)
    img = _rotate_bilinear(img, draws.angle)
    img = _gaussian_blur3(img, draws.sigma)
    return resize_cubic_like_jax(img, (out_size, out_size))


class CLIPEditor:
    """A CLIP model with normalised text embeddings and augmentation-
    averaged image embeddings (`encode_image(..., stochastic=k)` returns
    the k normalised per-view embeddings; callers average or score them)."""

    def __init__(self, model: CLIP, tokenizer=None):
        self.model = model
        self.cfg: CLIPConfig = model.cfg
        self.tokenizer = tokenizer

    @property
    def device(self) -> torch.device:
        return self.model.visual.proj.device

    @torch.no_grad()
    def encode_text(self, texts: Sequence[str]) -> torch.Tensor:
        if self.tokenizer is None:
            raise ValueError("CLIPEditor.encode_text needs a tokenizer")
        toks = torch.as_tensor(self.tokenizer(list(texts)), device=self.device)
        emb = self.model.encode_text(toks)
        return emb / torch.linalg.norm(emb, dim=-1, keepdim=True)

    @torch.no_grad()
    def encode_image(self, image: torch.Tensor, stochastic: int = 0,
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[Sequence[AugmentDraws]] = None) -> torch.Tensor:
        """(H, W, 3) float image in [0, 1] → (max(stochastic, 1), D)
        normalised embeddings; the views' draws are `draws`, else
        `stochastic` draws from `generator`."""
        size = self.cfg.image_size
        image = image.to(self.device)
        if stochastic:
            if draws is None:
                if generator is None:
                    raise ValueError("stochastic views need a torch.Generator or draws")
                draws = [draw_augment(generator) for _ in range(stochastic)]
            views = torch.stack([augment_image(image, d, size) for d in draws])
        else:
            views = resize_cubic_like_jax(image, (size, size))[None]
        mean = torch.as_tensor(CLIP_IMAGE_MEAN, device=self.device)
        std = torch.as_tensor(CLIP_IMAGE_STD, device=self.device)
        emb = self.model.encode_image(((views - mean) / std).permute(0, 3, 1, 2))
        return emb / torch.linalg.norm(emb, dim=-1, keepdim=True)
