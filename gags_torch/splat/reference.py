"""Slow-but-exact rasterizer: the numerics oracle (port of
gags_tpu.splat.reference).

Composites every Gaussian over every pixel in global depth order with the
tile rasterizer's per-pixel semantics: alpha floor 1/255, alpha clamp
0.999, and a splat that would take the transmittance below 1e-4 ends the
pixel. O(N * H * W): tests and tiny scenes only.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

ALPHA_FLOOR = 1.0 / 255.0
ALPHA_CLAMP = 0.999
T_EPS = 1e-4


def rasterize_reference(
    means2d: torch.Tensor,
    conics: torch.Tensor,
    depths: torch.Tensor,
    radii: torch.Tensor,
    opacities: torch.Tensor,
    colors: torch.Tensor,
    width: int,
    height: int,
    background: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns img (H, W, C) and alpha (H, W)."""
    dev = means2d.device
    order = torch.argsort(depths, stable=True)
    px = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5)[None, :]
    py = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5)[:, None]
    T = torch.ones((height, width), dtype=torch.float32, device=dev)
    done = torch.zeros((height, width), dtype=torch.bool, device=dev)
    acc = torch.zeros((height, width, colors.shape[-1]), dtype=torch.float32, device=dev)
    for g in order.tolist():
        if int(radii[g]) <= 0:
            continue
        ca, cb, cc = conics[g, 0], conics[g, 1], conics[g, 2]
        dx = px - means2d[g, 0]
        dy = py - means2d[g, 1]
        sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
        alpha = torch.clamp_max(opacities[g] * torch.exp(-sigma), ALPHA_CLAMP)
        live = (sigma >= 0.0) & (alpha >= ALPHA_FLOOR)
        alpha = torch.where(live, alpha, torch.zeros_like(alpha))
        next_t = T * (1.0 - alpha)
        kill = (alpha > 0.0) & (next_t < T_EPS)
        use = (alpha > 0.0) & ~done & ~kill
        w = torch.where(use, alpha * T, torch.zeros_like(alpha))
        acc = acc + w[..., None] * colors[g][None, None, :]
        T = torch.where(use, next_t, T)
        done = done | kill
    alpha = 1.0 - T
    if background is not None:
        acc = acc + T[..., None] * background[None, None, :]
    return acc, alpha
