"""Plain reference of one /relevancy reply: render the scene's features
at the request's camera, decode them to CLIP space, the relevancy of
the label against the negatives (LERF's pairwise softmax, whose minimum
over negatives is sigmoid(10 (sim_pos - max sim_neg))), the evaluation's
thresholding chain (a 30x30 reflect-101 box filter averaged with the
map, normalised to [-1, 1], clipped, thresholded), the majority vote
over a 7x7 window with the evaluation's border clipping, and the turbo
colour map (Mikhailov's polynomial), quantised as an 8-bit PNG stores
it. Plain PyTorch and numpy, float32 with TF32 off.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import gad as ref_gad
from benchmark.reference import raster


def _reflect101(n: int, before: int, after: int, device) -> torch.Tensor:
    i = torch.arange(-before, n + after, device=device)
    period = 2 * (n - 1)
    j = torch.remainder(i, period)
    return torch.where(j >= n, period - j, j)


def box_filter_reflect101(img: torch.Tensor, k: int = 30) -> torch.Tensor:
    h, w = img.shape
    before, after = k // 2, k - 1 - k // 2
    x = img[_reflect101(h, before, after, img.device)][:, _reflect101(w, before, after, img.device)]
    x = x.double()
    ones = torch.ones((1, 1, k, k), dtype=x.dtype, device=x.device)
    return (torch.nn.functional.conv2d(x[None, None], ones)[0, 0] / (k * k)).to(img.dtype)


def heatmap_to_mask(rel: torch.Tensor, thresh: float, k: int = 30):
    vm = 0.5 * (box_filter_reflect101(rel, k) + rel)
    out = vm - torch.amin(vm)
    out = out / (torch.amax(out) + 1e-9)
    out = torch.clamp(out * 2.0 - 1.0, 0.0, 1.0)
    return out > thresh, vm


def majority_smooth(mask: torch.Tensor, scale: int = 3) -> torch.Tensor:
    """A pixel is on where more than half of its window is; the window's
    upper bounds are min(i + scale + 1, n - 1) (the last row and column
    fall out at the border, as the evaluation code clips them)."""
    h, w = mask.shape
    m = mask.to(torch.float64)
    ii = torch.zeros((h + 1, w + 1), dtype=torch.float64, device=mask.device)
    ii[1:, 1:] = torch.cumsum(torch.cumsum(m, 0), 1)
    yy, xx = torch.arange(h, device=mask.device), torch.arange(w, device=mask.device)
    y0 = torch.clamp_min(yy - scale, 0)
    y1 = torch.maximum(torch.clamp_max(yy + scale + 1, h - 1), y0)
    x0 = torch.clamp_min(xx - scale, 0)
    x1 = torch.maximum(torch.clamp_max(xx + scale + 1, w - 1), x0)
    ones = (ii[y1[:, None], x1[None, :]] - ii[y0[:, None], x1[None, :]]
            - ii[y1[:, None], x0[None, :]] + ii[y0[:, None], x0[None, :]])
    total = ((y1 - y0)[:, None] * (x1 - x0)[None, :]).to(torch.float64)
    return 2 * ones > total


def turbo(x: np.ndarray) -> np.ndarray:
    x = np.clip(np.asarray(x, np.float32), 0.0, 1.0)
    r = 0.13572138 + x * (4.61539260 + x * (-42.66032258 + x * (132.13108234 + x * (-152.94239396 + x * 59.28637943))))
    g = 0.09140261 + x * (2.19418839 + x * (4.84296658 + x * (-14.18503333 + x * (4.27729857 + x * 2.82956604))))
    b = 0.10667330 + x * (12.64194608 + x * (-60.58204836 + x * (110.36276771 + x * (-89.90310912 + x * 27.34824973))))
    return np.clip(np.stack([r, g, b], -1), 0.0, 1.0)


def to_png_pixels(img01: np.ndarray) -> np.ndarray:
    """The 8-bit values an 8-bit PNG of [0, 1] floats holds (truncated)."""
    return (np.clip(img01, 0, 1) * 255).astype(np.uint8)


@torch.no_grad()
def reply(geometry: dict, features: torch.Tensor, decoder: dict, viewmat, K, width: int,
          height: int, pos: torch.Tensor, neg: torch.Tensor, thresh: float,
          rows_per_block: int = 96) -> dict:
    """The reply's content: heat-map and mask pixels, relevancy_max,
    selected_px."""
    proj = raster.project(geometry["means"], geometry["quats"], geometry["scales"],
                          geometry["opacities"], viewmat, K, width, height)
    walk = raster.walk(proj, geometry["opacities"], raster.tile_lists(proj, width, height),
                       width, height)
    del proj
    fmap = raster.render_colors(walk, features, width, height)
    del walk
    decoded = torch.cat([ref_gad.feature_decoder(decoder, fmap[i:i + rows_per_block])
                         for i in range(0, height, rows_per_block)])
    sim_pos = decoded @ pos.T
    sim_neg = decoded @ neg.T
    rel = torch.sigmoid(10.0 * (sim_pos - torch.amax(sim_neg, dim=-1, keepdim=True)))[..., 0]
    mask, vm = heatmap_to_mask(rel, thresh)
    mask = majority_smooth(mask)
    heat = to_png_pixels(turbo(vm.cpu().numpy()))
    mask_np = mask.cpu().numpy()
    return dict(heat=heat, mask=to_png_pixels(mask_np.astype(np.float32)[..., None].repeat(3, -1)),
                relevancy_max=float(rel.max()), selected_px=int(mask_np.sum()))
