"""Open-vocabulary relevancy math (port of gags_tpu.query.relevancy).

The reference's per-negative pairwise softmax is sigmoid(10 (sim_pos -
sim_neg)), monotone in sim_neg, so the minimum over negatives is
sigmoid(10 (sim_pos - max_neg)): one product and one sigmoid.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

DEFAULT_NEGATIVES = ("object", "things", "stuff", "texture")
TEMPERATURE = 10.0


def relevancy(embeds: torch.Tensor, pos_embeds: torch.Tensor,
              neg_embeds: torch.Tensor) -> torch.Tensor:
    """embeds (..., D), pos (P, D), neg (N, D) → (..., P) in [0, 1]."""
    sim_pos = embeds @ pos_embeds.T
    sim_neg = embeds @ neg_embeds.T
    worst_neg = torch.amax(sim_neg, dim=-1, keepdim=True)
    return torch.sigmoid(TEMPERATURE * (sim_pos - worst_neg))


def max_across_levels(sem_map: torch.Tensor, pos_embeds: torch.Tensor,
                      neg_embeds: torch.Tensor) -> torch.Tensor:
    """(L, H, W, D) → (L, P, H, W) relevancy volume."""
    return relevancy(sem_map, pos_embeds, neg_embeds).permute(0, 3, 1, 2)


def _reflect101_index(n: int, before: int, after: int, device) -> torch.Tensor:
    """Source indices of an OpenCV BORDER_REFLECT_101 pad (numpy "reflect")."""
    i = torch.arange(-before, n + after, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    j = torch.remainder(i, period)
    return torch.where(j >= n, period - j, j)


def box_filter_reflect101(img: torch.Tensor, k: int = 30) -> torch.Tensor:
    """k x k mean filter, BORDER_REFLECT_101, anchor (k//2, k//2): matches
    cv2.filter2D(img, -1, ones((k, k)) / k^2). (H, W) input."""
    h, w = img.shape
    before, after = k // 2, k - 1 - k // 2
    x = img[_reflect101_index(h, before, after, img.device)]
    x = x[:, _reflect101_index(w, before, after, img.device)]
    zero_row = torch.zeros((1, x.shape[1]), dtype=x.dtype, device=x.device)
    ix = torch.cat([zero_row, torch.cumsum(x, 0)])
    x = ix[k:] - ix[:-k]
    zero_col = torch.zeros((x.shape[0], 1), dtype=x.dtype, device=x.device)
    iy = torch.cat([zero_col, torch.cumsum(x, 1)], dim=1)
    x = iy[:, k:] - iy[:, :-k]
    return x / (k * k)


def heatmap_to_mask(rel: torch.Tensor, thresh: float, k: int = 30) -> Tuple[torch.Tensor, torch.Tensor]:
    """The eval thresholding chain: vm = (boxfilter(rel) + rel) / 2, min/max
    normalised to [-1, 1], clipped to [0, 1], thresholded. Returns (mask
    uint8 before the majority smoothing, vm)."""
    vm = 0.5 * (box_filter_reflect101(rel, k) + rel)
    out = vm - torch.amin(vm)
    out = out / (torch.amax(out) + 1e-9)
    out = torch.clamp(out * 2.0 - 1.0, 0.0, 1.0)
    return (out > thresh).to(torch.uint8), vm


def majority_smooth(mask: torch.Tensor, scale: int = 3) -> torch.Tensor:
    """Majority vote over a (2*scale+1)^2 window with the reference's window
    clipping (upper bounds min(i+scale+1, h-1), which excludes the last
    row and column at the border; kept for metric parity)."""
    h, w = mask.shape
    dev = mask.device
    m = mask.to(torch.float32)
    ii = torch.zeros((h + 1, w + 1), dtype=torch.float32, device=dev)
    ii[1:, 1:] = torch.cumsum(torch.cumsum(m, 0), 1)
    yy = torch.arange(h, device=dev)
    xx = torch.arange(w, device=dev)
    y0 = torch.clamp_min(yy - scale, 0)
    y1 = torch.maximum(torch.clamp_max(yy + scale + 1, h - 1), y0)
    x0 = torch.clamp_min(xx - scale, 0)
    x1 = torch.maximum(torch.clamp_max(xx + scale + 1, w - 1), x0)
    ones = (
        ii[y1[:, None], x1[None, :]]
        - ii[y0[:, None], x1[None, :]]
        - ii[y1[:, None], x0[None, :]]
        + ii[y0[:, None], x0[None, :]]
    )
    total = (y1 - y0)[:, None] * (x1 - x0)[None, :]
    return (2 * ones > total).to(torch.uint8)


def iou(mask_pred, mask_gt) -> float:
    """Intersection over union of two boolean masks (numpy or tensors);
    0 where both are empty."""
    mask_pred, mask_gt = np.asarray(mask_pred), np.asarray(mask_gt)
    inter = np.logical_and(mask_gt, mask_pred).sum()
    union = np.logical_or(mask_gt, mask_pred).sum()
    return float(inter) / float(union) if union else 0.0
