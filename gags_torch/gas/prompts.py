"""Depth-adaptive SAM point-prompt grids (GAGS core idea #1); a copy of
gags_tpu.gas.prompts, so the same numpy Generator gives the same grids.

Counterparts of `utils/SAM_utils.py:189-366`: per 8x8 image cell, the
prompt count is clamp(1, 20, floor(mean_render_depth / mean_min_hit_depth *
nsample)), and prompt locations are sampled proportionally to the local
density of projected depth samples within a 10x10 sub-grid of the cell.

Host-side preprocessing (numpy, explicit Generator for determinism) — runs
once per image before the SAM forward, not on the training hot path.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def build_point_grid(n_per_side: int) -> np.ndarray:
    """Uniform grid of n^2 points in [0,1]^2, half-cell inset."""
    off = 1.0 / (2 * n_per_side)
    side = np.linspace(off, 1 - off, n_per_side)
    xs = np.tile(side[None, :], (n_per_side, 1))
    ys = np.tile(side[:, None], (1, n_per_side))
    return np.stack([xs, ys], -1).reshape(-1, 2)


def build_all_layer_point_grids(
    n_per_side: int, n_layers: int, scale_per_layer: int
) -> List[np.ndarray]:
    return [
        build_point_grid(int(n_per_side / (scale_per_layer**i)))
        for i in range(n_layers + 1)
    ]


def _cell_grid(h: int, w: int, n_per_side: int):
    x0s = np.linspace(0, w - 1, n_per_side + 1)[:-1].astype(np.int32)
    y0s = np.linspace(0, h - 1, n_per_side + 1)[:-1].astype(np.int32)
    cw = int(w / len(x0s))
    ch = int(h / len(y0s))
    return x0s, y0s, cw, ch


def build_depth_point_grid(
    n_per_side: int, depth_map: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Per cell: k = clamp(1, 20, int(mean_depth)) uniform k^2 sub-grid."""
    h, w = depth_map.shape
    x0s, y0s, cw, ch = _cell_grid(h, w, n_per_side)
    pts, boxes = [], []
    for x0 in x0s:
        for y0 in y0s:
            md = float(np.mean(depth_map[y0 : min(y0 + ch, h), x0 : min(x0 + cw, w)]))
            k = int(np.clip(int(md), 1, 20))
            ox, oy = cw / (2 * k), ch / (2 * k)
            ax = np.linspace(x0 + ox, x0 + cw - ox, k)
            ay = np.linspace(y0 + oy, y0 + ch - oy, k)
            xs = np.tile(ax[None, :], (k, 1))
            ys = np.tile(ay[:, None], (1, k))
            pts.append(np.stack([xs, ys], -1).reshape(-1, 2))
            boxes.append(np.array([x0 / w, y0 / h, (x0 + cw) / w, (y0 + ch) / h]))
    points = np.concatenate(pts, 0) / np.array([[w, h]], np.float64)
    return points, np.stack(boxes, 0)


def sample_by_density(
    sample_crop: np.ndarray, n: int, rng: np.random.Generator, sub: int = 10
) -> np.ndarray:
    """Sample n (x, y) points inside a cell, weighted by the count of
    non-zero depth samples in each of sub x sub sub-crops; uniform fallback
    when the cell has no samples (SAM_utils.py:294-319)."""
    h, w = sample_crop.shape
    xs0 = np.linspace(0, w - 1, sub + 1)[:-1].astype(np.int32)
    ys0 = np.linspace(0, h - 1, sub + 1)[:-1].astype(np.int32)
    gx = np.tile(xs0[None, :], (sub, 1)).reshape(-1)
    gy = np.tile(ys0[:, None], (1, sub)).reshape(-1)
    counts = np.array(
        [
            np.count_nonzero(
                sample_crop[gy[i] : min(h - 1, gy[i] + h // sub), gx[i] : min(w - 1, gx[i] + w // sub)]
            )
            for i in range(sub * sub)
        ],
        np.float64,
    )
    if counts.sum() == 0:
        counts[:] = 1.0
    probs = counts / counts.sum()
    chosen = rng.choice(sub * sub, size=n, p=probs)
    out = np.empty((n, 2), np.int64)
    for i, c in enumerate(chosen):
        x1 = min(w - 1, gx[c] + w // sub)
        y1 = min(h - 1, gy[c] + h // sub)
        out[i, 0] = rng.integers(gx[c], x1 + 1)
        out[i, 1] = rng.integers(gy[c], y1 + 1)
    return out


def build_mindepth_point_grid(
    n_per_side: int,
    depth_map: np.ndarray,
    depth_sample: np.ndarray,
    nsample_min_distance: int = 4,
    rng: np.random.Generator | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """The GAGS prompt rule: density ∝ (rendered depth / min hit depth)."""
    rng = rng or np.random.default_rng(0)
    h, w = depth_map.shape
    x0s, y0s, cw, ch = _cell_grid(h, w, n_per_side)
    pts, boxes = [], []
    for x0 in x0s:
        for y0 in y0s:
            dcrop = depth_map[y0 : min(y0 + ch, h), x0 : min(x0 + cw, w)]
            scrop = depth_sample[y0 : min(y0 + ch, h), x0 : min(x0 + cw, w)]
            md = float(np.mean(dcrop))
            nz = scrop[scrop != 0]
            ms = float(np.mean(nz)) if nz.size else float("nan")
            ratio = md / ms if ms and ms == ms else float("nan")
            if not np.isfinite(ratio) or ratio < 1:
                k = 1
            else:
                k = int(ratio * nsample_min_distance)
            k = max(1, min(k, 20))
            cell_pts = sample_by_density(scrop, k * k, rng)
            cell_pts = cell_pts + np.array([[x0, y0]])
            pts.append(cell_pts)
            boxes.append(np.array([x0 / w, y0 / h, (x0 + cw) / w, (y0 + ch) / h]))
    points = np.concatenate(pts, 0).astype(np.float64) / np.array([[w, h]])
    return points, np.stack(boxes, 0)


def build_all_layer_mindepth_point_grids(
    n_per_side: int,
    n_layers: int,
    scale_per_layer: int,
    nsample_min_distance: int,
    depth_map: np.ndarray,
    depth_sample: np.ndarray,
    rng: np.random.Generator | None = None,
) -> List[np.ndarray]:
    out = []
    for i in range(n_layers + 1):
        n = int(n_per_side / (scale_per_layer**i))
        pts, _ = build_mindepth_point_grid(
            n, depth_map, depth_sample, nsample_min_distance, rng
        )
        out.append(pts)
    return out


def sample_from_pcd(
    pcd_depth: np.ndarray,          # (N,) per-point min hit depth
    pcd_pxl_mask: np.ndarray,       # (N, n_imgs) bool: point visible in img
    sample_num: int,
    rng: np.random.Generator | None = None,
) -> List[int]:
    """Depth-weighted sample of 3D point ids with at least one 2D hit.

    Counterpart of `SAM_utils.py:380-388`: points with a valid pixel
    mapping are sampled (with replacement) with probability proportional
    to their depth, then deduplicated — farther points get denser prompt
    coverage across the image set. Returns a sorted unique id list.
    """
    rng = rng or np.random.default_rng(0)
    point_ids = np.unique(np.nonzero(pcd_pxl_mask)[0])
    if point_ids.size == 0:
        return []
    depths = np.asarray(pcd_depth, np.float64)[point_ids]
    weights = depths / depths.sum()
    chosen = rng.choice(point_ids, size=sample_num, replace=True, p=weights)
    return sorted(set(int(i) for i in chosen))


def project_from_sampled_pcd(
    pcd_pxl_mask: np.ndarray,     # (S,) or (S, ...) bool: sampled-point hits
    pcd_pxl_mapping: np.ndarray,  # (S, ..., 2) int (row, col) pixel coords
    n_layers: int,
    h: int,
    w: int,
) -> List[np.ndarray]:
    """Normalised (x, y) prompt points from projected sampled 3D points.

    Counterpart of `SAM_utils.py:368-378`: the mapping stores (row, col);
    output is (x, y) = (col/w, row/h) per visible sampled point, repeated
    per crop layer like the reference (the mask/mapping are per-image, so
    every layer sees the same prompt set).
    """
    pts = pcd_pxl_mapping[pcd_pxl_mask.astype(bool)].astype(np.float32)
    pts = pts.reshape(-1, 2)
    # reference divides row by h and col by w, THEN swaps to (x, y)
    out = np.stack([pts[:, 1] / w, pts[:, 0] / h], axis=-1)
    return [out for _ in range(n_layers + 1)]
