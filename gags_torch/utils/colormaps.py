"""Colormaps for visual outputs (numpy; a copy of gags_tpu.utils.colormaps):
turbo, float, depth and boolean maps, and the PCA feature visualisation."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def turbo(x: np.ndarray) -> np.ndarray:
    """Turbo colormap, x in [0,1] → (..., 3). Polynomial fit (Mikhailov)."""
    x = np.clip(np.asarray(x, np.float32), 0.0, 1.0)
    r = 0.13572138 + x * (4.61539260 + x * (-42.66032258 + x * (132.13108234 + x * (-152.94239396 + x * 59.28637943))))
    g = 0.09140261 + x * (2.19418839 + x * (4.84296658 + x * (-14.18503333 + x * (4.27729857 + x * 2.82956604))))
    b = 0.10667330 + x * (12.64194608 + x * (-60.58204836 + x * (110.36276771 + x * (-89.90310912 + x * 27.34824973))))
    return np.clip(np.stack([r, g, b], -1), 0.0, 1.0)


def apply_float_colormap(img: np.ndarray) -> np.ndarray:
    """(H, W, 1) in [0,1] → (H, W, 3) turbo (reference apply_float_colormap)."""
    return turbo(np.nan_to_num(img[..., 0]))


def apply_depth_colormap(
    depth: np.ndarray,
    near: Optional[float] = None,
    far: Optional[float] = None,
) -> np.ndarray:
    """(H, W) depth → (H, W, 3) turbo over [near, far] (default: its range)."""
    near = float(np.min(depth)) if near is None else near
    far = float(np.max(depth)) if far is None else far
    x = (depth - near) / max(far - near, 1e-10)
    return turbo(np.clip(x, 0, 1))


def apply_pca_colormap(
    feats: np.ndarray, proj: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """(H, W, C) features → (rgb (H, W, 3), proj (C, 3)).

    PCA to 3 components with median/MAD outlier rejection before the final
    min-max normalisation. Pass `proj` to reuse a projection across frames.
    """
    h, w, c = feats.shape
    flat = feats.reshape(-1, c).astype(np.float32)
    if proj is None:
        centered = flat - flat.mean(0, keepdims=True)
        cov = centered.T @ centered / max(len(flat) - 1, 1)
        _, vecs = np.linalg.eigh(cov)
        proj = vecs[:, -3:][:, ::-1].copy()
    y = flat @ proj
    med = np.median(y, axis=0)
    mad = np.median(np.abs(y - med), axis=0) + 1e-9
    ok = (np.abs(y - med) / mad < 5.0).all(axis=1)
    lo = y[ok].min(0) if ok.any() else y.min(0)
    hi = y[ok].max(0) if ok.any() else y.max(0)
    rgb = np.clip((y - lo) / np.maximum(hi - lo, 1e-9), 0, 1)
    return rgb.reshape(h, w, 3), proj


def apply_boolean_colormap(mask: np.ndarray) -> np.ndarray:
    """(H, W) mask → (H, W, 3): white where set, black elsewhere."""
    out = np.zeros((*mask.shape, 3), np.float32)
    out[mask.astype(bool)] = 1.0
    return out
