"""Small host-side resize helpers for GAS inputs (a copy of
gags_tpu.gas.data_utils)."""

from __future__ import annotations

import numpy as np


def resize_map(m: np.ndarray, out_hw, nearest: bool = False) -> np.ndarray:
    """(H, W) float map → out_hw; bilinear by default, nearest preserves
    the sparse-sample semantics of depth-sample maps (zeros stay zeros)."""
    h_out, w_out = out_hw
    h, w = m.shape
    if (h, w) == (h_out, w_out):
        return m
    if nearest:
        ri = np.clip(np.floor(np.arange(h_out) * h / h_out).astype(np.int64), 0, h - 1)
        ci = np.clip(np.floor(np.arange(w_out) * w / w_out).astype(np.int64), 0, w - 1)
        return m[ri[:, None], ci[None, :]]
    ys = (np.arange(h_out) + 0.5) * (h / h_out) - 0.5
    xs = (np.arange(w_out) + 0.5) * (w / w_out) - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None]
    wx = np.clip(xs - x0, 0, 1)[None, :]
    top = m[y0][:, x0] * (1 - wx) + m[y0][:, x1] * wx
    bot = m[y1][:, x0] * (1 - wx) + m[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy
