"""Image resize and smoothing primitives with PyTorch's interpolation
conventions (port of gags_tpu.utils.image), and a PNG encoder.

nearest: src = floor(dst * in/out); bilinear with align_corners=True:
src = dst * (in-1)/(out-1). Written as explicit gathers, channel-LAST like
the JAX package: (H, W, C) or (H, W). PNGs are written with zlib and
struct from the standard library (no imaging package).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def encode_png(img01: np.ndarray) -> bytes:
    """(H, W, 3) floats in [0, 1] → 8-bit RGB PNG bytes."""
    a = (np.clip(img01, 0, 1) * 255).astype(np.uint8)
    h, w = a.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    return (
        b"\x89PNG\r\n\x1a\n"
        + _png_chunk(b"IHDR", ihdr)
        + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
        + _png_chunk(b"IEND", b"")
    )


def resize_nearest(img: torch.Tensor, out_hw) -> torch.Tensor:
    """torch F.interpolate(mode='nearest') semantics, channel-last."""
    h_out, w_out = out_hw
    h_in, w_in = img.shape[0], img.shape[1]
    if (h_in, w_in) == (h_out, w_out):
        return img
    dev = img.device
    ri = torch.floor(torch.arange(h_out, device=dev, dtype=torch.float32) * (h_in / h_out)).long()
    ci = torch.floor(torch.arange(w_out, device=dev, dtype=torch.float32) * (w_in / w_out)).long()
    return img[ri.clamp(0, h_in - 1)][:, ci.clamp(0, w_in - 1)]


def resize_bilinear_align_corners(img: torch.Tensor, out_hw) -> torch.Tensor:
    """torch F.interpolate(mode='bilinear', align_corners=True) semantics,
    channel-last; corners map to corners."""
    h_out, w_out = out_hw
    h_in, w_in = img.shape[0], img.shape[1]
    if (h_in, w_in) == (h_out, w_out):
        return img
    dev = img.device

    def coords(n_out, n_in):
        if n_out == 1:
            return torch.zeros((1,), dtype=torch.float32, device=dev)
        return torch.arange(n_out, dtype=torch.float32, device=dev) * ((n_in - 1) / (n_out - 1))

    ys = coords(h_out, h_in)
    xs = coords(w_out, w_in)
    y0 = torch.floor(ys).long().clamp(0, h_in - 1)
    x0 = torch.floor(xs).long().clamp(0, w_in - 1)
    y1 = (y0 + 1).clamp(0, h_in - 1)
    x1 = (x0 + 1).clamp(0, w_in - 1)
    wy = (ys - y0.float())[:, None]
    wx = (xs - x0.float())[None, :]
    if img.dim() == 3:
        wy = wy[..., None]
        wx = wx[..., None]
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def mean_smooth(img: torch.Tensor, kernel_size: int = 5) -> torch.Tensor:
    """Channel-wise k x k box filter with zero padding, divisor k^2
    (F.conv2d of a ones/k^2 kernel with padding k//2). (H, W, C) or (H, W).
    Separable, through cumulative sums, as the JAX package computes it."""
    pad = kernel_size // 2
    squeeze = img.dim() == 2
    if squeeze:
        img = img[..., None]
    x = torch.nn.functional.pad(img, (0, 0, pad, pad, pad, pad))
    ix = torch.nn.functional.pad(torch.cumsum(x, dim=0), (0, 0, 0, 0, 1, 0))
    x = ix[kernel_size:] - ix[:-kernel_size]
    iy = torch.nn.functional.pad(torch.cumsum(x, dim=1), (0, 0, 1, 0))
    x = iy[:, kernel_size:] - iy[:, :-kernel_size]
    out = x / (kernel_size * kernel_size)
    return out[..., 0] if squeeze else out
