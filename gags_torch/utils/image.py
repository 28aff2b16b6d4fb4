"""Image resize and smoothing primitives with PyTorch's interpolation
conventions (port of gags_tpu.utils.image), and a PNG encoder and
decoder.

nearest: src = floor(dst * in/out); bilinear with align_corners=True:
src = dst * (in-1)/(out-1). Written as explicit gathers, channel-LAST like
the JAX package: (H, W, C) or (H, W). PNGs are written and read with zlib
and struct from the standard library (no imaging package is needed for a
PNG of the camera's size).
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


_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type → channels (8-bit)


def _unfilter(filt: np.ndarray, line: np.ndarray) -> np.ndarray:
    """Undo the five PNG filters of (H,) row types over (H, W, bpp) bytes.

    A pixel's predictor reads its left, upper and upper-left neighbours,
    so every pixel of one anti-diagonal y + x = d can be decoded at once
    from the diagonals before it: H + W - 1 numpy steps over at most
    min(H, W) pixels, whatever the mix of filters (a row-by-row walk would
    step once per byte on Average and Paeth rows)."""
    h, w, bpp = line.shape
    out = np.zeros((h + 1, w + 1, bpp), np.int32)  # a zero row above, a zero column left
    line = line.astype(np.int32)
    filt = filt.astype(np.int32)
    for d in range(h + w - 1):
        ys = np.arange(max(0, d - w + 1), min(h, d + 1))
        xs = d - ys
        a, b, c = out[ys + 1, xs], out[ys, xs + 1], out[ys, xs]  # left, up, upper left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        f = filt[ys][:, None]
        pred = np.select([f == 1, f == 2, f == 3, f == 4], [a, b, (a + b) >> 1, paeth], 0)
        out[ys + 1, xs + 1] = (line[ys, xs] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit, non-interlaced PNG (grey, grey+alpha, RGB or RGBA)
    with zlib and struct; returns (H, W, channels) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_MAGIC:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace}); 8-bit grey/RGB/RGBA without interlace only")
    bpp = _PNG_CHANNELS[ctype]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: image data holds {raw.size} bytes, expected {h * (stride + 1)}")
    rows = raw.reshape(h, stride + 1)
    bad = np.nonzero(rows[:, 0] > 4)[0]
    if bad.size:
        raise ValueError(f"{path}: row {bad[0]} has unknown filter type {rows[bad[0], 0]}")
    return _unfilter(rows[:, 0], rows[:, 1:].reshape(h, w, bpp))


def load_rgb(path: str, width: int, height: int) -> np.ndarray:
    """An image file as (height, width, 3) uint8, the pixels the JAX package
    loads (`Image.open(p).convert("RGB").resize((w, h))`; it then divides
    by 255 in float32, as the RGB trainer does on the device): a PNG
    of that size is decoded by `read_png` (grey replicated, alpha dropped,
    as PIL's convert("RGB") does; PIL's resize to the same size is the
    identity). Any other file or size goes through PIL when it can be
    imported; without PIL it raises ValueError naming the file and the two
    sizes. Nothing is resized by another method."""
    with open(path, "rb") as f:
        head = f.read(29)
    if head[:8] == _PNG_MAGIC and head[12:16] == b"IHDR" and len(head) == 29:
        size = struct.unpack(">II", head[16:24])
        depth, ctype, interlace = head[24], head[25], head[28]
        if (size == (width, height) and depth == 8 and ctype in _PNG_CHANNELS
                and not interlace):
            px = read_png(path)
            c = px.shape[-1]
            return np.repeat(px[..., :1], 3, axis=-1) if c <= 2 else px[..., :3]
    else:
        size = None
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(
            f"{path}: image size {size or 'unknown (not a PNG)'}, camera size "
            f"{(width, height)}: without PIL (not installed) only an 8-bit grey, RGB or "
            f"RGBA PNG of the camera's size is read") from None
    return np.asarray(Image.open(path).convert("RGB").resize((width, height)), np.uint8)


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
