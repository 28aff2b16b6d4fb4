"""Image resize and smoothing primitives with PyTorch's interpolation
conventions (port of gags_tpu.utils.image), and a PNG encoder and
decoder.

nearest: src = floor(dst * in/out); bilinear with align_corners=True:
src = dst * (in-1)/(out-1). Written as explicit gathers, channel-LAST like
the JAX package: (H, W, C) or (H, W). PNGs are written and read with zlib
and struct from the standard library, JPEGs by `utils.jpeg`, and Pillow's
BILINEAR, BICUBIC and LANCZOS resamples computed here: no imaging package
is needed.
"""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np
import torch

from gags_torch import resolve_device


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def encode_png(img01: np.ndarray) -> bytes:
    """(H, W, 3) floats in [0, 1], or uint8 as it is, → 8-bit RGB PNG bytes."""
    a = img01 if img01.dtype == np.uint8 else (np.clip(img01, 0, 1) * 255).astype(np.uint8)
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


def _decodable_png(head: bytes) -> bool:
    """Whether a file's first 29 bytes open an 8-bit grey, RGB or RGBA PNG
    without interlace, the PNGs `read_png` decodes."""
    return (len(head) == 29 and head[:8] == _PNG_MAGIC and head[12:16] == b"IHDR"
            and head[24] == 8 and head[25] in _PNG_CHANNELS and not head[28])


def read_rgb(path: str, device="cuda") -> torch.Tensor:
    """An image file as (H, W, 3) uint8 on `device` at its own size, the
    pixels PIL's `Image.open(p).convert("RGB")` gives, without PIL: a JPEG
    through `utils.jpeg` (on a CUDA device its host entropy decoder and the
    J1 kernel, on the CPU the plain decoder), an 8-bit grey, RGB or RGBA
    PNG without interlace through `read_png` (grey replicated, alpha
    dropped). Any other file raises ValueError naming it. The default
    device is the card: without one it raises unless `device="cpu"`."""
    from gags_torch.utils.jpeg import decode_jpeg, is_jpeg

    device = resolve_device(device)
    with open(path, "rb") as f:
        data = f.read()
    if is_jpeg(data):
        return decode_jpeg(data, device, path)
    if _decodable_png(data[:29]):
        px = read_png(path)
        px = np.repeat(px[..., :1], 3, axis=-1) if px.shape[-1] <= 2 else px[..., :3]
        return torch.from_numpy(np.ascontiguousarray(px)).to(device)
    raise ValueError(f"{path}: neither a JPEG nor an 8-bit grey, RGB or RGBA PNG without "
                     f"interlace (the formats read without PIL)")


def load_rgb(path: str, width: int, height: int, device="cuda") -> torch.Tensor:
    """An image file as (height, width, 3) uint8 on `device`, the pixels the
    JAX package loads (`Image.open(p).convert("RGB").resize((w, h))`, whose
    default filter is BICUBIC; it then divides by 255 in float32, as the
    RGB trainer does on the device): `read_rgb`, then Pillow's BICUBIC
    resample (`resize_uint8`) on the device where the size differs."""
    img = read_rgb(path, device)
    if tuple(img.shape[:2]) != (height, width):
        img = resize_uint8(img, (height, width), "bicubic")
    return img


_PIL_PRECISION_BITS = 22  # Pillow's Resample.c: 32 - 8 - 2


def _triangle(x: float) -> float:
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


def _bicubic(x: float) -> float:
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    return _sinc(x) * _sinc(x / 3) if -3.0 <= x < 3.0 else 0.0


# Pillow's filters: support, and the function it evaluates at each tap
_PIL_FILTERS = {"bilinear": (1.0, _triangle), "bicubic": (2.0, _bicubic),
                "lanczos": (3.0, _lanczos)}


def _pil_taps(n_in: int, n_out: int, resample: str):
    """Pillow's precompute_coeffs + normalize_coeffs_8bpc: per output index
    the first input index and the integer weights of its taps, (n_out,)
    and (n_out, taps), in float64 in Pillow's order of operations, each
    tap's filter value from the C library's sin (math.sin) as Pillow's
    is; a negative weight rounds away from zero."""
    support, fn = _PIL_FILTERS[resample]
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    xmin = np.zeros(n_out, np.int64)
    kk = np.zeros((n_out, ksize), np.int32)
    for xx in range(n_out):
        center = (xx + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        n = min(int(center + support + 0.5), n_in) - lo
        w = [fn((x + lo - center + 0.5) * ss) for x in range(n)]
        total = 0.0
        for v in w:  # the C loop's order of addition
            total += v
        if total != 0.0:
            w = [v / total for v in w]
        xmin[xx] = lo
        kk[xx, :n] = [int((-0.5 if v < 0 else 0.5) + v * (1 << _PIL_PRECISION_BITS)) for v in w]
    return xmin, kk


def _pil_pass(x: torch.Tensor, axis: int, n_out: int, resample: str) -> torch.Tensor:
    """One 8-bit pass of Pillow's resample along `axis` of an int32 tensor:
    22-bit integer weights, the sum started at half a unit, shifted
    arithmetically (a negative sum floors) and clipped to 0..255. The
    positive weights of a row sum to under 1.3 * 2^22, so 255 times them
    fits in 31 bits; integer arithmetic is exact on any device."""
    n_in = x.shape[axis]
    xmin, kk = _pil_taps(n_in, n_out, resample)
    x = x.movedim(axis, 0)
    first = torch.as_tensor(xmin, device=x.device)
    kk = torch.as_tensor(kk, device=x.device)
    shape = (n_out,) + (1,) * (x.dim() - 1)
    acc = torch.full((n_out,) + tuple(x.shape[1:]), 1 << (_PIL_PRECISION_BITS - 1),
                     dtype=torch.int32, device=x.device)
    for t in range(kk.shape[1]):
        acc += x[(first + t).clamp_max(n_in - 1)] * kk[:, t].reshape(shape)
    return (acc >> _PIL_PRECISION_BITS).clamp_(0, 255).movedim(0, axis)


def resize_uint8(img, out_hw, resample: str):
    """(H, W, C) uint8 → out_hw uint8, as PIL's Image.resize(..., resample)
    computes it for "bilinear", "bicubic" (Pillow's default filter; a =
    -0.5) or "lanczos", without PIL: the filter widened by the scale where an axis
    shrinks, 22-bit integer weights, along the width first, then along the
    height, each pass rounded to 8 bits (Resample.c). A numpy array gives
    a numpy array; a tensor gives a tensor on its own device."""
    as_numpy = isinstance(img, np.ndarray)
    x = (torch.from_numpy(np.ascontiguousarray(img)) if as_numpy else img).to(torch.int32)
    h, w = x.shape[:2]
    h_out, w_out = out_hw
    if w_out != w:
        x = _pil_pass(x, 1, w_out, resample)
    if h_out != h:
        x = _pil_pass(x, 0, h_out, resample)
    x = x.to(torch.uint8)
    return x.numpy() if as_numpy else x


def resize_uint8_bilinear(img, out_hw):
    """`resize_uint8` with Pillow's BILINEAR filter."""
    return resize_uint8(img, out_hw, "bilinear")


def resize_like_jax(x: torch.Tensor, out_hw) -> torch.Tensor:
    """(..., H, W) float → (..., h, w) with jax.image.resize(..., "bilinear")
    semantics: half-pixel centres, and a triangle filter widened by the
    scale along every axis that shrinks (antialiasing), which is
    F.interpolate's bilinear, with antialias where some axis shrinks."""
    h, w = x.shape[-2:]
    if (h, w) == tuple(out_hw):
        return x
    lead = x.shape[:-2]
    y = torch.nn.functional.interpolate(
        x.reshape(-1, 1, h, w), size=tuple(out_hw), mode="bilinear", align_corners=False,
        antialias=out_hw[0] < h or out_hw[1] < w)
    return y.reshape(*lead, *out_hw)


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
