"""Wrappers of the splat kernels (K5 blend_forward, K6 expand_gid), each
beside its plain PyTorch version.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the hand-written CUDA kernel (``csrc/*.cu``, built with nvcc at
first use and bound through ctypes) or raises. There is no fallback from
the kernel to the plain version. `launch_counts` counts kernel launches
only, so a caller can show that a run went through the kernels.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from gags_torch import _kernels

CSRC = Path(__file__).resolve().parent / "csrc"
EXPAND_GID_SRC = CSRC / "expand_gid.cu"
BLEND_FORWARD_SRC = CSRC / "blend_forward.cu"
SOURCES = (EXPAND_GID_SRC, BLEND_FORWARD_SRC)

ALPHA_FLOOR = 1.0 / 255.0
ALPHA_CLAMP = 0.999
T_EPS = 1e-4

launch_counts = {"expand_gid": 0, "blend_forward": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _check_tensor(name, t, dtype, device, ndim=None):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _dispatch(t: torch.Tensor) -> bool:
    """True for the CUDA kernel, False for the plain version (CPU only)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"gags_torch kernels: unsupported device {t.device}")


# --------------------------------------------------------------------------
# K6: expand_gid
# --------------------------------------------------------------------------


def expand_gid_plain(offsets: torch.Tensor, num_slots: int) -> torch.Tensor:
    """gid[i] = clip(upper_bound(offsets, i) - 1, 0, n - 1) for i < num_slots."""
    n = offsets.shape[0]
    idx = torch.arange(num_slots, dtype=offsets.dtype, device=offsets.device)
    gid = torch.searchsorted(offsets, idx, right=True) - 1
    return gid.clamp_(0, n - 1).to(torch.int32)


def expand_gid(offsets: torch.Tensor, num_slots: int) -> torch.Tensor:
    """Owning rank of each of `num_slots` instance slots, from the monotone
    exclusive per-rank offsets (n,) int32. Returns (num_slots,) int32."""
    if not _dispatch(offsets):
        return expand_gid_plain(offsets, num_slots)
    _check_tensor("offsets", offsets, torch.int32, offsets.device, ndim=1)
    n = offsets.shape[0]
    if n == 0:
        raise ValueError("expand_gid: empty offsets")
    gid = torch.empty((num_slots,), dtype=torch.int32, device=offsets.device)
    lib = _kernels.load(EXPAND_GID_SRC)
    fn = lib.gags_expand_gid
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(_ptr(offsets), n, _ptr(gid), num_slots, _stream(offsets))
    _kernels.check(lib, err, "expand_gid")
    launch_counts["expand_gid"] += 1
    return gid


# --------------------------------------------------------------------------
# K5: blend_forward
# --------------------------------------------------------------------------


def _pixel_centres(num_tiles, tiles_x, tile_h, tile_w, device):
    """(T, P) pixel-centre coordinates of every tile (row-major tiles)."""
    t = torch.arange(num_tiles, device=device)[:, None]
    p = torch.arange(tile_h * tile_w, device=device)[None, :]
    ty, tx = t // tiles_x, t % tiles_x
    row, col = p // tile_w, p % tile_w
    px = (tx * tile_w + col).to(torch.float32) + 0.5
    py = (ty * tile_h + row).to(torch.float32) + 0.5
    return px, py


def blend_forward_plain(geom, colors, inst_gid, tile_starts, tile_counts, bg,
                        tiles_x, tiles_y, tile_h, tile_w, return_pairs=False):
    """The composite of `blend_forward`, vectorised over all tiles and pixels
    and walking the instance index of every tile range in lock step.

    With return_pairs, also returns the (pixel, instance) pairs this data
    needs evaluated (each pixel up to the splat that ends it) and the
    pairs blended, as ints: the work a roofline bound of K5 counts."""
    num_tiles = tiles_x * tiles_y
    c = colors.shape[1]
    dev = geom.device
    px, py = _pixel_centres(num_tiles, tiles_x, tile_h, tile_w, dev)
    T = torch.ones_like(px)
    done = torch.zeros_like(px, dtype=torch.bool)
    acc = torch.zeros(px.shape + (c,), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    max_count = int(tile_counts.max()) if num_tiles else 0
    starts = tile_starts.long()
    counts = tile_counts.long()
    walked = torch.zeros((), dtype=torch.int64, device=dev)
    blended = torch.zeros((), dtype=torch.int64, device=dev)
    for k in range(max_count):
        inr = k < counts
        g = inst_gid[torch.where(inr, starts + k, 0)].long()
        rows = geom[g]  # (T, 8)
        op = torch.where(inr, rows[:, 5], zero)[:, None]
        dx = px - rows[:, 0:1]
        dy = py - rows[:, 1:2]
        sigma = 0.5 * (rows[:, 2:3] * dx * dx + rows[:, 4:5] * dy * dy) + rows[:, 3:4] * dx * dy
        alpha = torch.clamp_max(op * torch.exp(-sigma), ALPHA_CLAMP)
        live = (sigma >= 0.0) & (alpha >= ALPHA_FLOOR)
        alpha = torch.where(live, alpha, zero)
        next_t = T * (1.0 - alpha)
        kill = (alpha > 0.0) & (next_t < T_EPS)
        use = (alpha > 0.0) & ~done & ~kill
        w = torch.where(use, alpha * T, zero)
        if return_pairs:
            walked += (inr[:, None] & ~done).sum()
            blended += use.sum()
        acc += w[..., None] * colors[g][:, None, :]
        T = torch.where(use, next_t, T)
        done |= kill
    img = acc + T[..., None] * bg.reshape(1, 1, c)
    out = torch.cat([img, (1.0 - T)[..., None]], dim=-1)
    if return_pairs:
        return out, int(walked), int(blended)
    return out


def _compiled_channels(lib) -> list[int]:
    """The channel counts the library instantiates, ascending."""
    fn = lib.gags_blend_forward_channels
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    chans = []
    while (ch := fn(len(chans))) > 0:
        chans.append(ch)
    return chans


def blend_forward(geom, colors, inst_gid, tile_starts, tile_counts, bg,
                  tiles_x, tiles_y, tile_h, tile_w):
    """Front-to-back composite over unaligned per-tile ranges.

    geom (R, 8) f32 and colors (R, C) f32 are rank-permuted tables with a
    zero sentinel row, inst_gid (M,) i32 holds ranks, tile_starts and
    tile_counts (T,) i32, bg (C,) f32. Returns (T, P, C+1) f32: the C
    channels with bg blended against the final T, then alpha = 1 - T.
    """
    if not _dispatch(geom):
        return blend_forward_plain(geom, colors, inst_gid, tile_starts,
                                   tile_counts, bg, tiles_x, tiles_y, tile_h,
                                   tile_w)
    dev = geom.device
    num_tiles = tiles_x * tiles_y
    _check_tensor("geom", geom, torch.float32, dev, ndim=2)
    _check_tensor("colors", colors, torch.float32, dev, ndim=2)
    _check_tensor("inst_gid", inst_gid, torch.int32, dev, ndim=1)
    _check_tensor("tile_starts", tile_starts, torch.int32, dev, ndim=1)
    _check_tensor("tile_counts", tile_counts, torch.int32, dev, ndim=1)
    _check_tensor("bg", bg, torch.float32, dev, ndim=1)
    r, c = colors.shape
    if geom.shape != (r, 8):
        raise ValueError(f"geom: expected ({r}, 8), got {tuple(geom.shape)}")
    if bg.shape[0] != c:
        raise ValueError(f"bg: expected ({c},), got {tuple(bg.shape)}")
    if tile_starts.shape[0] != num_tiles or tile_counts.shape[0] != num_tiles:
        raise ValueError("tile_starts/tile_counts: one entry per tile")
    lib = _kernels.load(BLEND_FORWARD_SRC)
    chans = _compiled_channels(lib)
    cp = next((ch for ch in chans if ch >= c), None)
    if cp is None:
        raise ValueError(f"blend_forward: {c} channels exceed {chans[-1]}")
    if cp != c:  # zero channels up to a compiled count, sliced off below
        colors = torch.nn.functional.pad(colors, (0, cp - c)).contiguous()
        bg = torch.nn.functional.pad(bg, (0, cp - c)).contiguous()
    npix = tile_h * tile_w
    out = torch.empty((num_tiles, npix, cp + 1), dtype=torch.float32, device=dev)
    fn = lib.gags_blend_forward
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(_ptr(geom), _ptr(colors), _ptr(inst_gid), _ptr(tile_starts),
             _ptr(tile_counts), _ptr(bg), _ptr(out), num_tiles, tiles_x,
             tile_h, tile_w, cp, _stream(geom))
    _kernels.check(lib, err, "blend_forward")
    launch_counts["blend_forward"] += 1
    if cp != c:
        out = torch.cat([out[..., :c], out[..., cp:]], dim=-1)
    return out


def build_all() -> dict[str, str]:
    """Compile every splat kernel not built yet (all nvcc processes at
    once); returns each source's compiler log (ptxas' register report)."""
    return _kernels.build(list(SOURCES))
