"""Wrappers of the splat kernels, each beside its plain PyTorch version:

  K1 blend_forward_aligned  training composite over aligned tile ranges
  K2 blend_backward         colour VJP of the blend, per instance
  K3 sorted_segment_sum     per-instance rows summed per depth rank
  K4 dense_segment_sum      per-segment sums of pixel rows (region losses)
  K5 blend_forward          inference composite over unaligned ranges
                            (options: bf16 colour rows, bf16 weights,
                            per-tile early-exit counters)
  K6 expand_gid             owning rank of every instance slot
  K7 expand_keys            K6 fused with the per-slot rect, the exact
                            ellipse-tile cull and the sort key
  K8 blend_backward_full    full VJP of the blend: colour and screen-space
                            geometry gradients, per instance

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the hand-written CUDA kernel (``csrc/*.cu``, built with nvcc at
first use and bound through ctypes) or raises. There is no fallback from
the kernel to the plain version. `launch_counts` counts kernel launches
only, so a caller can show that a run went through the kernels.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import torch

from gags_torch import _kernels

CSRC = Path(__file__).resolve().parent / "csrc"
EXPAND_GID_SRC = CSRC / "expand_gid.cu"
EXPAND_KEYS_SRC = CSRC / "expand_keys.cu"
BLEND_FORWARD_SRC = CSRC / "blend_forward.cu"
BLEND_BACKWARD_SRC = CSRC / "blend_backward.cu"
BLEND_BACKWARD_FULL_SRC = CSRC / "blend_backward_full.cu"
SORTED_SEGMENT_SUM_SRC = CSRC / "sorted_segment_sum.cu"
DENSE_SEGMENT_SUM_SRC = CSRC / "dense_segment_sum.cu"
SOURCES = (EXPAND_GID_SRC, EXPAND_KEYS_SRC, BLEND_FORWARD_SRC, BLEND_BACKWARD_SRC,
           BLEND_BACKWARD_FULL_SRC, SORTED_SEGMENT_SUM_SRC, DENSE_SEGMENT_SUM_SRC)

ALPHA_FLOOR = 1.0 / 255.0
ALPHA_CLAMP = 0.999
T_EPS = 1e-4
EXPAND_K = 1024  # slots per K7 block and per valid count
INT64_MAX = torch.iinfo(torch.int64).max
SEG_CHUNKS = 8  # chunks per TPU streaming segment (exit-stats lanes 0 and 1)

launch_counts = {
    "blend_forward_aligned": 0,
    "blend_backward": 0,
    "blend_backward_full": 0,
    "sorted_segment_sum": 0,
    "dense_segment_sum": 0,
    "blend_forward": 0,
    "expand_gid": 0,
    "expand_keys": 0,
}


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
# K7: expand_keys
# --------------------------------------------------------------------------


def ellipse_tile_keep(tile_x, tile_y, tile_w: int, tile_h: int, cull, half_px: float = 0.5):
    """Exact alpha-floor tile test (the JAX package's tiles.ellipse_tile_keep,
    operation for operation): keep a (Gaussian, tile) instance iff some
    pixel centre of the tile has sigma <= L = ln(255 o_eff), i.e. blend
    alpha >= 1/255. The pixel centres of tile (tx, ty) span [tx tw + 0.5,
    tx tw + tw - 0.5] x [...]; the continuous minimum over that rectangle
    lower-bounds the discrete one, so dropping on `min > L` never drops a
    contributing pixel. The minimum of the quadratic form is 0 with the
    mean inside, else it lies on an edge, where the 1-D minimiser has a
    closed form. cull: (M, 6) rows [mx, my, conic_a, conic_b, conic_c, L].
    The clip and the minima propagate NaN (torch.maximum / torch.minimum),
    as jnp.clip and jnp.minimum do; K7 mirrors that."""
    mx, my = cull[:, 0], cull[:, 1]
    a, b, c, lvl = cull[:, 2], cull[:, 3], cull[:, 4], cull[:, 5]
    u0 = tile_x.to(torch.float32) * tile_w + half_px - mx
    u1 = u0 + (tile_w - 2 * half_px)
    v0 = tile_y.to(torch.float32) * tile_h + half_px - my
    v1 = v0 + (tile_h - 2 * half_px)
    inside = (u0 <= 0) & (0 <= u1) & (v0 <= 0) & (0 <= v1)

    def clip(x, lo, hi):  # jnp.clip
        return torch.minimum(hi, torch.maximum(lo, x))

    def edge_u(ub):  # u fixed at a vertical edge, minimise over v
        vs = clip(-b * ub / c, v0, v1)
        return (0.5 * a * ub + b * vs) * ub + 0.5 * c * vs * vs

    def edge_v(vb):  # v fixed at a horizontal edge, minimise over u
        us = clip(-b * vb / a, u0, u1)
        return (0.5 * c * vb + b * us) * vb + 0.5 * a * us * us

    smin = torch.minimum(torch.minimum(edge_u(u0), edge_u(u1)),
                         torch.minimum(edge_v(v0), edge_v(v1)))
    return inside | (smin <= lvl)


def slot_keys(gid, offsets, packed_p, num_valid, *, shift, tiles_x, tile_w, tile_h,
              cull_p=None):
    """Sort key of every instance slot from its owning rank `gid` (K6's
    output): the slot's tile from the rank's packed rect (x0 | y0 << 10 |
    pw << 20) and its offset, key (tile << shift) | rank where the slot is
    below `num_valid` (a 0-d tensor) and, with `cull_p` ((n, 6) cull rows
    in rank order), the tile passes `ellipse_tile_keep`; INT64_MAX
    elsewhere. Returns (keys (M,) int64, valid (M,) bool)."""
    g = gid.long()
    idx = torch.arange(g.shape[0], dtype=torch.int64, device=g.device)
    pk = packed_p[g].long()
    slot = idx - offsets[g].long()
    pw = (pk >> 20) & 1023
    dy = torch.div(slot, pw, rounding_mode="floor")
    tx = (pk & 1023) + slot - dy * pw
    ty = ((pk >> 10) & 1023) + dy
    valid = idx < num_valid
    if cull_p is not None:
        valid = valid & ellipse_tile_keep(tx, ty, tile_w, tile_h, cull_p[g])
    keys = torch.where(valid, ((ty * tiles_x + tx) << shift) | g,
                       torch.full_like(g, INT64_MAX))
    return keys, valid


def expand_keys_plain(offsets, packed_p, num_valid, num_slots, *, shift, tiles_x, tile_w,
                      tile_h, cull_p=None):
    """The keys and per-chunk valid counts of `expand_keys`: K6's plain
    version, then `slot_keys`."""
    gid = expand_gid_plain(offsets, num_slots)
    keys, valid = slot_keys(gid, offsets, packed_p, num_valid, shift=shift, tiles_x=tiles_x,
                            tile_w=tile_w, tile_h=tile_h, cull_p=cull_p)
    counts = valid.reshape(-1, EXPAND_K).sum(1, dtype=torch.int32)
    return keys, counts


def expand_keys(offsets, packed_p, num_valid, num_slots, *, shift, tiles_x, tile_w, tile_h,
                cull_p=None):
    """K7: the sort key of each of `num_slots` (a multiple of 1024) instance
    slots in one pass: the owning rank (K6's search), the slot's tile, the
    optional exact ellipse-tile cull, the key (tile << shift) | rank or
    INT64_MAX. offsets and packed_p (n,) int32 and cull_p (n, 6) f32 in
    depth-rank order, num_valid a 0-d int32 tensor (read on the device:
    no host sync). Returns (keys (num_slots,) int64, valid counts
    (num_slots / 1024,) int32)."""
    if num_slots % EXPAND_K:
        raise ValueError(f"expand_keys: {num_slots} slots, not a multiple of {EXPAND_K}")
    if not _dispatch(offsets):
        return expand_keys_plain(offsets, packed_p, num_valid, num_slots, shift=shift,
                                 tiles_x=tiles_x, tile_w=tile_w, tile_h=tile_h, cull_p=cull_p)
    dev = offsets.device
    _check_tensor("offsets", offsets, torch.int32, dev, ndim=1)
    _check_tensor("packed_p", packed_p, torch.int32, dev, ndim=1)
    n = offsets.shape[0]
    if n == 0 or packed_p.shape[0] != n:
        raise ValueError(f"expand_keys: offsets ({n},) and packed_p {tuple(packed_p.shape)}")
    num_valid = num_valid.reshape(1).to(torch.int32)
    _check_tensor("num_valid", num_valid, torch.int32, dev, ndim=1)
    if cull_p is not None:
        _check_tensor("cull_p", cull_p, torch.float32, dev, ndim=2)
        if cull_p.shape != (n, 6):
            raise ValueError(f"cull_p: expected ({n}, 6), got {tuple(cull_p.shape)}")
    keys = torch.empty((num_slots,), dtype=torch.int64, device=dev)
    counts = torch.empty((num_slots // EXPAND_K,), dtype=torch.int32, device=dev)
    lib = _kernels.load(EXPAND_KEYS_SRC)
    fn = lib.gags_expand_keys
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(_ptr(offsets), _ptr(packed_p), None if cull_p is None else _ptr(cull_p),
             _ptr(num_valid), n, _ptr(keys), _ptr(counts), num_slots, shift, tiles_x,
             tile_w, tile_h, _stream(offsets))
    _kernels.check(lib, err, "expand_keys")
    launch_counts["expand_keys"] += 1
    return keys, counts


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


class _WalkStep(NamedTuple):
    """One instance index k of every tile's range (see `_walk_ranges`)."""

    inr: torch.Tensor  # (T,) tiles whose range holds k
    pos: torch.Tensor  # (T,) slot positions (0 outside the range)
    rows: torch.Tensor  # (T, 8) geometry rows of the slots
    dx: torch.Tensor  # (T, P) pixel centre minus the splat's mean
    dy: torch.Tensor
    vis: torch.Tensor  # (T, P) exp(-sigma)
    alpha: torch.Tensor  # (T, P) clamped alpha, 0 where the splat does not count
    t_before: torch.Tensor  # (T, P) transmittance in front of the splat
    use: torch.Tensor  # (T, P) bool, the splat blends
    w: torch.Tensor  # (T, P) blend weight alpha T where it blends, else 0
    T: torch.Tensor  # (T, P) transmittance after it


def _walk_ranges(geom, inst_gid, tile_starts, tile_counts, tiles_x, tiles_y,
                 tile_h, tile_w, pairs=None):
    """The front-to-back walk of the plain blends, vectorised over all
    tiles and pixels, taking the instance index k of every range in lock
    step. Yields a `_WalkStep` per k.

    `pairs`, a list [walked, blended], accumulates the (pixel, instance)
    pairs this data needs evaluated (each pixel up to the splat that ends
    it) and the pairs blended: the work a roofline bound counts."""
    num_tiles = tiles_x * tiles_y
    dev = geom.device
    px, py = _pixel_centres(num_tiles, tiles_x, tile_h, tile_w, dev)
    T = torch.ones_like(px)
    done = torch.zeros_like(px, dtype=torch.bool)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    max_count = int(tile_counts.max()) if num_tiles else 0
    starts = tile_starts.long()
    counts = tile_counts.long()
    for k in range(max_count):
        inr = k < counts
        pos = torch.where(inr, starts + k, 0)
        rows = geom[inst_gid[pos].long()]  # (T, 8)
        op = torch.where(inr, rows[:, 5], zero)[:, None]
        dx = px - rows[:, 0:1]
        dy = py - rows[:, 1:2]
        sigma = 0.5 * (rows[:, 2:3] * dx * dx + rows[:, 4:5] * dy * dy) + rows[:, 3:4] * dx * dy
        vis = torch.exp(-sigma)
        alpha = torch.clamp_max(op * vis, ALPHA_CLAMP)
        live = (sigma >= 0.0) & (alpha >= ALPHA_FLOOR)
        alpha = torch.where(live, alpha, zero)
        next_t = T * (1.0 - alpha)
        kill = (alpha > 0.0) & (next_t < T_EPS)
        use = (alpha > 0.0) & ~done & ~kill
        w = torch.where(use, alpha * T, zero)
        if pairs is not None:  # device sums: no host sync inside the walk
            pairs[0] = pairs[0] + (inr[:, None] & ~done).sum()
            pairs[1] = pairs[1] + use.sum()
        t_before = T
        T = torch.where(use, next_t, T)
        done |= kill
        yield _WalkStep(inr, pos, rows, dx, dy, vis, alpha, t_before, use, w, T)


def _exit_stats_block(tile_starts, tile_counts, stop_chunk1, log2t, chunk):
    """The (T, 8, 128) f32 early-exit counters of the TPU kernel
    (`rasterize_exit_stats`'s public contract), row 0 of each tile:
    lane 0 segments done, 1 total segments, 2 chunks done, 3 total chunks,
    4 the largest log2 of a pixel's naive T where it stopped (its final T
    where it never did). Chunks hold `chunk` instances counted from the
    range's chunk-aligned base (start - start % chunk); a segment is
    SEG_CHUNKS chunks, the TPU kernel's DMA unit, kept only for this
    contract. `stop_chunk1` (T,): the chunk after the one holding the
    splat where the tile's last pixel stopped, or anything >= the total
    where some pixel never stopped (the TPU loop then runs to the end)."""
    lead = tile_starts.long() % chunk
    cnt = tile_counts.long()
    total = torch.where(cnt > 0, (lead + cnt + chunk - 1) // chunk, torch.zeros_like(cnt))
    done = torch.minimum(stop_chunk1.long(), total)
    segs = SEG_CHUNKS
    stats = torch.zeros((cnt.shape[0], 8, 128), dtype=torch.float32, device=cnt.device)
    lanes = [(done + segs - 1) // segs, (total + segs - 1) // segs, done, total]
    stats[:, 0, :5] = torch.stack([x.to(torch.float32) for x in lanes] + [log2t], 1)
    return stats


def blend_forward_plain(geom, colors, inst_gid, tile_starts, tile_counts, bg,
                        tiles_x, tiles_y, tile_h, tile_w, return_pairs=False, *,
                        fast_color_rows=False, blend_bf16=False, exit_stats=False,
                        block_exit=False, chunk=128):
    """The composite of `blend_forward` (and `blend_forward_aligned`), with
    K5's options: `fast_color_rows` rounds the colour table to bf16;
    `blend_bf16` rounds the colours and every blend weight to bf16 before
    the multiply-add (f32 products and sums); `exit_stats` also returns
    the (T, 8, 128) early-exit counters; `block_exit` changes nothing.
    Returns out, then stats with exit_stats, then the pairs walked and
    blended (ints, see `_walk_ranges`) with return_pairs."""
    del block_exit  # bit-identical by construction
    if fast_color_rows or blend_bf16:
        colors = colors.to(torch.bfloat16).to(torch.float32)
    c = colors.shape[1]
    npix = tile_h * tile_w
    dev = geom.device
    acc = torch.zeros((tiles_x * tiles_y, npix, c), dtype=torch.float32, device=dev)
    T = torch.ones(acc.shape[:2], dtype=torch.float32, device=dev)
    stop = torch.full(T.shape, -1, dtype=torch.int64, device=dev)  # range index
    t_stop = torch.ones_like(T)  # the naive T just after the stopping splat
    pairs = [0, 0]
    for k, s in enumerate(_walk_ranges(geom, inst_gid, tile_starts, tile_counts, tiles_x,
                                       tiles_y, tile_h, tile_w,
                                       pairs if return_pairs else None)):
        w = s.w.to(torch.bfloat16).to(torch.float32) if blend_bf16 else s.w
        acc += w[..., None] * colors[inst_gid[s.pos].long()][:, None, :]
        T = s.T
        if exit_stats:
            next_t = s.t_before * (1.0 - s.alpha)
            ends = (stop < 0) & (s.alpha > 0.0) & (next_t < T_EPS)
            stop = torch.where(ends, k, stop)
            t_stop = torch.where(ends, next_t, t_stop)
    img = acc + T[..., None] * bg.reshape(1, 1, c)
    ret = [torch.cat([img, (1.0 - T)[..., None]], dim=-1)]
    if exit_stats:
        lead = tile_starts.long()[:, None] % chunk
        chunk1 = torch.where(stop >= 0, (lead + stop) // chunk + 1, torch.iinfo(torch.int64).max)
        log2t = torch.log2(torch.where(stop >= 0, t_stop, T))
        ret.append(_exit_stats_block(tile_starts, tile_counts, chunk1.amax(1),
                                     log2t.amax(1), chunk))
    if return_pairs:
        ret += [int(pairs[0]), int(pairs[1])]
    return ret[0] if len(ret) == 1 else tuple(ret)


def _padded_channels(lib, query: str, c: int, what: str) -> int:
    """The smallest channel count >= c that the library instantiates
    (`query(i)` returns the i-th, ascending, then 0)."""
    fn = getattr(lib, query)
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    chans = []
    while (ch := fn(len(chans))) > 0:
        chans.append(ch)
    cp = next((ch for ch in chans if ch >= c), None)
    if cp is None:
        raise ValueError(f"{what}: {c} channels exceed {chans[-1]}")
    return cp


def _check_ranges(tile_starts, tile_counts, num_tiles, dev):
    _check_tensor("tile_starts", tile_starts, torch.int32, dev, ndim=1)
    _check_tensor("tile_counts", tile_counts, torch.int32, dev, ndim=1)
    if tile_starts.shape[0] != num_tiles or tile_counts.shape[0] != num_tiles:
        raise ValueError("tile_starts/tile_counts: one entry per tile")


def _launch_blend_forward(entry, key, geom, colors, inst_gid, tile_starts,
                          tile_counts, bg, tiles_x, tiles_y, tile_h, tile_w, *,
                          bf16_colors=False, bf16_weights=False, exit_stats=False, chunk=128):
    dev = geom.device
    num_tiles = tiles_x * tiles_y
    _check_tensor("geom", geom, torch.float32, dev, ndim=2)
    _check_tensor("colors", colors, torch.float32, dev, ndim=2)
    _check_tensor("inst_gid", inst_gid, torch.int32, dev, ndim=1)
    _check_tensor("bg", bg, torch.float32, dev, ndim=1)
    _check_ranges(tile_starts, tile_counts, num_tiles, dev)
    r, c = colors.shape
    if geom.shape != (r, 8):
        raise ValueError(f"geom: expected ({r}, 8), got {tuple(geom.shape)}")
    if bg.shape[0] != c:
        raise ValueError(f"bg: expected ({c},), got {tuple(bg.shape)}")
    lib = _kernels.load(BLEND_FORWARD_SRC)
    cp = _padded_channels(lib, "gags_blend_forward_channels", c, key)
    if cp != c:  # zero channels up to a compiled count, sliced off below
        colors = torch.nn.functional.pad(colors, (0, cp - c))
        bg = torch.nn.functional.pad(bg, (0, cp - c)).contiguous()
    if bf16_colors:  # round to nearest even, as astype(jnp.bfloat16)
        colors = colors.to(torch.bfloat16)
    colors = colors.contiguous()
    npix = tile_h * tile_w
    out = torch.empty((num_tiles, npix, cp + 1), dtype=torch.float32, device=dev)
    common = (_ptr(geom), _ptr(colors), _ptr(inst_gid), _ptr(tile_starts),
              _ptr(tile_counts), _ptr(bg), _ptr(out))
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    stats = None
    if entry == "gags_blend_forward":
        if exit_stats:  # (largest stopping chunk + 1, largest log2 T as an ordered int)
            stats = torch.empty((num_tiles, 2), dtype=torch.int32, device=dev)
            stats[:, 0] = 0
            stats[:, 1] = torch.iinfo(torch.int32).min
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        err = fn(*common, None if stats is None else _ptr(stats), num_tiles, tiles_x,
                 tile_h, tile_w, cp, int(bf16_colors), int(bf16_weights), chunk,
                 _stream(geom))
    else:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        err = fn(*common, num_tiles, tiles_x, tile_h, tile_w, cp, _stream(geom))
    _kernels.check(lib, err, key)
    launch_counts[key] += 1
    if cp != c:
        out = torch.cat([out[..., :c], out[..., cp:]], dim=-1)
    if stats is None:
        return out
    bits = stats[:, 1]
    log2t = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF).view(torch.float32)
    return out, _exit_stats_block(tile_starts, tile_counts, stats[:, 0], log2t, chunk)


def blend_forward(geom, colors, inst_gid, tile_starts, tile_counts, bg,
                  tiles_x, tiles_y, tile_h, tile_w, *, fast_color_rows=False,
                  blend_bf16=False, exit_stats=False, block_exit=False, chunk=128):
    """K5: front-to-back composite over unaligned per-tile ranges.

    geom (R, 8) f32 and colors (R, C) f32 are rank-permuted tables with a
    zero sentinel row, inst_gid (M,) i32 holds ranks, tile_starts and
    tile_counts (T,) i32, bg (C,) f32. Returns (T, P, C+1) f32: the C
    channels with bg blended against the final T, then alpha = 1 - T.

    Options (the JAX config's): `fast_color_rows` blends a bf16 copy of the
    colour table; `blend_bf16` also rounds every blend weight to bf16
    before the colour multiply-add; `exit_stats` returns (out, stats),
    stats the (T, 8, 128) f32 early-exit counters (see
    `_exit_stats_block`; chunks of `chunk` instances); `block_exit` is
    accepted and changes nothing (the kernel retires per pixel and block).
    """
    if not _dispatch(geom):
        return blend_forward_plain(geom, colors, inst_gid, tile_starts,
                                   tile_counts, bg, tiles_x, tiles_y, tile_h,
                                   tile_w, fast_color_rows=fast_color_rows,
                                   blend_bf16=blend_bf16, exit_stats=exit_stats,
                                   chunk=chunk)
    return _launch_blend_forward(
        "gags_blend_forward", "blend_forward", geom, colors, inst_gid,
        tile_starts, tile_counts, bg, tiles_x, tiles_y, tile_h, tile_w,
        bf16_colors=fast_color_rows or blend_bf16, bf16_weights=blend_bf16,
        exit_stats=exit_stats, chunk=chunk)


# --------------------------------------------------------------------------
# K1: blend_forward_aligned
# --------------------------------------------------------------------------


def blend_forward_aligned(geom, colors, inst_gid, tile_starts, tile_counts, bg,
                          tiles_x, tiles_y, tile_h, tile_w):
    """K1: the composite of `blend_forward` over an ALIGNED binning (the
    training layout: chunk-aligned starts, tile_counts = the real
    instances of each range, zero-opacity dummies after them). Same
    arguments and output; its plain version is `blend_forward_plain`."""
    if not _dispatch(geom):
        return blend_forward_plain(geom, colors, inst_gid, tile_starts,
                                   tile_counts, bg, tiles_x, tiles_y, tile_h,
                                   tile_w)
    return _launch_blend_forward(
        "gags_blend_forward_aligned", "blend_forward_aligned", geom, colors,
        inst_gid, tile_starts, tile_counts, bg, tiles_x, tiles_y, tile_h, tile_w)


# --------------------------------------------------------------------------
# K2: blend_backward
# --------------------------------------------------------------------------


def blend_backward_plain(geom, inst_gid, tile_starts, tile_counts, g,
                         tiles_x, tiles_y, tile_h, tile_w, return_pairs=False):
    """The colour VJP of `blend_backward`: grad[j] = sum_p w[p, j] g[p] for
    every instance slot j of a range, zero elsewhere. With return_pairs,
    also returns the pairs walked and blended (see `_walk_ranges`)."""
    grad = torch.zeros((inst_gid.shape[0], g.shape[-1]), dtype=torch.float32,
                       device=geom.device)
    pairs = [0, 0]
    for s in _walk_ranges(geom, inst_gid, tile_starts, tile_counts, tiles_x,
                          tiles_y, tile_h, tile_w, pairs if return_pairs else None):
        grad[s.pos[s.inr]] = torch.einsum("tp,tpc->tc", s.w, g)[s.inr]
    if return_pairs:
        return grad, int(pairs[0]), int(pairs[1])
    return grad


def blend_backward(geom, inst_gid, tile_starts, tile_counts, g,
                   tiles_x, tiles_y, tile_h, tile_w):
    """K2: colour gradient of every instance slot of an aligned binning.

    geom (R, 8) f32 is the rank-permuted geometry table with its zero
    sentinel row, inst_gid (M,) i32, tile_starts and tile_counts (T,) i32,
    g (T, P, C) f32 the cotangent of the tile image's C channels. Returns
    (M, C) f32: grad[j] = sum_p w[p, j] g[p], the blend weights recomputed
    as the forward computed them; rows outside every range are zero.
    """
    if not _dispatch(geom):
        return blend_backward_plain(geom, inst_gid, tile_starts, tile_counts, g,
                                    tiles_x, tiles_y, tile_h, tile_w)
    dev = geom.device
    num_tiles = tiles_x * tiles_y
    npix = tile_h * tile_w
    _check_tensor("geom", geom, torch.float32, dev, ndim=2)
    _check_tensor("inst_gid", inst_gid, torch.int32, dev, ndim=1)
    _check_tensor("g", g, torch.float32, dev, ndim=3)
    _check_ranges(tile_starts, tile_counts, num_tiles, dev)
    if geom.shape[1] != 8:
        raise ValueError(f"geom: expected (R, 8), got {tuple(geom.shape)}")
    c = g.shape[2]
    if g.shape[:2] != (num_tiles, npix):
        raise ValueError(f"g: expected ({num_tiles}, {npix}, C), got {tuple(g.shape)}")
    lib = _kernels.load(BLEND_BACKWARD_SRC)
    cp = _padded_channels(lib, "gags_blend_backward_channels", c, "blend_backward")
    if cp != c:
        g = torch.nn.functional.pad(g, (0, cp - c)).contiguous()
    grad = torch.zeros((inst_gid.shape[0], cp), dtype=torch.float32, device=dev)
    fn = lib.gags_blend_backward
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(_ptr(geom), _ptr(inst_gid), _ptr(tile_starts), _ptr(tile_counts),
             _ptr(g), _ptr(grad), num_tiles, tiles_x, tile_h, tile_w, cp,
             _stream(geom))
    _kernels.check(lib, err, "blend_backward")
    launch_counts["blend_backward"] += 1
    return grad[:, :c] if cp != c else grad


# --------------------------------------------------------------------------
# K8: blend_backward_full
# --------------------------------------------------------------------------


def blend_backward_full_plain(geom, colors, inst_gid, tile_starts, tile_counts, g_img,
                              g_alpha, tiles_x, tiles_y, tile_h, tile_w, return_pairs=False):
    """The full VJP of `blend_backward_full`, by two walks (the JAX
    package's scheme): walk A gives each pixel Total = sum u_i w_i over the
    splats it blends (u_i = g_img . colour_i) and T_fin, the transmittance
    after the last of them; walk B recomputes the walk and, with S_i =
    Total - (inclusive prefix of u w),

      dL/dalpha_i = u_i T_i - S_i / (1 - alpha_i) + g_alpha T_fin / (1 - alpha_i),

    dL/dsigma = -alpha dL/dalpha and dL/dopac = dL/dalpha exp(-sigma) where
    the splat blends unclamped (a splat clamped at 0.999 keeps only its
    colour gradient w g_img). With return_pairs, also returns the pairs one
    walk evaluates and blends (see `_walk_ranges`)."""
    m, c = inst_gid.shape[0], colors.shape[1]
    dev = geom.device
    ga = g_alpha.reshape(g_img.shape[:2])
    walk_args = (geom, inst_gid, tile_starts, tile_counts, tiles_x, tiles_y, tile_h, tile_w)

    def u_of(s):
        return torch.einsum("tpc,tc->tp", g_img, colors[inst_gid[s.pos].long()])

    total = torch.zeros(g_img.shape[:2], dtype=torch.float32, device=dev)
    t_fin = torch.ones_like(total)
    for s in _walk_ranges(*walk_args):
        total = total + u_of(s) * s.w
        t_fin = s.T
    grad_col = torch.zeros((m, c), dtype=torch.float32, device=dev)
    grad_geom = torch.zeros((m, 8), dtype=torch.float32, device=dev)
    prefix = torch.zeros_like(total)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    pairs = [0, 0]
    for s in _walk_ranges(*walk_args, pairs if return_pairs else None):
        u = u_of(s)
        prefix = prefix + u * s.w
        inv = 1.0 / (1.0 - s.alpha)
        dl_da = torch.where(s.use, u * s.t_before - (total - prefix) * inv + ga * t_fin * inv,
                            zero)
        active = s.use & (s.alpha < ALPHA_CLAMP)
        dl_ds = torch.where(active, -s.alpha * dl_da, zero)
        ca, cb, cc = s.rows[:, 2:3], s.rows[:, 3:4], s.rows[:, 4:5]
        dx, dy = s.dx, s.dy
        geo = torch.stack([
            torch.sum(dl_ds * -(ca * dx + cb * dy), dim=1),
            torch.sum(dl_ds * -(cc * dy + cb * dx), dim=1),
            torch.sum(dl_ds * (0.5 * dx * dx), dim=1),
            torch.sum(dl_ds * (dx * dy), dim=1),
            torch.sum(dl_ds * (0.5 * dy * dy), dim=1),
            torch.sum(torch.where(active, dl_da * s.vis, zero), dim=1),
        ], dim=1)
        grad_geom[s.pos[s.inr], :6] = geo[s.inr]
        grad_col[s.pos[s.inr]] = torch.einsum("tp,tpc->tc", s.w, g_img)[s.inr]
    if return_pairs:
        return grad_col, grad_geom, int(pairs[0]), int(pairs[1])
    return grad_col, grad_geom


def blend_backward_full(geom, colors, inst_gid, tile_starts, tile_counts, g_img, g_alpha,
                        tiles_x, tiles_y, tile_h, tile_w):
    """K8: colour and screen-space geometry gradients of every instance
    slot of an aligned binning (the RGB pretraining backward).

    geom (R, 8) and colors (R, C) f32 are the rank-permuted tables with a
    zero sentinel row, inst_gid (M,) i32, tile_starts and tile_counts (T,)
    i32, g_img (T, P, C) f32 the cotangent of the tile image's channels and
    g_alpha (T, P, 1) f32 that of its alpha, already net of the background
    term (g_alpha - g_img . bg: the forward blends bg against T_fin).
    Returns row-major (M, C) colour and (M, 8) geometry gradients, the
    latter [mx, my, ca, cb, cc, opac, 0, 0]; rows outside every range and
    behind a pixel's stop are zero. (The Pallas kernel's (C, M) and (8, M)
    lane-major outputs are a TPU layout; these rows feed K3 directly.)
    """
    if not _dispatch(geom):
        return blend_backward_full_plain(geom, colors, inst_gid, tile_starts, tile_counts,
                                         g_img, g_alpha, tiles_x, tiles_y, tile_h, tile_w)
    dev = geom.device
    num_tiles = tiles_x * tiles_y
    npix = tile_h * tile_w
    _check_tensor("geom", geom, torch.float32, dev, ndim=2)
    _check_tensor("colors", colors, torch.float32, dev, ndim=2)
    _check_tensor("inst_gid", inst_gid, torch.int32, dev, ndim=1)
    _check_tensor("g_img", g_img, torch.float32, dev, ndim=3)
    _check_tensor("g_alpha", g_alpha, torch.float32, dev, ndim=3)
    _check_ranges(tile_starts, tile_counts, num_tiles, dev)
    r, c = colors.shape
    if geom.shape != (r, 8):
        raise ValueError(f"geom: expected ({r}, 8), got {tuple(geom.shape)}")
    if g_img.shape != (num_tiles, npix, c):
        raise ValueError(f"g_img: expected ({num_tiles}, {npix}, {c}), got {tuple(g_img.shape)}")
    if g_alpha.shape != (num_tiles, npix, 1):
        raise ValueError(f"g_alpha: expected ({num_tiles}, {npix}, 1), got {tuple(g_alpha.shape)}")
    lib = _kernels.load(BLEND_BACKWARD_FULL_SRC)
    cp = _padded_channels(lib, "gags_blend_backward_full_channels", c, "blend_backward_full")
    if cp != c:  # zero channels add nothing to u = g_img . colour
        colors = torch.nn.functional.pad(colors, (0, cp - c)).contiguous()
        g_img = torch.nn.functional.pad(g_img, (0, cp - c)).contiguous()
    m = inst_gid.shape[0]
    grad_col = torch.zeros((m, cp), dtype=torch.float32, device=dev)
    grad_geom = torch.zeros((m, 8), dtype=torch.float32, device=dev)
    fn = lib.gags_blend_backward_full
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(_ptr(geom), _ptr(colors), _ptr(inst_gid), _ptr(tile_starts), _ptr(tile_counts),
             _ptr(g_img), _ptr(g_alpha), _ptr(grad_col), _ptr(grad_geom), num_tiles, tiles_x,
             tile_h, tile_w, cp, _stream(geom))
    _kernels.check(lib, err, "blend_backward_full")
    launch_counts["blend_backward_full"] += 1
    return (grad_col[:, :c].contiguous() if cp != c else grad_col), grad_geom


# --------------------------------------------------------------------------
# K3: sorted_segment_sum
# --------------------------------------------------------------------------


def sorted_segment_sum_plain(rows, slot_to_pos, slot_rank, chunk_block,
                             num_ranks, chunk=128):
    """out[b * chunk + r] = sum of rows[slot_to_pos[s]] over the slots s of
    chunks with chunk_block == b and slot_rank[s] == r (-1 = padding), for
    the ranks below num_ranks (the sentinel rank's block lies past them
    when num_ranks is a multiple of chunk)."""
    m, c = rows.shape
    ext = torch.cat([rows, torch.zeros((1, c), dtype=rows.dtype, device=rows.device)])
    got = ext[slot_to_pos.long().clamp(0, m)]
    block = chunk_block.long().repeat_interleave(chunk)
    rank = block * chunk + slot_rank.long()
    keep = (slot_rank >= 0) & (rank < num_ranks)
    out = torch.zeros((num_ranks, c), dtype=torch.float32, device=rows.device)
    out.index_add_(0, rank[keep], got[keep])
    return out


def sorted_segment_sum(rows, slot_to_pos, slot_rank, chunk_block, num_ranks,
                       chunk=128):
    """K3: per-rank sums of instance rows over a `tiles.ReductionLayout`.

    rows (M, C) f32, slot_to_pos and slot_rank (Mp,) i32, chunk_block
    (Mp // chunk,) i32 non-decreasing. Returns (num_ranks, C) f32.
    """
    if not _dispatch(rows):
        return sorted_segment_sum_plain(rows, slot_to_pos, slot_rank,
                                        chunk_block, num_ranks, chunk)
    dev = rows.device
    _check_tensor("rows", rows, torch.float32, dev, ndim=2)
    _check_tensor("slot_to_pos", slot_to_pos, torch.int32, dev, ndim=1)
    _check_tensor("slot_rank", slot_rank, torch.int32, dev, ndim=1)
    _check_tensor("chunk_block", chunk_block, torch.int32, dev, ndim=1)
    nc = chunk_block.shape[0]
    if slot_to_pos.shape[0] != nc * chunk or slot_rank.shape[0] != nc * chunk:
        raise ValueError("slot_to_pos/slot_rank: chunk slots per chunk_block entry")
    c = rows.shape[1]
    out = torch.empty((num_ranks, c), dtype=torch.float32, device=dev)
    lib = _kernels.load(SORTED_SEGMENT_SUM_SRC)
    fn = lib.gags_sorted_segment_sum
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(_ptr(rows), _ptr(slot_to_pos), _ptr(slot_rank), _ptr(chunk_block),
             _ptr(out), nc, chunk, c, num_ranks, _stream(rows))
    _kernels.check(lib, err, "sorted_segment_sum")
    launch_counts["sorted_segment_sum"] += 1
    return out


# --------------------------------------------------------------------------
# K4: dense_segment_sum
# --------------------------------------------------------------------------


def dense_segment_sum_plain(values, ids, num_segments):
    """out[s] = sum of values[p] over ids[p] == s; ids outside
    [0, num_segments) drop out."""
    keep = (ids >= 0) & (ids < num_segments)
    out = torch.zeros((num_segments, values.shape[1]), dtype=values.dtype,
                      device=values.device)
    out.index_add_(0, ids[keep].long(), values[keep])
    return out


def dense_segment_sum(values, ids, num_segments):
    """K4: per-segment sums of (P, C) f32 rows by (P,) i32 ids, for any
    segment count. Returns (num_segments, C) f32."""
    if not _dispatch(values):
        return dense_segment_sum_plain(values, ids, num_segments)
    dev = values.device
    _check_tensor("values", values, torch.float32, dev, ndim=2)
    _check_tensor("ids", ids, torch.int32, dev, ndim=1)
    p, c = values.shape
    if ids.shape[0] != p:
        raise ValueError(f"ids: expected ({p},), got {tuple(ids.shape)}")
    out = torch.zeros((num_segments, c), dtype=torch.float32, device=dev)
    lib = _kernels.load(DENSE_SEGMENT_SUM_SRC)
    fn = lib.gags_dense_segment_sum
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(_ptr(values), _ptr(ids), _ptr(out), p, c, num_segments, _stream(values))
    _kernels.check(lib, err, "dense_segment_sum")
    launch_counts["dense_segment_sum"] += 1
    return out


def build_all() -> dict[str, str]:
    """Compile every splat kernel not built yet (all nvcc processes at
    once); returns each source's compiler log (ptxas' register report)."""
    return _kernels.build(list(SOURCES))
