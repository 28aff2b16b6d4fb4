"""Tile binning: port of gags_tpu.splat.tiles.

Projected Gaussians become a tile-major, front-to-back instance list:

  1. a tile rectangle per Gaussian, then a stable ALIVE-FIRST depth order
     (Gaussians that cover no tile sort last with depth key +inf);
  2. the ragged→dense expansion: kernel K6 (`kernels.expand_gid`) gives
     each instance slot its owning depth rank, from which the slot's tile
     and its key (tile << shift) | rank follow (`kernels.slot_keys`),
     shift = bits(N), so the rank comes back as a mask of the sorted key;
     with `fused_keys` (unaligned only), kernel K7 (`kernels.expand_keys`)
     does this step in one pass. An optional exact ellipse-tile cull
     (`ellipse_tile_keep`, unaligned only) drops instances whose tile has
     no pixel above the alpha floor;
  3. one sort of the int64 keys;
  4. per-tile ranges by searchsorted on the sorted keys.

`inst_gid` holds depth RANKS: rank r is the Gaussian `order[r]`; callers
permute per-Gaussian tables by `order` once. Keys are int64 throughout, so
the JAX package's int32, uint32 and two-key tiers are one path here with
the same order. Output lengths follow the JAX package (unaligned: `mk +
chunk` slots, mk = m_real rounded up to 1024; aligned: m_real + one chunk
of dummy room per tile), so the two compare element by element.

The aligned (training) layout pads every tile's range to a multiple of
`chunk` with zero-opacity dummies (rank n) that sort after the tile's
real instances, sizing the padding from per-tile counts taken BEFORE the
sort by a summed-area histogram of the rects' corners. It also carries
the `ReductionLayout` of the per-Gaussian gradient sum (kernel K3).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gags_torch.splat import kernels
from gags_torch.splat.kernels import (  # noqa: F401  (ellipse_tile_keep: the JAX module's name)
    EXPAND_K, INT64_MAX, ellipse_tile_keep)


class ReductionLayout(NamedTuple):
    """Rank-sorted, 128-rank-block-aligned instance layout of the
    per-Gaussian gradient sum (kernels.sorted_segment_sum)."""

    slot_to_pos: torch.Tensor  # (Mp,) int32 slot -> instance position; M = padding
    slot_rank: torch.Tensor  # (Mp,) int32 rank relative to the slot's block; -1 = padding
    chunk_block: torch.Tensor  # (Mp // 128,) int32 non-decreasing rank block per chunk


class BinnedInstances(NamedTuple):
    inst_gid: torch.Tensor  # (M,) int32 depth rank per slot; n = sentinel / dummy
    tile_starts: torch.Tensor  # (num_tiles,) int32 offset into the instance list
    tile_counts: torch.Tensor  # (num_tiles,) int32 REAL instances per tile
    num_valid: torch.Tensor  # () int32 instances kept
    overflow: torch.Tensor  # () int32 instances dropped by the budget
    order: torch.Tensor  # (N,) int32 depth order: order[rank] = Gaussian index
    red: Optional[ReductionLayout] = None  # aligned (training) binnings only


def spread_sorted(field: torch.Tensor, offsets: torch.Tensor, out_len: int) -> torch.Tensor:
    """Piecewise-constant fill: out[i] = field[j] where offsets[j] <= i <
    offsets[j+1] (offsets non-decreasing), by a telescoping diff-scatter
    and a cumsum (int64, exact)."""
    f = field.long()
    d = torch.diff(f, prepend=torch.zeros((1,), dtype=torch.int64, device=f.device))
    acc = torch.zeros((out_len + 1,), dtype=torch.int64, device=f.device)
    acc.index_add_(0, torch.clamp_max(offsets.long(), out_len), d)
    return torch.cumsum(acc[:out_len], 0)


def reduction_layout(inst_gid: torch.Tensor, n: int, chunk: int = 128) -> ReductionLayout:
    """The rank-sorted block-aligned layout of the gradient reduction.

    Instances are put in rank order (a STABLE sort, like jnp.argsort:
    ranks repeat across tiles and every dummy holds rank n, so only a
    stable order gives the JAX package's slot_to_pos element by element);
    each 128-rank block's run is padded to a multiple of `chunk`. The
    length Mp keeps the JAX package's worst case rounded to 8 chunks."""
    dev = inst_gid.device
    m = inst_gid.shape[0]
    nb = (n + 1 + chunk - 1) // chunk  # rank blocks, incl the sentinel rank n
    mp = ((m + chunk - 1) // chunk) * chunk + nb * chunk
    step = 8 * chunk
    mp = ((mp + step - 1) // step) * step
    perm = torch.argsort(inst_gid, stable=True)
    seg = inst_gid[perm].long()
    bounds = torch.arange(nb + 1, dtype=torch.int64, device=dev) * chunk
    starts = torch.searchsorted(seg, bounds)
    lens = starts[1:] - starts[:-1]
    plens = ((lens + chunk - 1) // chunk) * chunk
    pstarts = torch.cat([torch.zeros((1,), dtype=torch.int64, device=dev), torch.cumsum(plens, 0)])
    total = pstarts[nb]
    slot = torch.arange(mp, dtype=torch.int64, device=dev)
    s_of = spread_sorted(starts[:nb], pstarts[:nb], mp)
    p_of = spread_sorted(pstarts[:nb], pstarts[:nb], mp)
    e_of = spread_sorted(starts[1:], pstarts[:nb], mp)
    block = spread_sorted(torch.arange(nb, device=dev), pstarts[:nb], mp)
    pos_sorted = s_of + (slot - p_of)
    valid = (slot < total) & (pos_sorted < e_of)
    idx = torch.where(valid, pos_sorted, 0)
    slot_to_pos = torch.where(valid, perm[idx], m)
    slot_rank = torch.where(valid, seg[idx] - block * chunk, -1)
    return ReductionLayout(
        slot_to_pos=slot_to_pos.to(torch.int32),
        slot_rank=slot_rank.to(torch.int32),
        chunk_block=block[::chunk].to(torch.int32).contiguous(),
    )


def aligned_budget(budget: int, num_tiles: int, chunk: int) -> int:
    """Static aligned output size: budget (rounded to chunk) + per-tile pad room."""
    b = ((budget + chunk - 1) // chunk) * chunk
    return b + num_tiles * chunk


def tile_rects(means2d, radii, tile_w, tile_h, tiles_x, tiles_y, radii_y=None):
    """Inclusive-exclusive tile rectangle [x0, x1) x [y0, y1) per Gaussian.

    With `radii_y`, `radii` is the x half-extent (tight anisotropic box);
    otherwise the isotropic square. Returns x0, y0, w, h, w * h (int32)."""
    mx, my = means2d[:, 0], means2d[:, 1]
    rx = radii.to(torch.float32)
    ry = rx if radii_y is None else radii_y.to(torch.float32)

    x0 = torch.clamp(torch.floor((mx - rx) / tile_w), 0, tiles_x).to(torch.int32)
    x1 = torch.clamp(torch.ceil((mx + rx) / tile_w), 0, tiles_x).to(torch.int32)
    y0 = torch.clamp(torch.floor((my - ry) / tile_h), 0, tiles_y).to(torch.int32)
    y1 = torch.clamp(torch.ceil((my + ry) / tile_h), 0, tiles_y).to(torch.int32)
    alive = radii > 0 if radii_y is None else (radii > 0) & (radii_y > 0)
    zero = torch.zeros_like(x0)
    w = torch.where(alive, x1 - x0, zero)
    h = torch.where(alive, y1 - y0, zero)
    return x0, y0, w, h, w * h


def _finish_unaligned(sorted_keys, inst_rank, *, num_tiles, shift, chunk, n,
                      num_valid, overflow, order):
    """Per-tile ranges from the sorted keys (tile t spans
    [searchsorted(t << shift), searchsorted((t+1) << shift))) plus one
    sentinel chunk of tail padding."""
    dev = sorted_keys.device
    tbounds = torch.arange(num_tiles + 1, dtype=torch.int64, device=dev) << shift
    edges = torch.searchsorted(sorted_keys, tbounds).to(torch.int32)
    tile_starts = edges[:num_tiles].contiguous()
    tile_counts = (edges[1:] - edges[:num_tiles]).contiguous()
    inst_rank = torch.cat(
        [inst_rank, torch.full((chunk,), n, dtype=torch.int32, device=dev)]
    )
    return BinnedInstances(
        inst_gid=inst_rank,
        tile_starts=tile_starts,
        tile_counts=tile_counts,
        num_valid=num_valid,
        overflow=overflow,
        order=order.to(torch.int32),
    )


def depth_ranks(means2d, radii, depths, tile_w, tile_h, tiles_x, tiles_y, radii_y=None):
    """Alive-first depth order and the per-rank rect data of the expansion.

    Returns order (N,) int64 (order[rank] = Gaussian index), packed_p (N,)
    int32 rects x0 | y0 << 10 | max(w, 1) << 20 in rank order, and the
    exclusive / inclusive per-rank instance offsets (N,) int32."""
    x0, y0, w, h, counts = tile_rects(
        means2d, radii, tile_w, tile_h, tiles_x, tiles_y, radii_y=radii_y
    )
    # a STABLE sort, like jnp.argsort, so every Gaussian that covers no
    # tile (key +inf) keeps its index order
    inf = torch.full_like(depths, float("inf"))
    order = torch.argsort(torch.where(counts > 0, depths, inf), stable=True)
    packed = x0 | (y0 << 10) | (torch.clamp_min(w, 1) << 20)
    counts_p = counts[order]
    inc = torch.cumsum(counts_p, 0, dtype=torch.int32)
    return order, packed[order], (inc - counts_p).contiguous(), inc


def expansion_slots(budget: int, chunk: int) -> int:
    """Slots the expansion fills: the budget rounded up to `chunk`, then
    to EXPAND_K (the JAX package's layout)."""
    m_real = ((budget + chunk - 1) // chunk) * chunk
    return -(-m_real // EXPAND_K) * EXPAND_K


def _aligned_tile_counts(packed_p, counts_p, g_cut, tiles_x, tiles_y, chunk):
    """Per-tile instance counts BEFORE the sort, from a summed-area
    histogram of the kept rects' corners (+1 at (x0, y0) and (x1, y1), -1
    at (x1, y0) and (x0, y1), then a 2-D cumsum), and the chunk-padded
    tile starts."""
    dev = packed_p.device
    n = packed_p.shape[0]
    kept = (torch.arange(n, device=dev) < g_cut) & (counts_p > 0)
    gx0 = (packed_p & 1023).long()
    gy0 = ((packed_p >> 10) & 1023).long()
    pw = ((packed_p >> 20) & 1023).long()
    gx1 = gx0 + pw  # kept rects have w >= 1, so the packed width is exact
    gy1 = gy0 + torch.div(counts_p.long(), pw, rounding_mode="floor")
    gw = tiles_x + 1
    ncells = (tiles_y + 1) * gw
    oob = torch.full_like(gx0, ncells)  # non-kept corners land past the grid

    def hist(a, b):
        # a scatter-add, not torch.bincount: on a CUDA device bincount
        # reads the ids' maximum back to the host (a stream sync)
        ids = torch.cat([torch.where(kept, a, oob), torch.where(kept, b, oob)])
        counts = torch.zeros((ncells + 1,), dtype=torch.int64, device=dev)
        return counts.scatter_add_(0, ids, torch.ones_like(ids))[:ncells]

    grid = hist(gy0 * gw + gx0, gy1 * gw + gx1) - hist(gy0 * gw + gx1, gy1 * gw + gx0)
    grid = grid.reshape(tiles_y + 1, gw)
    counts_t = torch.cumsum(torch.cumsum(grid, 0), 1)[:tiles_y, :tiles_x].reshape(-1)
    padded = torch.where(counts_t > 0, (counts_t + chunk - 1) // chunk * chunk,
                         torch.zeros_like(counts_t))
    tile_starts = torch.cumsum(padded, 0) - padded
    return counts_t, padded, tile_starts


def bin_gaussians(means2d, radii, depths, width, height, tile_w, tile_h,
                  budget, chunk=128, radii_y=None, aligned=False, cull_rows=None,
                  fused_keys=False) -> BinnedInstances:
    """Tile-major, front-to-back instance list.

    means2d (N, 2), radii (N,) int32 (the x half-extent when radii_y is
    given), depths (N,). `budget` caps the instances kept; beyond it the
    deepest Gaussians are dropped whole and counted in `overflow`.

    aligned=False is the inference layout (ranges start anywhere, one
    sentinel chunk of tail padding). aligned=True is the training layout:
    each tile's range starts on a multiple of `chunk` and is padded with
    zero-opacity dummies (rank n) to a whole number of chunks; the list
    holds budget (rounded to chunk) + num_tiles * chunk slots and carries
    the gradient-reduction layout in `red`.

    Unaligned only (an aligned binning ignores both, as in JAX: its dummy
    counts must match the rects): `cull_rows`, (N, 6) f32 [mx, my,
    conic_a, conic_b, conic_c, L = ln(255 o_eff)], drops every instance
    whose tile fails `ellipse_tile_keep`; `num_valid` becomes the count
    kept, `overflow` stays the budget's. `fused_keys` builds the keys with
    K7 (`kernels.expand_keys`) instead of K6, an M-row gather and the key
    chain: the same keys.
    """
    dev = means2d.device
    n = means2d.shape[0]
    tiles_x = -(-width // tile_w)
    tiles_y = -(-height // tile_h)
    num_tiles = tiles_x * tiles_y
    m_real = ((budget + chunk - 1) // chunk) * chunk
    shift = max(1, int(n).bit_length())  # 2**shift > n, so rank n fits too
    if tiles_x > 1023 or tiles_y > 1023:
        raise ValueError("tile grid exceeds the 10-bit rect packing")

    order, packed_p, offsets, inc = depth_ranks(
        means2d, radii, depths, tile_w, tile_h, tiles_x, tiles_y, radii_y=radii_y
    )
    total = inc[n - 1]
    # budget cut in whole Gaussians: ranks whose full rect fits in m_real
    m_real_t = torch.full((1,), m_real, dtype=torch.int32, device=dev)  # no host copy
    g_cut = torch.searchsorted(inc, m_real_t, right=True)[0]
    # (index_select: indexing with a 0-d tensor reads it back to the host)
    last = torch.index_select(inc, 0, torch.clamp(g_cut - 1, 0, n - 1).reshape(1))[0]
    num_valid = torch.where(g_cut > 0, last, torch.zeros_like(total))
    overflow = total - num_valid

    # ragged→dense expansion and keys; the aligned layout expands exactly
    # m_real slots, like the JAX package
    mk = m_real if aligned else expansion_slots(budget, chunk)
    key_args = dict(shift=shift, tiles_x=tiles_x, tile_w=tile_w, tile_h=tile_h,
                    cull_p=None if aligned or cull_rows is None
                    else cull_rows.to(torch.float32)[order].contiguous())
    if fused_keys and not aligned:
        keys, counts = kernels.expand_keys(offsets, packed_p, num_valid, mk, **key_args)
        if key_args["cull_p"] is not None:
            num_valid = counts.sum(dtype=torch.int32)
    else:
        gid = kernels.expand_gid(offsets, mk)  # owning rank of every slot (K6)
        keys, valid = kernels.slot_keys(gid, offsets, packed_p, num_valid, **key_args)
        if key_args["cull_p"] is not None:
            num_valid = valid.sum(dtype=torch.int32)
    if aligned:
        counts_t, padded, tile_starts = _aligned_tile_counts(
            packed_p, inc - offsets, g_cut, tiles_x, tiles_y, chunk)
        # dummies (tile << shift) | n sort after the tile's real ranks
        d = torch.arange(num_tiles * chunk, dtype=torch.int64, device=dev)
        d_tile = torch.div(d, chunk, rounding_mode="floor")
        d_ok = (d - d_tile * chunk) < (padded - counts_t)[d_tile]
        keys = torch.cat([keys, torch.where(d_ok, (d_tile << shift) | n,
                                            torch.full_like(d, INT64_MAX))])
    # real keys are unique per (Gaussian, tile) pair; equal keys (dummies
    # of one tile, fillers) carry equal ranks, so their order is moot
    sorted_keys = torch.sort(keys).values
    inst_rank = torch.clamp_max(sorted_keys & ((1 << shift) - 1), n).to(torch.int32)
    if aligned:
        return BinnedInstances(
            inst_gid=inst_rank,
            tile_starts=tile_starts.to(torch.int32),
            tile_counts=counts_t.to(torch.int32),
            num_valid=num_valid.to(torch.int32),
            overflow=overflow.to(torch.int32),
            order=order.to(torch.int32),
            red=reduction_layout(inst_rank, n),
        )
    return _finish_unaligned(
        sorted_keys, inst_rank, num_tiles=num_tiles, shift=shift, chunk=chunk,
        n=n, num_valid=num_valid.to(torch.int32),
        overflow=overflow.to(torch.int32), order=order,
    )
