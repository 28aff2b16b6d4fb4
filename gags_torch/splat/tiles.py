"""Tile binning, unaligned (inference) path: port of gags_tpu.splat.tiles.

Projected Gaussians become a tile-major, front-to-back instance list:

  1. a tile rectangle per Gaussian, then a stable ALIVE-FIRST depth order
     (Gaussians that cover no tile sort last with depth key +inf);
  2. the ragged→dense expansion: kernel K6 (`kernels.expand_gid`) gives
     each instance slot its owning depth rank, from which the slot's tile
     follows;
  3. one sort of int64 keys (tile << shift) | rank, shift = bits(N), so the
     rank comes back as a mask of the sorted key;
  4. per-tile ranges by searchsorted on the sorted keys.

`inst_gid` holds depth RANKS: rank r is the Gaussian `order[r]`; callers
permute per-Gaussian tables by `order` once. Keys are int64 throughout, so
the JAX package's int32, uint32 and two-key tiers are one path here with
the same order. Output lengths follow the JAX package (`mk + chunk` slots,
mk = m_real rounded up to 1024), so the two compare element by element.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gags_torch.splat import kernels

EXPAND_K = 1024  # slot granularity of the expansion (the JAX package's)
INT64_MAX = torch.iinfo(torch.int64).max


class BinnedInstances(NamedTuple):
    inst_gid: torch.Tensor  # (mk + chunk,) int32 depth rank per slot; n = sentinel
    tile_starts: torch.Tensor  # (num_tiles,) int32 offset into the instance list
    tile_counts: torch.Tensor  # (num_tiles,) int32 instances per tile
    num_valid: torch.Tensor  # () int32 instances kept
    overflow: torch.Tensor  # () int32 instances dropped by the budget
    order: torch.Tensor  # (N,) int32 depth order: order[rank] = Gaussian index


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


def bin_gaussians(means2d, radii, depths, width, height, tile_w, tile_h,
                  budget, chunk=128, radii_y=None) -> BinnedInstances:
    """Unaligned tile-major, front-to-back instance list.

    means2d (N, 2), radii (N,) int32 (the x half-extent when radii_y is
    given), depths (N,). `budget` caps the instances kept; beyond it the
    deepest Gaussians are dropped whole and counted in `overflow`.
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
    m_real_t = torch.tensor([m_real], dtype=torch.int32, device=dev)
    g_cut = torch.searchsorted(inc, m_real_t, right=True)[0]
    num_valid = torch.where(
        g_cut > 0, inc[torch.clamp(g_cut - 1, 0, n - 1)], torch.zeros_like(total)
    )
    overflow = total - num_valid

    # ragged→dense expansion: owning rank of every slot (kernel K6)
    mk = expansion_slots(budget, chunk)
    gid = kernels.expand_gid(offsets, mk).long()
    idx = torch.arange(mk, dtype=torch.int64, device=dev)
    pk = packed_p[gid].long()
    slot = idx - offsets[gid].long()
    px0 = pk & 1023
    py0 = (pk >> 10) & 1023
    pw = (pk >> 20) & 1023
    dy = torch.div(slot, pw, rounding_mode="floor")
    dx = slot - dy * pw
    tile = (py0 + dy) * tiles_x + (px0 + dx)
    valid = idx < num_valid
    keys = torch.where(valid, (tile << shift) | gid,
                       torch.full_like(tile, INT64_MAX))
    # keys are unique per (Gaussian, tile) pair; filler keys are all equal
    sorted_keys = torch.sort(keys).values
    inst_rank = torch.clamp_max(sorted_keys & ((1 << shift) - 1), n).to(torch.int32)
    return _finish_unaligned(
        sorted_keys, inst_rank, num_tiles=num_tiles, shift=shift, chunk=chunk,
        n=n, num_valid=num_valid.to(torch.int32),
        overflow=overflow.to(torch.int32), order=order,
    )
