"""Rasterizer: project → bin → blend, differentiable with respect to the
colours and, with `geometry_grads`, the geometry (port of
gags_tpu.splat.rasterizer).

`rasterize` projects the Gaussians, bins them, permutes the geometry and
colour tables into depth-rank order and blends each tile's range. The
aligned (training) binning blends with kernel K1 and carries a gradient:
`_Blend`'s backward runs K2 (the per-instance colour VJP) and then K3
(the per-rank sum over the binning's ReductionLayout). With
`RasterizeConfig.geometry_grads` (RGB pretraining) `_BlendFull` takes its
place: the image AND the alpha are differentiable, its backward runs K8
(colour and screen-space geometry gradients per instance) and K3 twice,
and the projection's own backward (J2 on the card) carries the (N+1, 8)
geometry-table gradient to means, quats, scales and opacities. One
projection (`projection.project_table`) gives the binning its extents
and the blend its table; the binning is never differentiated.
The unaligned (inference) binning blends with K5 and refuses a backward,
as in JAX. `prepare_binning` + `rasterize_binned` split the colour-only
path for GAD training, where the geometry is frozen and each camera's
binning is computed once.

The inference options of the JAX config that carry semantics are here,
for unaligned binnings (an aligned one ignores them, as in JAX):
`tile_cull` (the exact ellipse-tile cull: fewer instances, so another
`num_valid`, the same image), `fused_keys` (K7 builds the binning's
keys: the same binning), `fast_color_rows` and `blend_bf16` (bf16
colour rows, bf16 blend weights: other numbers, within the error
contracts of tests/test_pallas_rasterizer.py) and `block_exit` (accepted:
K5 already retires per pixel and per block, the output is
bit-identical). `rasterize_exit_stats` returns K5's per-tile early-exit
counters. The switches that only choose a TPU layout (mxu_sigma,
p_block, soa_geom, image_chw) are absent.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from gags_torch import resolve_device
from gags_torch.splat import kernels, tiles
from gags_torch.splat.projection import (ProjectedGaussians, effective_opacity,
                                         project_gaussians, project_table, project_table_only)


@dataclasses.dataclass(frozen=True)
class RasterizeConfig:
    tile_h: int = 32
    tile_w: int = 32
    chunk: int = 128  # tail padding of the instance list (JAX layout parity)
    budget_factor: float = 4.0  # instance budget = factor * N
    budget: Optional[int] = None  # explicit override
    # full VJP to means / quats / scales / opacities (kernel K8, RGB
    # pretraining); colours only otherwise (GAD)
    geometry_grads: bool = False
    # chunk-aligned per-tile ranges with dummy padding: required for any
    # backward; inference passes aligned=False (K5, no SAT or dummies)
    aligned: bool = True
    # shrink binning rects to each splat's alpha-floor contour (image-exact)
    opacity_extents: bool = True
    # kept so that JAX configs load unchanged; no effect here: K1 and K5
    # share one kernel body (csrc/blend_forward.cu), so aligned binnings
    # always launch K1
    fast_fwd_aligned: bool = False
    # inference (aligned=False) options, defaults as in JAX:
    # K7 builds the keys of the binning (the same binning)
    fused_keys: bool = False
    # drop instances whose tile has no pixel above the alpha floor
    # (tiles.ellipse_tile_keep): image-exact, fewer instances
    tile_cull: bool = False
    # bf16 colour rows in K5 (~1e-3 relative colour error)
    fast_color_rows: bool = False
    # bf16 blend weights and colours in K5's multiply-add (~1e-2 relative)
    blend_bf16: bool = False
    # accepted, bit-identical: K5 retires per pixel and per block already
    block_exit: bool = False

    def instance_budget(self, n: int) -> int:
        if self.budget is not None:
            return self.budget
        return max(int(self.budget_factor * n), 4 * self.chunk)


class RasterizeResult(NamedTuple):
    image: torch.Tensor  # (H, W, C)
    alpha: torch.Tensor  # (H, W)
    radii: torch.Tensor  # (N,) int32, 0 = culled
    means2d: torch.Tensor  # (N, 2)
    overflow: torch.Tensor  # () int32 instances dropped (0 in normal operation)


def _tiles_to_image(tile_img, tiles_x, tiles_y, tile_h, tile_w, height, width):
    """(T, P, C) tile-major → (H, W, C), cropping the padded border."""
    c = tile_img.shape[-1]
    img = tile_img.reshape(tiles_y, tiles_x, tile_h, tile_w, c)
    img = img.permute(0, 2, 1, 3, 4).reshape(tiles_y * tile_h, tiles_x * tile_w, c)
    return img[:height, :width]


def order_ext(order: torch.Tensor) -> torch.Tensor:
    """Depth order extended with the sentinel row (rank n → row n); tables
    indexed by `inst_gid` are permuted with it: `table[order_ext(order)]`."""
    n = order.shape[0]
    return torch.cat([order, torch.full((1,), n, dtype=order.dtype, device=order.device)])


def _wants_cull(cfg: RasterizeConfig) -> bool:
    return cfg.tile_cull and not cfg.aligned


def _cull_rows(proj: ProjectedGaussians, opacities: torch.Tensor) -> torch.Tensor:
    """(N, 6) [mx, my, conic_a, conic_b, conic_c, L] of the exact
    ellipse-tile cull (tiles.ellipse_tile_keep); L = ln(255 o_eff), the
    alpha floor's level set in the kernels' sigma units."""
    lvl = torch.log(255.0 * torch.clamp_min(effective_opacity(opacities, proj.compensations),
                                            1e-12))
    return torch.cat([proj.means2d, proj.conics, lvl[:, None]], dim=1).to(torch.float32)


@torch.no_grad()
def _bin(proj, opacities, width, height, cfg):
    """Bin a projection (the binning arguments are set here only). The
    cull needs the opacities: without them (`prepare_binning` called
    without) it is off, as in JAX."""
    cull = (_cull_rows(proj, opacities)
            if _wants_cull(cfg) and opacities is not None else None)
    return tiles.bin_gaussians(
        proj.means2d, proj.radii_x, proj.depths, width, height,
        cfg.tile_w, cfg.tile_h, budget=cfg.instance_budget(proj.means2d.shape[0]),
        chunk=cfg.chunk, radii_y=proj.radii_y, aligned=cfg.aligned,
        cull_rows=cull, fused_keys=cfg.fused_keys,
    )


def _prepare(means, quats, scales, opacities, viewmat, K, width, height, cfg,
             means2d_tap=None):
    """Project + bin + geometry table, from one projection. No colour
    dependence. The table is differentiable where the geometry (and the
    tap) are; the binning never is."""
    tiles_x = -(-width // cfg.tile_w)
    tiles_y = -(-height // cfg.tile_h)
    proj, table = project_table(means, quats, scales, opacities, viewmat, K, width, height,
                                extents=cfg.opacity_extents, means2d_tap=means2d_tap)
    return proj, _bin(proj, opacities, width, height, cfg), table, tiles_x, tiles_y


def _inverse_order(order: torch.Tensor) -> torch.Tensor:
    """inv[order[r]] = r."""
    inv = torch.empty_like(order)
    inv[order.long()] = torch.arange(order.shape[0], dtype=order.dtype, device=order.device)
    return inv


class _PermuteRows(torch.autograd.Function):
    """y = x[perm] whose backward is the gather dx = dy[inv_perm] (the
    permutation is a bijection), not a scatter."""

    @staticmethod
    def forward(ctx, x, perm, inv_perm):
        ctx.save_for_backward(inv_perm)
        return x[perm.long()]

    @staticmethod
    def backward(ctx, g):
        (inv_perm,) = ctx.saved_tensors
        return g[inv_perm.long()], None, None


def permute_rows(x, perm, inv_perm):
    return _PermuteRows.apply(x, perm, inv_perm)


def _blend_forward(colors, geom, inst_gid, tile_starts, tile_counts, tile_order, bg, tiles_x,
                   tiles_y, cfg):
    """The forward of both blends: K1 on an aligned binning, K5 on an
    unaligned one, starting the tiles in `tile_order`. Returns the colour
    table with its zero sentinel row and the (T, P, C+1) tile image +
    alpha."""
    c = colors.shape[1]
    table = torch.cat([colors, colors.new_zeros((1, c))]).contiguous()
    args = (geom, table, inst_gid, tile_starts, tile_counts, bg, tiles_x, tiles_y,
            cfg.tile_h, cfg.tile_w)
    if cfg.aligned:
        return table, kernels.blend_forward_aligned(*args, tile_order=tile_order)
    return table, kernels.blend_forward(*args, tile_order=tile_order, **_k5_options(cfg))


def _k5_options(cfg: RasterizeConfig) -> dict:
    return dict(fast_color_rows=cfg.fast_color_rows, blend_bf16=cfg.blend_bf16,
                block_exit=cfg.block_exit, chunk=cfg.chunk)


def _require_aligned(cfg: RasterizeConfig) -> None:
    if not cfg.aligned:
        raise ValueError(
            "backward through the blend requires aligned binning "
            "(RasterizeConfig.aligned=True): the unaligned layout has no "
            "gradient-reduction layout")


class _Blend(torch.autograd.Function):
    """Tile blend of rank-ordered colours (N, C), differentiable with
    respect to the colours only; the background is a constant.

    Forward: K1 on an aligned binning, K5 on an unaligned one. Backward:
    K2 gives each instance slot its colour gradient, K3 sums the slots of
    each rank over the binning's ReductionLayout. The tiles start in one
    order (a `kernels.TileOrder`, made once here) in the forward and the
    backward. Returns the tile image (T, P, C) and alpha (T, P, 1).
    """

    @staticmethod
    def forward(ctx, colors, geom, inst_gid, tile_starts, tile_counts,
                red_slot, red_rank, red_block, bg, tiles_x, tiles_y, cfg):
        n, c = colors.shape
        ctx.order = order = kernels.TileOrder(tile_counts)
        _, out = _blend_forward(colors, geom, inst_gid, tile_starts, tile_counts, order, bg,
                                tiles_x, tiles_y, cfg)
        ctx.save_for_backward(geom, inst_gid, tile_starts, tile_counts,
                              red_slot, red_rank, red_block)
        ctx.grid = (tiles_x, tiles_y)
        ctx.cfg = cfg
        ctx.n = n
        img, alpha = out[..., :c].contiguous(), out[..., c:].contiguous()
        ctx.mark_non_differentiable(alpha)
        return img, alpha

    @staticmethod
    def backward(ctx, g_img, _g_alpha):  # alpha has no colour dependence
        cfg = ctx.cfg
        _require_aligned(cfg)
        geom, inst_gid, starts, counts, red_slot, red_rank, red_block = ctx.saved_tensors
        tiles_x, tiles_y = ctx.grid
        grad_inst = kernels.blend_backward(
            geom, inst_gid, starts, counts, g_img.contiguous(),
            tiles_x, tiles_y, cfg.tile_h, cfg.tile_w, tile_order=ctx.order)
        # the n real ranks only: the sentinel rank n (dummies and fillers,
        # zero rows) is never summed
        grad = kernels.sorted_segment_sum(
            grad_inst, red_slot, red_rank, red_block, num_ranks=ctx.n)
        return (grad,) + (None,) * 11


class _BlendFull(torch.autograd.Function):
    """Tile blend differentiable with respect to the rank-ordered colours
    (N, C) AND the rank-ordered (N+1, 8) geometry table; the background
    is a constant. Forward: as `_Blend`'s. Backward (aligned binnings
    only): the alpha cotangent net of the background (the forward blends
    bg against T_fin: image = acc + T_fin bg, alpha = 1 - T_fin), then K8
    gives each instance slot its colour and geometry gradients and K3 sums
    each over the ReductionLayout for the n real ranks. The sentinel row's
    gradient is zero (its table row is a constant). The tiles start in one
    order in the forward and the backward, as in `_Blend`. Returns the tile
    image (T, P, C) and alpha (T, P, 1)."""

    @staticmethod
    def forward(ctx, colors, geom, inst_gid, tile_starts, tile_counts,
                red_slot, red_rank, red_block, bg, tiles_x, tiles_y, cfg):
        c = colors.shape[1]
        geom = geom.contiguous()
        ctx.order = order = kernels.TileOrder(tile_counts)
        table, out = _blend_forward(colors, geom, inst_gid, tile_starts, tile_counts, order, bg,
                                    tiles_x, tiles_y, cfg)
        ctx.save_for_backward(table, geom, inst_gid, tile_starts, tile_counts,
                              red_slot, red_rank, red_block, bg)
        ctx.grid = (tiles_x, tiles_y)
        ctx.cfg = cfg
        return out[..., :c].contiguous(), out[..., c:].contiguous()

    @staticmethod
    def backward(ctx, g_img, g_alpha):
        cfg = ctx.cfg
        _require_aligned(cfg)
        (table, geom, inst_gid, starts, counts, red_slot, red_rank, red_block,
         bg) = ctx.saved_tensors
        tiles_x, tiles_y = ctx.grid
        n = table.shape[0] - 1
        g_alpha = g_alpha - torch.sum(g_img * bg, dim=-1, keepdim=True)
        grad_inst_col, grad_inst_geom = kernels.blend_backward_full(
            geom, table, inst_gid, starts, counts, g_img.contiguous(), g_alpha.contiguous(),
            tiles_x, tiles_y, cfg.tile_h, cfg.tile_w, tile_order=ctx.order)
        grad_colors = kernels.sorted_segment_sum(
            grad_inst_col, red_slot, red_rank, red_block, num_ranks=n)
        grad_geom = kernels.sorted_segment_sum(
            grad_inst_geom, red_slot, red_rank, red_block, num_ranks=n)
        grad_geom = torch.cat([grad_geom, grad_geom.new_zeros((1, 8))])
        return (grad_colors, grad_geom) + (None,) * 10


def _blend(colors_p, geom_p, inst_gid, tile_starts, tile_counts, red, bg, tiles_x,
           tiles_y, cfg, full=False):
    """_Blend (or, with `full`, _BlendFull) over a binning; `red` is None
    for unaligned binnings, whose backward raises before it would be
    read."""
    red_arrays = (None, None, None) if red is None else tuple(red)
    blend = _BlendFull if full else _Blend
    return blend.apply(colors_p, geom_p, inst_gid, tile_starts, tile_counts, *red_arrays,
                       bg, tiles_x, tiles_y, cfg)


@torch.no_grad()
def prepare_binning(means, quats, scales, viewmat, K, width: int, height: int,
                    config: RasterizeConfig = RasterizeConfig(),
                    opacities=None) -> tiles.BinnedInstances:
    """The sorted instance list of one (frozen geometry, camera) pair: the
    sort-dominated part of rasterization, computed once per camera by the
    GAD trainer and reused for every step. Runs on the inputs' device."""
    proj = project_gaussians(means, quats, scales, viewmat, K, width, height,
                             opacities=opacities if config.opacity_extents else None)
    return _bin(proj, opacities, width, height, config)


def rasterize_binned(means, quats, scales, opacities, colors, viewmat, K,
                     inst_gid, tile_starts, tile_counts, width: int, height: int,
                     background: Optional[torch.Tensor] = None,
                     config: RasterizeConfig = RasterizeConfig(), *,
                     order, red_slot, red_rank, red_block):
    """Re-project (cheap) and blend with a cached binning (`prepare_binning`).

    `order` is the cached `BinnedInstances.order`: inst_gid holds depth
    ranks, so the tables are permuted into rank order here. `red_*` is the
    cached `BinnedInstances.red`. Differentiable with respect to `colors`.
    Runs on the inputs' device. Returns (image (H, W, C), alpha (H, W)).
    """
    with torch.no_grad():
        table = project_table_only(means, quats, scales, opacities, viewmat, K, width, height)
        geom = table[order_ext(order.long())]
        inv_order = _inverse_order(order)
    tiles_x = -(-width // config.tile_w)
    tiles_y = -(-height // config.tile_h)
    colors_p = permute_rows(colors, order, inv_order)
    if background is None:
        background = torch.zeros((colors.shape[1],), dtype=torch.float32, device=colors.device)
    tile_img, tile_alpha = _blend(colors_p, geom.contiguous(), inst_gid, tile_starts,
                                  tile_counts, (red_slot, red_rank, red_block), background,
                                  tiles_x, tiles_y, config)
    img = _tiles_to_image(tile_img, tiles_x, tiles_y, config.tile_h, config.tile_w,
                          height, width)
    alpha = _tiles_to_image(tile_alpha, tiles_x, tiles_y, config.tile_h, config.tile_w,
                            height, width)[..., 0]
    return img, alpha


def rasterize(
    means: torch.Tensor,
    quats: torch.Tensor,
    scales: torch.Tensor,
    opacities: torch.Tensor,
    colors: torch.Tensor,
    viewmat: torch.Tensor,
    K: torch.Tensor,
    width: int,
    height: int,
    background: Optional[torch.Tensor] = None,
    config: RasterizeConfig = RasterizeConfig(),
    means2d_tap: Optional[torch.Tensor] = None,
    device="cuda",
) -> RasterizeResult:
    """Rasterize N Gaussians with C colour channels into an (H, W, C) image.

    Inputs are moved to `device` (default "cuda", which raises when CUDA
    is absent; tests pass "cpu", which runs the kernels' plain versions).
    The image is differentiable with respect to `colors` on an aligned
    binning (the default). With `config.geometry_grads` the image and the
    alpha are also differentiable with respect to means, quats, scales and
    opacities (K8 + the projection's backward); otherwise geometry
    receives no gradient. `means2d_tap`, an optional (N, 2) ZERO tensor
    (geometry_grads only), is added to the projected screen positions: its
    gradient is dL/dmeans2d in pixels, the densification signal the
    reference reads through `retain_grad`. The binning is discrete and
    never differentiated.
    """
    dev = resolve_device(device)

    def f32(t):
        return t.to(device=dev, dtype=torch.float32).contiguous()

    colors = f32(colors)
    geo = [f32(t) for t in (means, quats, scales, opacities)]
    if not config.geometry_grads:
        geo = [t.detach() for t in geo]
    viewmat, K = f32(viewmat).detach(), f32(K).detach()
    tap = f32(means2d_tap) if config.geometry_grads and means2d_tap is not None else None
    # one projection: the binning's extents and the table, whose gradient
    # (geometry_grads) the projection's backward carries to the geometry
    proj, binned, geom, tiles_x, tiles_y = _prepare(*geo, viewmat, K, width, height, config,
                                                    means2d_tap=tap)
    with torch.no_grad():
        # inst_gid holds depth ranks: permute both tables into rank order
        perm = order_ext(binned.order.long())
        inv_order = _inverse_order(binned.order)
    if config.geometry_grads:
        geom_p = permute_rows(geom, perm, _inverse_order(perm))
    else:
        geom_p = geom[perm].contiguous()
    colors_p = permute_rows(colors, binned.order, inv_order)
    c = colors.shape[1]
    bg = torch.zeros((c,), dtype=torch.float32, device=dev) if background is None else f32(background)
    tile_img, tile_alpha = _blend(colors_p, geom_p, binned.inst_gid, binned.tile_starts,
                                  binned.tile_counts, binned.red, bg, tiles_x, tiles_y, config,
                                  full=config.geometry_grads)
    img = _tiles_to_image(tile_img, tiles_x, tiles_y, config.tile_h,
                          config.tile_w, height, width)
    alpha = _tiles_to_image(tile_alpha, tiles_x, tiles_y, config.tile_h,
                            config.tile_w, height, width)[..., 0]
    return RasterizeResult(
        image=img, alpha=alpha, radii=proj.radii, means2d=proj.means2d,
        overflow=binned.overflow,
    )


@torch.no_grad()
def rasterize_exit_stats(means, quats, scales, opacities, colors, viewmat, K, width: int,
                         height: int, background: Optional[torch.Tensor] = None,
                         config: RasterizeConfig = RasterizeConfig(aligned=False),
                         device="cuda"):
    """The unaligned forward WITH K5's per-tile early-exit counters.

    Returns (stats (T, 8, 128) f32, num_valid () int32). Row 0 of each
    tile: lanes 0-3 segments done / total and chunks done / total (chunks
    of `config.chunk` instances, segments of 8 chunks), lane 4 the largest
    log2 of a pixel's naive T where it stopped (its final T where it never
    did). The tables are permuted into depth-rank order here, as
    `rasterize` does (the JAX package's note on the probes that skipped
    that step and measured a garbage workload). Runs on `device` (default
    "cuda")."""
    if config.aligned:
        raise ValueError("rasterize_exit_stats: the unaligned binning only (aligned=False)")
    dev = resolve_device(device)

    def f32(t):
        return t.to(device=dev, dtype=torch.float32).contiguous()

    geo = [f32(t) for t in (means, quats, scales, opacities)]
    proj, binned, geom, tiles_x, tiles_y = _prepare(*geo, f32(viewmat), f32(K), width, height,
                                                    config)
    perm = order_ext(binned.order.long())
    colors = f32(colors)
    c = colors.shape[1]
    table = torch.cat([colors, colors.new_zeros((1, c))])[perm].contiguous()
    bg = torch.zeros((c,), dtype=torch.float32, device=dev) if background is None else f32(background)
    _, stats = kernels.blend_forward(geom[perm].contiguous(), table, binned.inst_gid,
                                     binned.tile_starts, binned.tile_counts, bg, tiles_x,
                                     tiles_y, config.tile_h, config.tile_w, exit_stats=True,
                                     **_k5_options(config))
    return stats, binned.num_valid
