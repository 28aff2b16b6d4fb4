"""Inference rasterizer: project → bin (unaligned) → blend. Port of the
forward-only path of gags_tpu.splat.rasterizer.

`rasterize` projects the Gaussians, bins them with the unaligned binning
(kernel K6), permutes the geometry and colour tables into depth-rank
order, and blends each tile's range with kernel K5. Only the fields the
serving path reads are ported: the TPU-only switches of the JAX config
(mxu_sigma, p_block, soa_geom, image_chw, fast_color_rows, blend_bf16,
block_exit, fused_keys, tile_cull) are absent, and training
(aligned binning, gradients) is not part of this module yet.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from gags_torch import resolve_device
from gags_torch.splat import kernels, tiles
from gags_torch.splat.projection import ProjectedGaussians, effective_opacity, project_gaussians


@dataclasses.dataclass(frozen=True)
class RasterizeConfig:
    tile_h: int = 32
    tile_w: int = 32
    chunk: int = 128  # tail padding of the instance list (JAX layout parity)
    budget_factor: float = 4.0  # instance budget = factor * N
    budget: Optional[int] = None  # explicit override
    # forward-only unaligned binning; the aligned (training) layout is not
    # ported yet
    aligned: bool = False
    # shrink binning rects to each splat's alpha-floor contour (image-exact)
    opacity_extents: bool = True

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


def _geom_table(proj: ProjectedGaussians, opacities: torch.Tensor) -> torch.Tensor:
    """(N+1, 8) table [mx, my, ca, cb, cc, opac, 0, 0] with a zero
    (opacity-0) sentinel row."""
    n = proj.means2d.shape[0]
    table = torch.zeros((n + 1, 8), dtype=torch.float32, device=proj.means2d.device)
    table[:n, 0:2] = proj.means2d
    table[:n, 2:5] = proj.conics
    table[:n, 5] = effective_opacity(opacities, proj.compensations)
    return table


def order_ext(order: torch.Tensor) -> torch.Tensor:
    """Depth order extended with the sentinel row (rank n → row n); tables
    indexed by `inst_gid` are permuted with it: `table[order_ext(order)]`."""
    n = order.shape[0]
    return torch.cat([order, torch.full((1,), n, dtype=order.dtype, device=order.device)])


def _prepare(means, quats, scales, opacities, viewmat, K, width, height, cfg):
    """Project + bin + geometry table. No colour dependence."""
    if cfg.aligned:
        raise NotImplementedError("aligned (training) binning is not ported yet")
    tiles_x = -(-width // cfg.tile_w)
    tiles_y = -(-height // cfg.tile_h)
    n = means.shape[0]
    proj = project_gaussians(
        means, quats, scales, viewmat, K, width, height,
        opacities=opacities if cfg.opacity_extents else None,
    )
    binned = tiles.bin_gaussians(
        proj.means2d, proj.radii_x, proj.depths, width, height,
        cfg.tile_w, cfg.tile_h, budget=cfg.instance_budget(n),
        chunk=cfg.chunk, radii_y=proj.radii_y,
    )
    return proj, binned, _geom_table(proj, opacities), tiles_x, tiles_y


@torch.no_grad()
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
    device="cuda",
) -> RasterizeResult:
    """Rasterize N Gaussians with C colour channels into an (H, W, C) image.

    Inputs are moved to `device` (default "cuda", which raises when CUDA
    is absent; tests pass "cpu", which runs the kernels' plain versions).
    Forward only: no gradient flows.
    """
    dev = resolve_device(device)

    def f32(t):
        return t.to(device=dev, dtype=torch.float32).contiguous()

    means, quats, scales, opacities, colors = map(
        f32, (means, quats, scales, opacities, colors)
    )
    viewmat, K = f32(viewmat), f32(K)
    proj, binned, geom, tiles_x, tiles_y = _prepare(
        means, quats, scales, opacities, viewmat, K, width, height, config
    )
    c = colors.shape[1]
    # inst_gid holds depth ranks: permute both tables into rank order
    perm = order_ext(binned.order.long())
    geom_p = geom[perm].contiguous()
    colors_p = torch.cat(
        [colors, torch.zeros((1, c), dtype=torch.float32, device=dev)]
    )[perm].contiguous()
    bg = torch.zeros((c,), dtype=torch.float32, device=dev) if background is None else f32(background)
    out = kernels.blend_forward(
        geom_p, colors_p, binned.inst_gid, binned.tile_starts,
        binned.tile_counts, bg, tiles_x, tiles_y, config.tile_h, config.tile_w,
    )
    img = _tiles_to_image(out[..., :c], tiles_x, tiles_y, config.tile_h,
                          config.tile_w, height, width)
    alpha = _tiles_to_image(out[..., c:], tiles_x, tiles_y, config.tile_h,
                            config.tile_w, height, width)[..., 0]
    return RasterizeResult(
        image=img, alpha=alpha, radii=proj.radii, means2d=proj.means2d,
        overflow=binned.overflow,
    )
