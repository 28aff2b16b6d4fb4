"""Gaussian-axis sharding and tile-strip rasterization (port of
gags_tpu.parallel.gshard).

For scenes too large to replicate on every rank, the features (and their
Adam moments) are sharded over the ranks of a mesh axis while the image
is split into strips of whole tile rows, one per rank:

  1. each rank projects its own Gaussian shard (N / D work);
  2. the per-Gaussian screen table (9 columns: means2d, conic, effective
     opacity, x / y extents, depth) is all-gathered without gradient, the
     feature rows with it (collectives.all_gather_rows);
  3. each rank bins and blends only its strip, with the one-device
     kernels on y-shifted coordinates (K6 or K7 in the binning, K1 or K5
     in the blend, K2 + K3 in the backward);
  4. the strip losses sum their region moments over the ranks (K4 per
     strip, then a differentiable all_reduce), smooth the scale map with
     a halo exchange, and every rank holds the full-image loss. The
     feature gradients come back through the gather's reduce_scatter,
     exact per shard; the decoders' are summed over the strips.

Two faults of the JAX package are left out (ROADMAP.md §3): its gradients
come out scaled by the strip count (the psum transpose under
check_vma=False), and the pad rows below the image (the strips' tile rows
beyond H) enter its loss. Here the strips project at the image's own
height and the losses see the image's pixels only: the scale map is zero
below the image for the halo smoothing, as outside it, and every mean
divides by the true H * W. The result is the one-device loss.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from gags_torch.gad import losses
from gags_torch.gad.train import (GadConfig, TrainState, _decoder_precision, _scale_map_fn,
                                  supervised_l1_pix)
from gags_torch.models.decoders import FeatureDecoder, ScaleDecoder
from gags_torch.parallel.collectives import (all_gather_rows, all_gather_tensor, all_reduce_,
                                             all_reduce_max, all_reduce_sum, halo_rows)
from gags_torch.parallel.sharding import Mesh, flat_grads, set_grads
from gags_torch.splat import tiles
from gags_torch.splat.projection import effective_opacity, project_gaussians
from gags_torch.splat.rasterizer import (RasterizeConfig, _blend, _inverse_order,
                                         _tiles_to_image, order_ext, permute_rows)
from gags_torch.utils.image import mean_smooth


def pad_to_multiple(x: torch.Tensor, mult: int, axis: int = 0) -> torch.Tensor:
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def _shard(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """This rank's rows of `x` zero-padded to a multiple of the axis size."""
    d, r = mesh.shape[axis], mesh.coords[axis]
    xp = pad_to_multiple(x, d)
    n_l = xp.shape[0] // d
    return xp[r * n_l:(r + 1) * n_l].contiguous()


def shard_gaussians(geom: Dict[str, torch.Tensor], features: torch.Tensor, mesh: Mesh,
                    axis: str | None = None) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """This rank's shard of the geometry and features, N padded to a
    multiple of the axis size, with a `valid` (N_l,) float mask: the pad
    Gaussians' extents are zeroed, so they never produce instances.
    `axis` names the Gaussian axis (default the mesh's first; "gs" on
    the 2-D mesh)."""
    axis = axis or mesh.axis_names[0]
    n = geom["means"].shape[0]
    out = {k: _shard(v, mesh, axis) for k, v in geom.items()}
    n_pad = n + (-n) % mesh.shape[axis]
    valid = (torch.arange(n_pad, device=geom["means"].device) < n).to(torch.float32)
    out["valid"] = _shard(valid, mesh, axis)
    return out, _shard(features.detach(), mesh, axis).clone()


def _strip_geometry(cfg: RasterizeConfig, height: int, n_dev: int) -> Tuple[int, int]:
    """(tile rows a strip, strip height in pixels)."""
    tiles_y = -(-height // cfg.tile_h)
    tiles_y_local = -(-tiles_y // n_dev)
    return tiles_y_local, tiles_y_local * cfg.tile_h


def _real_rows(cfg: RasterizeConfig, height: int, n_dev: int, rank: int) -> Tuple[int, int]:
    """(first image row of the strip, how many of its rows lie in the image)."""
    _, strip_h = _strip_geometry(cfg, height, n_dev)
    y0 = rank * strip_h
    return y0, max(0, min(strip_h, height - y0))


def _render_strip(mesh: Mesh, axis: str, geom_l, feats_l, viewmat, K, width: int, height: int,
                  cfg: RasterizeConfig, background, budget_slack: float = 2.0):
    """One rank's strip: project the local shard, gather the screen table
    and the feature rows, bin and blend this strip's tile rows. Returns
    (image (strip_h, W, C), alpha (strip_h, W), overflow ()); the image is
    differentiable with respect to feats_l (through the gather)."""
    group, n_dev, rank = mesh.groups[axis], mesh.shape[axis], mesh.coords[axis]
    tiles_y_local, strip_h = _strip_geometry(cfg, height, n_dev)
    tiles_x = -(-width // cfg.tile_w)
    with torch.no_grad():
        # at the image's own height: the projection's FoV clamp and border
        # cull read it, so the table is the one-device table
        proj = project_gaussians(
            geom_l["means"], geom_l["quats"], geom_l["scales"], viewmat, K, width, height,
            opacities=geom_l["opacities"] if cfg.opacity_extents else None)
        valid = geom_l["valid"]
        local_rows = torch.cat([
            proj.means2d, proj.conics,
            effective_opacity(geom_l["opacities"], proj.compensations)[:, None],
            (proj.radii_x.to(torch.float32) * valid)[:, None],
            (proj.radii_y.to(torch.float32) * valid)[:, None],
            proj.depths[:, None]], dim=1)
        rows = all_gather_tensor(local_rows, group)  # (N_pad, 9)
    colors = all_gather_rows(feats_l, group)  # (N_pad, C), differentiable
    with torch.no_grad():
        n = rows.shape[0]
        shift = torch.tensor([0.0, float(rank * strip_h)], device=rows.device)
        m2 = rows[:, :2] - shift
        cull = None
        if cfg.tile_cull and not cfg.aligned:
            lvl = torch.log(255.0 * torch.clamp_min(rows[:, 5:6], 1e-12))
            cull = torch.cat([m2, rows[:, 2:5], lvl], dim=1)
        binned = tiles.bin_gaussians(
            m2, rows[:, 6].to(torch.int32), rows[:, 8], width, strip_h, cfg.tile_w, cfg.tile_h,
            # instances skew across strips: the slack covers the imbalance
            # without the whole image's budget on every rank
            budget=max(int(cfg.instance_budget(n) * budget_slack) // n_dev, 4 * cfg.chunk),
            chunk=cfg.chunk, radii_y=rows[:, 7].to(torch.int32), aligned=cfg.aligned,
            cull_rows=cull, fused_keys=cfg.fused_keys)
        table = torch.cat([m2, rows[:, 2:6], rows.new_zeros((n, 2))], dim=1)
        table = torch.cat([table, table.new_zeros((1, 8))])
        geom_p = table[order_ext(binned.order.long())].contiguous()
        inv_order = _inverse_order(binned.order)
    colors_p = permute_rows(colors, binned.order, inv_order)
    bg = background if background is not None else colors.new_zeros((colors.shape[1],))
    tile_img, tile_alpha = _blend(colors_p, geom_p, binned.inst_gid, binned.tile_starts,
                                  binned.tile_counts, binned.red, bg, tiles_x, tiles_y_local,
                                  cfg)
    img = _tiles_to_image(tile_img, tiles_x, tiles_y_local, cfg.tile_h, cfg.tile_w, strip_h,
                          width)
    alpha = _tiles_to_image(tile_alpha, tiles_x, tiles_y_local, cfg.tile_h, cfg.tile_w,
                            strip_h, width)[..., 0]
    return img, alpha, binned.overflow


def make_gshard_render(mesh: Mesh, width: int, height: int, channels: int,
                       cfg: RasterizeConfig, budget_slack: float = 2.0):
    """render(geom_l, feats_l, viewmat, K) → (image (H, W, C), alpha
    (H, W), overflow ()) on every rank, from `shard_gaussians`' shards:
    each rank renders its strip, the strips are gathered, overflow is the
    worst strip's. Forward-only, so the strips take the unaligned path
    (K5; K6, or K7 with fused_keys; the ellipse-tile cull with tile_cull)
    whatever the caller's config says."""
    cfg = dataclasses.replace(cfg, aligned=False)
    axis = mesh.axis_names[0]
    group = mesh.groups[axis]

    @torch.no_grad()
    def render(geom_l, feats_l, viewmat, K):
        bg = feats_l.new_zeros((channels,))
        img, alpha, ovf = _render_strip(mesh, axis, geom_l, feats_l, viewmat, K, width,
                                        height, cfg, bg, budget_slack)
        return (all_gather_tensor(img, group)[:height], all_gather_tensor(alpha, group)[:height],
                all_reduce_max(ovf, group))

    return render


@dataclasses.dataclass
class GShardState:
    """A train state whose features (and their Adam moments) are this
    rank's shard; the decoders and their optimisers are replicas."""

    step: int
    features: torch.Tensor  # (N_pad / D, F) trainable leaf
    decoder: FeatureDecoder
    scale_decoder: ScaleDecoder
    opt_feat: torch.optim.Adam
    opt_dec: torch.optim.Adam
    opt_scale: torch.optim.Adam


def gshard_state(state: TrainState, mesh: Mesh, axis: str | None = None) -> GShardState:
    """This rank's GShardState from a one-device TrainState: the features
    and their Adam moments sliced to the rank's padded shard over `axis`
    (default the mesh's first), copies of the decoders and their Adam
    states. `state` is left as it was."""
    axis = axis or mesh.axis_names[0]
    n = state.features.shape[0]
    feats = _shard(state.features.detach(), mesh, axis).clone().requires_grad_(True)
    sd = copy.deepcopy(state.opt_feat.state_dict())
    for moments in sd["state"].values():
        for k, v in moments.items():
            if torch.is_tensor(v) and v.dim() > 0 and v.shape[0] == n:
                moments[k] = _shard(v, mesh, axis)
    opt_feat = torch.optim.Adam([feats], **state.opt_feat.defaults)
    opt_feat.load_state_dict(sd)
    dec, scl = copy.deepcopy(state.decoder), copy.deepcopy(state.scale_decoder)
    opt_dec = torch.optim.Adam(dec.parameters(), **state.opt_dec.defaults)
    opt_dec.load_state_dict(state.opt_dec.state_dict())
    opt_scale = torch.optim.Adam(scl.parameters(), **state.opt_scale.defaults)
    opt_scale.load_state_dict(state.opt_scale.state_dict())
    return GShardState(state.step, feats, dec, scl, opt_feat, opt_dec, opt_scale)


def _halo_smooth(x: torch.Tensor, k: int, mesh: Mesh, axis: str) -> torch.Tensor:
    """mean_smooth over row strips with a halo exchange: the full image's
    zero-padded box filter at strip interiors and at the image's borders."""
    halo = k // 2
    above, below = halo_rows(x, halo, mesh.groups[axis])
    return mean_smooth(torch.cat([above, x, below]), k)[halo:-halo]


def _mixed_seg_map_strip(seg_map: torch.Tensor, scale_map: torch.Tensor, mesh: Mesh,
                         axis: str) -> torch.Tensor:
    """supervision.mixed_seg_map over a row strip (halo-exchanged k=5
    smoothing of the strip's scale map); seg_map holds the strip's rows
    that lie in the image, which may be fewer."""
    sel = torch.argmax(_halo_smooth(scale_map, 5, mesh, axis), dim=-1)[:seg_map.shape[0]]
    return torch.gather(seg_map[..., 1:4], -1, sel[..., None])[..., 0]


def _strip_local_loss(mesh: Mesh, axis: str, width: int, height: int, cfg: GadConfig,
                      budget_slack: float):
    """loss(state, geom_l, batch, entropy_w, regionvar_w) → (loss, overflow)
    of this rank's strip over the Gaussian / strip axis `axis`: the
    full-image GAD loss on every rank (the 1-D and the 2-D steps share it).
    batch: viewmat, K, img_embed and the image's seg_map (H, W, 4), or
    `pad_seg_map`'s; the rank reads its strip's rows."""
    group, n_dev, rank = mesh.groups[axis], mesh.shape[axis], mesh.coords[axis]
    _, strip_h = _strip_geometry(cfg.raster, height, n_dev)
    y0, n_real = _real_rows(cfg.raster, height, n_dev, rank)

    def local_loss(state, geom_l, batch, entropy_w, regionvar_w):
        fdim = state.features.shape[1]
        bg = state.features.new_zeros((fdim,))
        feat_map, _alpha, ovf = _render_strip(mesh, axis, geom_l, state.features,
                                              batch["viewmat"], batch["K"], width, height,
                                              cfg.raster, bg, budget_slack)
        feat_map = feat_map[:n_real]  # the image's rows only
        seg = batch["seg_map"][y0:y0 + n_real]
        # flat pixels where the fused supervision applies, as on one device
        px = feat_map.reshape(-1, fdim) if cfg.fused_supervision else feat_map
        scale_px = _scale_map_fn(cfg, state.scale_decoder, px)
        scale_map = scale_px.detach().reshape(n_real, width, 3)
        # zero below the image for the smoothing, as outside it
        scale_map = torch.cat([scale_map, scale_map.new_zeros((strip_h - n_real, width, 3))])
        seg_mixed = _mixed_seg_map_strip(seg, scale_map, mesh, axis)
        with _decoder_precision(cfg, px.device):
            raw = state.decoder.unnormalised(px)
        l1_pix = supervised_l1_pix(cfg, raw, scale_px, dict(batch, seg_map=seg))
        l1_feature = losses.region_balanced_l1(l1_pix, seg_mixed, cfg.max_segments, group=group)
        # scale_entropy_loss over the whole image: the strips' sums over H*W*3
        ent_sum = torch.sum(-scale_px * torch.log(scale_px + 1e-6))
        ent = all_reduce_sum(ent_sum, group) / (height * width * 3)
        regvar = losses.region_variance_loss(px, seg_mixed, cfg.max_segments, group=group,
                                             num_pixels=height * width)
        return l1_feature + entropy_w * ent + regionvar_w * regvar, ovf

    return local_loss


def _decoder_params(state: GShardState) -> list:
    return list(state.decoder.parameters()) + list(state.scale_decoder.parameters())


def _zero_grads(state: GShardState) -> tuple:
    opts = (state.opt_feat, state.opt_dec, state.opt_scale)
    for opt in opts:
        opt.zero_grad(set_to_none=True)
    return opts


def make_gshard_train_step(mesh: Mesh, width: int, height: int, cfg: GadConfig,
                           budget_slack: float = 2.0):
    """step(state, geom_l, batch, entropy_w, regionvar_w) → (state, metrics)
    on Gaussian-sharded features with strip rasterization (1-D mesh).

    state: `gshard_state`; geom_l: `shard_gaussians`' shard; batch:
    viewmat (4, 4), K (3, 3), img_embed (M, D) and seg_map (H, W, 4),
    the same on every rank. The loss is the full-image loss; feature
    gradients arrive per shard through the gather's reduce_scatter; the
    decoders' are summed over the strips. metrics: loss, overflow (the
    worst strip's dropped instances: non-zero means the gradients came
    from a truncated instance list; retry with a larger budget_slack).
    After the step each parameter's `.grad` holds its full gradient.
    Updates `state` in place."""
    axis = mesh.axis_names[0]
    group = mesh.groups[axis]
    local_loss = _strip_local_loss(mesh, axis, width, height, cfg, budget_slack)

    def step(state: GShardState, geom_l, batch, entropy_w: float, regionvar_w: float):
        opts = _zero_grads(state)
        loss, ovf = local_loss(state, geom_l, batch, entropy_w, regionvar_w)
        loss.backward()
        params = _decoder_params(state)
        set_grads(params, all_reduce_(flat_grads(params), group))
        for opt in opts:
            opt.step()
        state.step += 1
        return state, dict(loss=loss.detach(), overflow=all_reduce_max(ovf, group))

    return step


def make_dp_gshard_train_step(mesh: Mesh, width: int, height: int, cfg: GadConfig,
                              budget_slack: float = 2.0):
    """The 2-D mesh step: cameras over axis 0 ("dp"), the Gaussian shard
    and tile strips over axis 1 ("gs"). Every dp row trains its own camera
    on the same gs-sharded state (`gshard_state(state, mesh, axis="gs")`,
    geometry from `shard_gaussians(..., axis="gs")`): feature gradients
    are exact per shard and averaged over dp; the decoders' are summed
    over gs, then averaged over dp; the loss is the mean over dp. batch is
    this rank's dp row's camera (as in `make_gshard_train_step`). Every
    rank applies the same update, as `sharding.make_dp_train_step` does.
    metrics: loss, overflow (the worst strip of any camera)."""
    dp_ax, gs_ax = mesh.axis_names
    dp_group, gs_group, n_dp = mesh.groups[dp_ax], mesh.groups[gs_ax], mesh.shape[dp_ax]
    local_loss = _strip_local_loss(mesh, gs_ax, width, height, cfg, budget_slack)

    def step(state: GShardState, geom_l, batch, entropy_w: float, regionvar_w: float):
        opts = _zero_grads(state)
        loss, ovf = local_loss(state, geom_l, batch, entropy_w, regionvar_w)
        loss.backward()
        dec = all_reduce_(flat_grads(_decoder_params(state)), gs_group)
        flat = torch.cat([flat_grads([state.features]), dec, loss.detach().reshape(1)])
        all_reduce_(flat, dp_group)
        flat /= n_dp
        set_grads([state.features] + _decoder_params(state), flat[:-1])
        for opt in opts:
            opt.step()
        state.step += 1
        ovf = all_reduce_max(all_reduce_max(ovf, gs_group), dp_group)
        return state, dict(loss=flat[-1], overflow=ovf)

    return step


def pad_seg_map(seg_map: np.ndarray, mesh: Mesh, cfg: RasterizeConfig,
                axis: str | None = None) -> np.ndarray:
    """(H, W, 4) seg map rows padded to n_dev * strip_h with -1 (no mask).
    The steps read the image's rows only, so they take either form."""
    n_dev = mesh.shape[axis or mesh.axis_names[0]]
    _, strip_h = _strip_geometry(cfg, seg_map.shape[0], n_dev)
    pad = strip_h * n_dev - seg_map.shape[0]
    if pad <= 0:
        return seg_map
    return np.pad(seg_map, ((0, pad), (0, 0), (0, 0)), constant_values=-1)

