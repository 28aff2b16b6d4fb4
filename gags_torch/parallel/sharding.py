"""Meshes of ranks and camera data parallelism for GAD training (port of
gags_tpu.parallel.sharding).

One process per rank, each with its own torch.distributed process group
and device (`launch.spawn` starts them). A `Mesh` names this rank's
groups: the 1-D mesh of `make_mesh` is the whole world along one axis;
`make_mesh2d(n_dp, n_gs)` lays the ranks out row-major, rank = dp * n_gs
+ gs, with one group per row ("gs": the Gaussian shard and its image
strips, gshard.py) and one per column ("dp": the camera batch).

`make_dp_train_step`: every rank holds the whole state and renders its
own cameras; their gradients (accumulated camera by camera, divided by
the local count) are all-reduced in one flat buffer and divided by the
world size before the three Adam steps, so every rank applies the same
update: a step over world x local cameras is the batch-mean step.
`make_dp_render`: each rank renders its share of a camera batch, no
collective but the gather of the images.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.distributed as dist

from gags_torch.gad import train
from gags_torch.gad.train import GadConfig, TrainState
from gags_torch.parallel.collectives import all_gather_tensor, all_reduce_, all_reduce_max
from gags_torch.splat.rasterizer import RasterizeConfig, rasterize


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a mesh: per axis name, its size, this rank's
    index along it and the process group of the ranks that share every
    other index with this one."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, object]

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def _world(n: int) -> int:
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}: they must match")
    return world


def make_mesh(n_devices: int | None = None, axis: str = "dp") -> Mesh:
    """The 1-D mesh over every rank of the initialised default group."""
    n = _world(dist.get_world_size() if n_devices is None else n_devices)
    return Mesh((axis,), {axis: n}, {axis: dist.get_rank()}, {axis: dist.group.WORLD})


def make_mesh2d(n_dp: int, n_gs: int, axes: tuple[str, str] = ("dp", "gs")) -> Mesh:
    """(n_dp, n_gs) mesh, row-major: camera batch over axes[0], Gaussian
    shard + tile strips over axes[1] (gshard.make_dp_gshard_train_step).
    Every rank creates every row and column group, in one order."""
    _world(n_dp * n_gs)
    rank = dist.get_rank()
    i, j = divmod(rank, n_gs)
    rows = [dist.new_group([r * n_gs + c for c in range(n_gs)]) for r in range(n_dp)]
    cols = [dist.new_group([r * n_gs + c for r in range(n_dp)]) for c in range(n_gs)]
    dp, gs = axes
    return Mesh(axes, {dp: n_dp, gs: n_gs}, {dp: i, gs: j}, {dp: cols[j], gs: rows[i]})


def train_params(state) -> list:
    """The trained tensors in optimiser order: features, then both decoders."""
    return ([state.features] + list(state.decoder.parameters())
            + list(state.scale_decoder.parameters()))


def flat_grads(params) -> torch.Tensor:
    """One contiguous buffer of the parameters' gradients (zeros where a
    parameter got none), to be reduced by one collective."""
    return torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in params])


def set_grads(params, flat: torch.Tensor) -> None:
    """The inverse of `flat_grads`: each parameter's gradient a view of
    `flat`."""
    i = 0
    for p in params:
        p.grad = flat[i:i + p.numel()].view_as(p)
        i += p.numel()


def make_dp_train_step(mesh: Mesh, width: int, height: int, cfg: GadConfig,
                       binned: bool = False):
    """step(state, geom, batch, entropy_w, regionvar_w) → (state, metrics).

    `state` and `geom` (frozen_geometry) are this rank's full replicas;
    `batch` holds this rank's cameras on a leading axis: viewmat (B, 4, 4),
    K (B, 3, 3), img_embed (B, M, D), seg_map (B, H, W, 4), and with
    `binned` each camera's cached binning (inst_gid, tile_starts,
    tile_counts, order, red_slot, red_rank, red_block: the single-camera
    `make_train_step_binned` path). metrics: loss (the mean over every
    camera of every rank) and overflow (the worst camera's). Updates
    `state` in place, identically on every rank."""
    axis = mesh.axis_names[0]
    group, world = mesh.groups[axis], mesh.shape[axis]

    def step(state: TrainState, geom, batch, entropy_w: float, regionvar_w: float):
        opts = (state.opt_feat, state.opt_dec, state.opt_scale)
        for opt in opts:
            opt.zero_grad(set_to_none=True)
        b_local = int(batch["viewmat"].shape[0])
        loss, overflow = None, None
        for i in range(b_local):  # gradients accumulate camera by camera
            total, m = train.camera_loss(state, geom, {k: v[i] for k, v in batch.items()},
                                         entropy_w, regionvar_w, width, height, cfg, binned)
            total.backward()
            loss = total.detach() if loss is None else loss + total.detach()
            overflow = m["overflow"] if overflow is None else torch.maximum(overflow,
                                                                              m["overflow"])
        params = train_params(state)
        flat = torch.cat([flat_grads(params), loss.reshape(1)])
        if b_local > 1:
            flat /= b_local
        all_reduce_(flat, group)
        flat /= world
        set_grads(params, flat[:-1])
        for opt in opts:
            opt.step()
        state.step += 1
        return state, dict(loss=flat[-1], overflow=all_reduce_max(overflow, group))

    return step


def make_dp_render(mesh: Mesh, width: int, height: int, config: RasterizeConfig):
    """render(geom, colors, viewmats, Ks, bg) → (images (B, H, W, C),
    alphas (B, H, W)) on every rank: B cameras (a multiple of the mesh
    size), rank r rendering the r-th run of B / size of them through the
    unaligned (forward-only) rasterizer on its device, then one gather.
    geom/colors: every rank's replicas."""
    axis = mesh.axis_names[0]
    group, world, rank = mesh.groups[axis], mesh.shape[axis], mesh.coords[axis]
    cfg = dataclasses.replace(config, aligned=False)

    @torch.no_grad()
    def render(geom, colors, viewmats, Ks, bg):
        b = int(viewmats.shape[0])
        if b % world:
            raise ValueError(f"{b} cameras do not split over {world} ranks")
        b_local = b // world
        imgs, alphas = [], []
        for i in range(rank * b_local, (rank + 1) * b_local):
            res = rasterize(geom["means"], geom["quats"], geom["scales"], geom["opacities"],
                            colors, viewmats[i], Ks[i], width, height, background=bg,
                            config=cfg, device=colors.device)
            imgs.append(res.image)
            alphas.append(res.alpha)
        return (all_gather_tensor(torch.stack(imgs), group),
                all_gather_tensor(torch.stack(alphas), group))

    return render
