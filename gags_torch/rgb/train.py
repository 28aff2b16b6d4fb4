"""RGB 3DGS pretraining (port of gags_tpu.rgb.train): the stage that makes
the pretrained scene GAS and GAD start from.

L1 + 0.2 (1 - SSIM) photometric loss through the geometry-gradient
rasterizer (K1 forward, K8 + K3 backward), per-group Adam with the
exponential position schedule, SH-degree warm-up (the CLI's), and
adaptive density control. On CUDA the step's three eager chains are
kernels: the SH colours J3 (`core.sh.sh_colors`), the loss J4 and the
update J5 (`rgb.kernels`); on the CPU they run eagerly.

The JAX package's fixed-capacity design is kept: the Gaussian buffers
hold `capacity_factor` x N slots with an `alive` mask, clone and split
write into free slots, and prune parks a slot far behind every camera
(z = -1e9: the frustum cull drops it, so it costs no instance). No
tensor is reallocated when the scene grows, the Adam moments stay slot
for slot, and a state carried over from JAX (`models.weights.
load_jax_rgb_state`) steps like JAX's. Unlike JAX's pure functions, the
step, `densify_step` and `reset_opacity_step` update the state's tensors
in place and return the same state.

Traced (utils/tracing): `rgb.step` a step of `make_rgb_step`, inside it
`rgb.forward` (SH colours, rasterize, L1 + SSIM), `rgb.backward` and
`rgb.update` (six Adam groups, the parking, the densification statistics).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from gags_torch import resolve_device
from gags_torch.core.sh import sh_colors
from gags_torch.rgb import kernels as rgb_kernels
from gags_torch.rgb.kernels import photometric_loss
from gags_torch.scene.densify import (densify_masks, reset_opacity_raw, split_means,
                                      split_scales_raw)
from gags_torch.scene.gaussian_data import GaussianScene
from gags_torch.splat.rasterizer import RasterizeConfig, rasterize
from gags_torch.utils import tracing

DEAD_Z = -1.0e9  # parked slots sit far behind every camera, so they are culled
GROUPS = ("means", "sh_dc", "sh_rest", "opacities_raw", "scales_raw", "quats")


@dataclasses.dataclass(frozen=True)
class RgbConfig:
    capacity_factor: int = 4       # slots = factor * initial N
    sh_degree: int = 3
    lambda_dssim: float = 0.2
    # learning rates (3DGS defaults, arguments/__init__.py:83-93)
    position_lr_init: float = 1.6e-4
    position_lr_final: float = 1.6e-6
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 2.5e-3
    opacity_lr: float = 0.05
    scaling_lr: float = 5e-3
    rotation_lr: float = 1e-3
    # densification (arguments/__init__.py:87-93)
    percent_dense: float = 0.01
    densify_grad_threshold: float = 2e-4
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densification_interval: int = 100
    opacity_reset_interval: int = 3_000
    min_opacity: float = 0.005
    raster: RasterizeConfig = RasterizeConfig(geometry_grads=True)


@dataclasses.dataclass
class RgbState:
    step: int
    params: Dict[str, torch.Tensor]  # the Adam groups (GROUPS), each (cap, ...)
    alive: torch.Tensor              # (cap,) bool
    grad_accum: torch.Tensor         # (cap,) screen-space grad-norm accumulator
    denom: torch.Tensor              # (cap,) views that saw the slot
    max_radii: torch.Tensor          # (cap,)
    opt: Dict[str, Dict[str, torch.Tensor]]  # per group {"mu", "nu"}
    generator: torch.Generator       # the split noise of densify_step

    @property
    def capacity(self) -> int:
        return self.params["means"].shape[0]

    @property
    def means(self) -> torch.Tensor:
        return self.params["means"]

    @property
    def sh(self) -> torch.Tensor:  # (cap, K, 3), dc first
        return torch.cat([self.params["sh_dc"], self.params["sh_rest"]], dim=1)

    @property
    def opacities_raw(self) -> torch.Tensor:
        return self.params["opacities_raw"]

    @property
    def scales_raw(self) -> torch.Tensor:
        return self.params["scales_raw"]

    @property
    def quats(self) -> torch.Tensor:
        return self.params["quats"]


def expon_lr(step, lr_init, lr_final, delay_mult, max_steps) -> float:
    """3DGS exponential schedule (reference general_utils.py:29-62), in
    float32 as the JAX package computes it."""
    f32 = torch.float32
    t = torch.clamp(torch.tensor(step, dtype=f32) / max_steps, 0.0, 1.0)
    log_lerp = torch.exp(torch.log(torch.tensor(lr_init, dtype=f32)) * (1 - t)
                         + torch.log(torch.tensor(lr_final, dtype=f32)) * t)
    delay = delay_mult + (1 - delay_mult) * torch.sin(0.5 * math.pi * t)
    return float(delay * log_lerp)


def _park(means: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    # filled on the device: a value copied from the host would sync the stream
    parked = means.new_full((3,), DEAD_Z)
    parked[:2].zero_()
    return torch.where(alive[:, None], means, parked)


def create_rgb_state(scene: GaussianScene, cfg: RgbConfig, seed: int = 0,
                     device="cuda") -> RgbState:
    """Fixed-capacity state from an initial scene (e.g. the SfM seed cloud)
    on `device` (default "cuda"; raises when CUDA is absent)."""
    dev = resolve_device(device)
    n = scene.num_gaussians
    cap = n * cfg.capacity_factor
    k = (cfg.sh_degree + 1) ** 2

    def pad(x, fill=0.0):
        x = x.to(device=dev, dtype=torch.float32)
        out = torch.full((cap,) + tuple(x.shape[1:]), fill, dtype=torch.float32, device=dev)
        out[:n] = x
        return out

    alive = torch.arange(cap, device=dev) < n
    sh = torch.zeros((cap, k, 3), dtype=torch.float32, device=dev)
    src = scene.sh[:, :k].to(dev)
    sh[:n, :src.shape[1]] = src
    quats = pad(scene.quats)
    quats[n:, 0] = 1.0
    params = dict(
        means=_park(pad(scene.means), alive),
        sh_dc=sh[:, :1].contiguous(),
        sh_rest=sh[:, 1:].contiguous(),
        opacities_raw=pad(scene.opacities_raw),
        scales_raw=pad(scene.scales_raw, fill=-10.0),
        quats=quats,
    )
    zeros = lambda: torch.zeros((cap,), dtype=torch.float32, device=dev)  # noqa: E731
    return RgbState(
        step=0, params=params, alive=alive, grad_accum=zeros(), denom=zeros(),
        max_radii=zeros(),
        opt={g: dict(mu=torch.zeros_like(p), nu=torch.zeros_like(p)) for g, p in params.items()},
        generator=torch.Generator(device=dev).manual_seed(seed),
    )


@torch.no_grad()
def _adam_update(p, g, m, lr, step, b1=0.9, b2=0.999, eps=1e-15):
    """JAX's `_adam_update`, in place: bias correction from the global
    step, eps 1e-15 (outside the square root). The corrections are float32
    scalars computed on the host (a tensor copied to the card would
    synchronise the stream)."""
    m["mu"].copy_(b1 * m["mu"] + (1 - b1) * g)
    m["nu"].copy_(b2 * m["nu"] + (1 - b2) * g * g)
    t = np.float32(step + 1.0)
    mu_hat = m["mu"] / float(np.float32(1) - np.float32(b1) ** t)
    nu_hat = m["nu"] / float(np.float32(1) - np.float32(b2) ** t)
    p.copy_(p - lr * mu_hat / (torch.sqrt(nu_hat) + eps))


@torch.no_grad()
def _update_plain(state: RgbState, grads: Dict[str, torch.Tensor], lrs: Dict[str, float],
                  g_m2d: torch.Tensor, radii: torch.Tensor, width: int, height: int) -> None:
    """`_update` as the eager chain (J5's plain version), on any device."""
    for k, p in state.params.items():
        _adam_update(p, grads[k], state.opt[k], lrs[k], state.step)
    alive = state.alive
    state.params["means"].copy_(_park(state.params["means"], alive))
    # screen-space positional gradient, scaled by (W/2, H/2) before the
    # norm as the reference does (gaussian_model.py:476-482): the 2e-4
    # threshold is calibrated in those units
    g2d = torch.linalg.norm(torch.stack([g_m2d[:, 0] * (width * 0.5),
                                         g_m2d[:, 1] * (height * 0.5)], dim=-1), dim=-1)
    vis = radii > 0
    state.grad_accum += torch.where(vis, g2d, torch.zeros_like(g2d))
    state.denom += vis.to(torch.float32)
    torch.maximum(state.max_radii, radii.to(torch.float32), out=state.max_radii)


@torch.no_grad()
def _update(state: RgbState, grads: Dict[str, torch.Tensor], lrs: Dict[str, float],
            g_m2d: torch.Tensor, radii: torch.Tensor, width: int, height: int) -> None:
    """The step's update in place: Adam on every group (`_adam_update`),
    dead slots' means parked, the densification statistics. CUDA: one
    launch of J5, bit for bit `_update_plain` on the card; CPU:
    `_update_plain`."""
    if state.means.device.type == "cpu":
        _update_plain(state, grads, lrs, g_m2d, radii, width, height)
        return
    rgb_kernels.adam_update(
        [state.params[k] for k in GROUPS], [grads[k] for k in GROUPS],
        [state.opt[k] for k in GROUPS], [lrs[k] for k in GROUPS], state.step,
        alive=state.alive, dead_z=DEAD_Z,
        stats=(g_m2d, radii, width, height, state.grad_accum, state.denom, state.max_radii))


def make_rgb_step(cfg: RgbConfig, width: int, height: int, spatial_scale: float):
    """The photometric step: render RGB → L1 + λ (1 − SSIM) → backward →
    Adam, plus the densification statistics (the reference's
    add_densification_stats).

    step(state, batch, xyz_lr, sh_degree) → (state, metrics); batch holds
    viewmat (4, 4), K (3, 3) and image (H, W, 3) on the state's device.
    The metrics are device tensors (loss, n_alive): reading them is the
    caller's host sync. `spatial_scale` is unused, as in the JAX package.

    cuDNN runs float32 convolutions (SSIM's filter) in TF32 unless told
    otherwise; this sets `torch.backends.cudnn.allow_tf32 = False` for the
    process, so the loss is float32 as on the CPU.
    """
    del spatial_scale
    torch.backends.cudnn.allow_tf32 = False
    lam = cfg.lambda_dssim

    def loss_fn(params, tap, batch, sh_degree):
        sh = torch.cat([params["sh_dc"], params["sh_rest"]], dim=1)
        vm = batch["viewmat"]
        campos = -vm[:3, :3].T @ vm[:3, 3]
        colors = sh_colors(sh_degree, sh, params["means"], campos)
        res = rasterize(
            params["means"], params["quats"], torch.exp(params["scales_raw"]),
            torch.sigmoid(params["opacities_raw"]), colors, vm, batch["K"], width, height,
            background=torch.zeros((3,), dtype=torch.float32, device=vm.device),
            config=cfg.raster, means2d_tap=tap, device=vm.device)
        return photometric_loss(res.image, batch["image"], lam), res.radii

    def step(state: RgbState, batch, xyz_lr: float, sh_degree: int) -> Tuple[RgbState, dict]:
        with tracing.span("rgb.step"):
            leaves = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
            tap = torch.zeros((state.capacity, 2), dtype=torch.float32,
                              device=state.means.device, requires_grad=True)
            with tracing.span("rgb.forward"):
                loss, radii = loss_fn(leaves, tap, batch, sh_degree)
            with tracing.span("rgb.backward"):
                loss.backward()
            lrs = dict(means=xyz_lr, sh_dc=cfg.feature_lr, sh_rest=cfg.feature_lr / 20.0,
                       opacities_raw=cfg.opacity_lr, scales_raw=cfg.scaling_lr,
                       quats=cfg.rotation_lr)
            with tracing.span("rgb.update"):
                _update(state, {k: leaves[k].grad for k in GROUPS}, lrs, tap.grad, radii, width,
                        height)
            state.step += 1
            return state, dict(loss=loss.detach(), n_alive=torch.sum(state.alive))

    return step


@torch.no_grad()
def densify_step(state: RgbState, grad_threshold: float, percent_dense: float,
                 scene_extent: float, min_opacity: float,
                 noise: Optional[Tuple] = None) -> RgbState:
    """Fixed-capacity adaptive density control: clone, split and prune
    (gaussian_model.py:415-468, with slot recycling).

    Under-reconstructed small Gaussians clone into free slots, in slot
    order; large ones split into two samples (scales / 1.6) and the parent
    is parked; transparent Gaussians are parked. Every slot written gets
    zero Adam moments. The split samples are unit normals (cap, 3) drawn
    from the state's generator, or `noise` = (a, b), two such arrays
    given by the caller (e.g. the JAX package's, for a test). Runs on the
    device without a host sync."""
    cap = state.capacity
    dev = state.means.device
    p = state.params
    grads = torch.where(state.denom > 0, state.grad_accum / state.denom,
                        torch.zeros_like(state.denom))
    scales = torch.exp(p["scales_raw"])
    max_scale = torch.max(scales, dim=-1).values
    alive = state.alive

    sel_clone, sel_split = (m & alive for m in densify_masks(
        grads, max_scale, grad_threshold, scene_extent, percent_dense))

    # destinations: the free slots in order; sources: the clones first, then
    # two children of each split parent
    n_free = torch.sum(~alive)
    n_clone = torch.sum(sel_clone)
    clone_rank = torch.where(sel_clone, torch.cumsum(sel_clone, 0) - 1, -1)
    split_rank = torch.where(sel_split, torch.cumsum(sel_split, 0) - 1, -1)
    # the free slots first, in slot order (a stable sort, no host sync)
    free_idx = torch.argsort(alive.to(torch.int8), stable=True)

    def place(dst_rank, src_mask):
        """Destination slot of each source (cap = dropped: no room)."""
        ok = src_mask & (dst_rank >= 0) & (dst_rank < n_free)
        return torch.where(ok, free_idx[torch.clamp(dst_rank, 0, cap - 1)], cap)

    dst_c = place(clone_rank, sel_clone)
    dst_a = place(n_clone + 2 * split_rank, sel_split)
    dst_b = place(n_clone + 2 * split_rank + 1, sel_split)

    if noise is None:
        noise = [torch.randn((cap, 3), generator=state.generator, device=dev) for _ in range(2)]
    noise_a, noise_b = (torch.as_tensor(x, dtype=torch.float32).to(dev) for x in noise)
    child_a = split_means(p["means"], p["quats"], scales, noise_a)
    child_b = split_means(p["means"], p["quats"], scales, noise_b)
    child_scales_raw = split_scales_raw(p["scales_raw"], 2)

    def scatter_all(arr, vc, va, vb):
        """arr with rows dst_c ← vc, dst_a ← va, dst_b ← vb; index cap drops."""
        ext = torch.cat([arr, arr[:1]])
        ext[dst_c] = vc
        ext[dst_a] = va
        ext[dst_b] = vb
        return ext[:cap]

    new = {k: scatter_all(v, v, v, v) for k, v in p.items() if k not in ("means", "scales_raw")}
    new["means"] = scatter_all(p["means"], p["means"], child_a, child_b)
    new["scales_raw"] = scatter_all(p["scales_raw"], p["scales_raw"], child_scales_raw,
                                    child_scales_raw)

    used = torch.zeros((cap + 1,), dtype=torch.bool, device=dev)
    used[dst_c] = True
    used[dst_a] = True
    used[dst_b] = True
    new_alive = (alive | used[:cap]) & ~sel_split  # split parents die
    new_alive &= ~(alive & (torch.sigmoid(new["opacities_raw"]) < min_opacity))
    new["means"] = _park(new["means"], new_alive)

    for k, v in new.items():
        p[k].copy_(v)
        for m in state.opt[k].values():
            zeroed = torch.cat([m, m[:1]])
            zeroed[dst_c] = 0.0
            zeroed[dst_a] = 0.0
            zeroed[dst_b] = 0.0
            m.copy_(zeroed[:cap])
    state.alive.copy_(new_alive)
    state.grad_accum.zero_()
    state.denom.zero_()
    state.max_radii.zero_()
    return state


@torch.no_grad()
def reset_opacity_step(state: RgbState, ceiling: float = 0.01) -> RgbState:
    """Clamp every opacity down to `ceiling` (gaussian_model.py:261-264)."""
    state.params["opacities_raw"].copy_(
        reset_opacity_raw(torch.sigmoid(state.params["opacities_raw"]), ceiling))
    return state


def to_scene(state: RgbState, sh_degree: int, feature_dim: int = 16) -> GaussianScene:
    """The alive Gaussians as a GaussianScene (zero semantic features)."""
    idx = torch.nonzero(state.alive)[:, 0]
    return GaussianScene(
        means=state.means[idx].detach().clone(),
        sh=state.sh[idx],
        opacities_raw=state.opacities_raw[idx].detach().clone(),
        scales_raw=state.scales_raw[idx].detach().clone(),
        quats=state.quats[idx].detach().clone(),
        semantic_features=torch.zeros((len(idx), feature_dim), dtype=torch.float32,
                                      device=state.means.device),
        max_sh_degree=sh_degree,
    )
