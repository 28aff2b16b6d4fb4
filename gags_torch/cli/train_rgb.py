"""RGB 3DGS pretraining CLI (port of gags_tpu.cli.train_rgb): the stage
that makes the pretrained scene GAS and GAD start from.

Usage:
  python -m gags_torch.cli.train_rgb -s <scene_dir> -m <model_dir> \\
      [--iterations 30000] [-r -1] [--device cpu]

The scene dir holds a COLMAP (or Blender) reconstruction with its images
and the SfM seed cloud (`sparse/0/points3D.ply`, written from
points3D.bin/.txt when absent). Gaussians start from the seed cloud
(3-NN scales) in a fixed-capacity state, then train with L1 + SSIM,
per-group Adam and clone / split / prune on the device (default "cuda";
"cpu" runs the kernels' plain versions). At each save iteration it writes
the reference-layout `point_cloud/iteration_N/point_cloud.ply`, which
`GaussianScene.from_ply` and `gags_torch.cli.train_gad --ply` read.
Images are read with the port's PNG decoder when they are PNGs of the
camera's size; other images need PIL (see `utils.image.load_rgb`).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Callable, Optional

import numpy as np
import torch

from gags_torch import resolve_device
from gags_torch.rgb.train import (
    RgbConfig,
    RgbState,
    create_rgb_state,
    densify_step,
    expon_lr,
    make_rgb_step,
    reset_opacity_step,
    to_scene,
)
from gags_torch.scene.dataset import camera_from_info, detect_and_load
from gags_torch.scene.gaussian_data import GaussianScene
from gags_torch.scene.ply import read_points3d_ply
from gags_torch.utils.image import load_rgb
from gags_torch.utils.logging import EmaProgress, MetricsWriter


@dataclasses.dataclass(frozen=True)
class RunConfig:
    source_path: str = ""
    model_path: str = ""
    resolution: int = -1
    iterations: int = 30000
    save_iterations: str = "7000,30000"
    capacity_factor: int = 4
    sh_degree: int = 3
    seed: int = 0
    device: str = "cuda"


def run(rc: RunConfig, rgb_cfg: Optional[RgbConfig] = None,
        on_step: Optional[Callable[[int, RgbState, Optional[dict]], None]] = None) -> RgbState:
    """Train; returns the final state. `rgb_cfg` (default RgbConfig())
    takes its capacity factor and SH degree from `rc`. `on_step(it, state,
    metrics)`, if given, observes the loop: it is called with 0 and metrics
    None just before the first step, then after every step (before that
    iteration's densification) with its metrics."""
    dev = resolve_device(rc.device)
    cfg = dataclasses.replace(rgb_cfg or RgbConfig(), capacity_factor=rc.capacity_factor,
                              sh_degree=rc.sh_degree)
    os.makedirs(rc.model_path, exist_ok=True)
    info = detect_and_load(rc.source_path, foundation_model="none")
    if not info.points_path:
        raise SystemExit(f"{rc.source_path}: no SfM seed cloud (sparse/0/points3D.*)")
    xyz, rgb, _ = read_points3d_ply(info.points_path)
    print(f"{len(xyz)} seed points, {len(info.train_cameras)} cameras, "
          f"scene radius {info.radius:.2f}")
    seed_scene = GaussianScene.from_point_cloud(xyz, rgb, max_sh_degree=rc.sh_degree,
                                                feature_dim=0, device=dev)
    state = create_rgb_state(seed_scene, cfg, seed=rc.seed, device=dev)

    cams, images = [], []
    for ci in info.train_cameras:
        cam = camera_from_info(ci, rc.resolution).to(dev)
        cams.append(cam)
        # kept as 8-bit on the device; the step reads img / 255 in float32
        images.append(torch.as_tensor(load_rgb(ci.image_path, cam.width, cam.height),
                                      device=dev))
    w, h = cams[0].width, cams[0].height
    step = make_rgb_step(cfg, w, h, spatial_scale=info.radius)

    rng = np.random.default_rng(rc.seed)
    save_at = {int(s) for s in rc.save_iterations.split(",") if s}
    save_at.add(rc.iterations)
    metrics_w = MetricsWriter(rc.model_path)
    progress = EmaProgress(rc.iterations)
    order: list = []
    if on_step is not None:
        on_step(0, state, None)
    try:
        for it in range(1, rc.iterations + 1):
            if not order:
                order = list(rng.permutation(len(cams)))
            idx = order.pop()
            batch = dict(viewmat=cams[idx].viewmat, K=cams[idx].K,
                         image=images[idx].to(torch.float32) / 255.0)
            lr = expon_lr(float(it), cfg.position_lr_init * info.radius,
                          cfg.position_lr_final * info.radius, cfg.position_lr_delay_mult,
                          cfg.position_lr_max_steps)
            state, m = step(state, batch, lr, min(it // 1000, rc.sh_degree))
            if on_step is not None:
                on_step(it, state, m)

            if cfg.densify_from_iter < it < cfg.densify_until_iter:
                if it % cfg.densification_interval == 0:
                    before = int(state.alive.sum())
                    state = densify_step(state, cfg.densify_grad_threshold, cfg.percent_dense,
                                         info.radius, cfg.min_opacity)
                    print(f"\n[iter {it}] densify: {before} -> {int(state.alive.sum())} alive "
                          f"of {state.capacity} slots")
                if it % cfg.opacity_reset_interval == 0:
                    state = reset_opacity_step(state)

            if it % 10 == 0:
                loss = float(m["loss"])  # a host sync every 10 iterations only
                if not np.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at iteration {it}")
                progress.update(it, loss)
            if it % 500 == 0:
                metrics_w.write(it, dict(loss=float(m["loss"]), n_alive=int(m["n_alive"])))
            if it in save_at:
                scene = to_scene(state, rc.sh_degree)
                out = os.path.join(rc.model_path, "point_cloud", f"iteration_{it}",
                                   "point_cloud.ply")
                scene.save_ply(out)
                print(f"\n[iter {it}] saved {scene.num_gaussians} gaussians -> {out}")
    finally:
        metrics_w.close()
    return state


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-s", "--source_path", required=True)
    p.add_argument("-m", "--model_path", required=True)
    p.add_argument("-r", "--resolution", type=int, default=-1)
    p.add_argument("--iterations", type=int, default=30000)
    p.add_argument("--save_iterations", default="7000,30000")
    p.add_argument("--capacity_factor", type=int, default=4)
    p.add_argument("--sh_degree", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    run(RunConfig(**vars(p.parse_args(argv))))


if __name__ == "__main__":
    main()
