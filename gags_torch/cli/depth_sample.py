"""GAS stage B CLI: per-image min-depth samples (port of
gags_tpu.cli.depth_sample, the reference's `depth_SAM.py`).

Reads the depth maps the render CLI writes (`--render_mode RGB+ED`),
projects every Gaussian into every camera with the occlusion test, takes
each point's minimum depth over the cameras and splats it back into
`depths_sample/<img>_depth_sample.npy` maps in the scene dir.

  python -m gags_torch.cli.depth_sample -s <scene> -m <model_dir> \
      --iteration 30000 [-r -1] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from gags_torch import resolve_device
from gags_torch.gas.depth_sampler import min_depth_over_cameras, splat_depth_samples
from gags_torch.scene.dataset import camera_from_info, detect_and_load
from gags_torch.scene.gaussian_data import GaussianScene


def run(source_path: str, model_path: str, iteration: int = 30000, resolution: int = -1,
        vis_thres: float = 0.25, device="cuda") -> dict:
    """Write the depth-sample maps of every training camera; returns {maps,
    out_dir, seconds, visible: per-camera count of visible Gaussians}."""
    dev = resolve_device(device)
    info = detect_and_load(source_path, foundation_model="none")
    ply = os.path.join(model_path, "point_cloud", f"iteration_{iteration}", "point_cloud.ply")
    scene = GaussianScene.from_ply(ply, device=dev)
    depth_dir = os.path.join(model_path, "train", f"ours_{iteration}", "depth")
    out_dir = os.path.join(source_path, "depths_sample")
    os.makedirs(out_dir, exist_ok=True)

    cams, depths = [], []
    for ci in info.train_cameras:
        name = os.path.splitext(ci.name)[0]
        dpath = os.path.join(depth_dir, name + "_depth.npy")
        if not os.path.exists(dpath):
            raise FileNotFoundError(
                f"{dpath} missing: run the render CLI with --render_mode RGB+ED first")
        d = np.load(dpath)
        cam = camera_from_info(ci, resolution)
        if d.shape != (cam.height, cam.width):
            raise ValueError(f"{name}: depth {d.shape} vs camera {cam.height, cam.width}")
        cams.append(cam)
        depths.append(d)

    t0 = time.perf_counter()
    viewmats = torch.stack([c.viewmat for c in cams]).to(dev)
    Ks = torch.stack([c.K for c in cams]).to(dev)
    dmaps = torch.as_tensor(np.stack(depths), dtype=torch.float32, device=dev)
    mind, vis, uv = min_depth_over_cameras(scene.means, viewmats, Ks, dmaps, vis_thres=vis_thres)
    for i, (ci, cam) in enumerate(zip(info.train_cameras, cams)):
        m = splat_depth_samples(mind, vis[:, i], uv[:, i], cam.height, cam.width)
        name = os.path.splitext(ci.name)[0]
        np.save(os.path.join(out_dir, name + "_depth_sample.npy"), m.cpu().numpy())
    return dict(maps=len(cams), out_dir=out_dir, seconds=time.perf_counter() - t0,
                visible=vis.sum(0).tolist())


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-s", "--source_path", required=True)
    p.add_argument("-m", "--model_path", required=True)
    p.add_argument("--iteration", type=int, default=30000)
    p.add_argument("-r", "--resolution", type=int, default=-1)
    p.add_argument("--vis_thres", type=float, default=0.25)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    r = run(a.source_path, a.model_path, a.iteration, a.resolution, a.vis_thres, a.device)
    print(f"wrote {r['maps']} depth-sample maps to {r['out_dir']}")


if __name__ == "__main__":
    main()
