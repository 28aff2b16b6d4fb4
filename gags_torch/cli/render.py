"""Rendering CLI (port of gags_tpu.cli.render, the reference `render.py`).

Modes:
  * RGB, or "RGB+ED" (also saves <name>_depth.npy and a turbo depth PNG),
    at the cameras' resolution scaled by -r;
  * --feature_mode: renders the semantic feature maps and saves their PCA
    visualisation and, when the model dir holds a GAD checkpoint, the scale
    map its scale decoder gives; --feature_npy also saves the raw maps as
    (C, H, W) .npy.

The inference binning is unaligned; the config is the persisted autotune
winner for this shape when one exists (exact variants only), or with
--autotune the fastest variant timed on the card now (splat/autotune.py)
over a base that, as in JAX, has bf16 colour rows (`fast_color_rows`) in
feature mode and f32 rows in RGB mode: with --autotune the feature maps
carry the rows' bf16 rounding. Frame i+1 is rendered on the card while frame i's
PNGs are encoded on the host. PNGs are written with utils.image.encode_png.

Usage:
  python -m gags_torch.cli.render -m <model_dir> -s <scene_dir> \
      --iteration 30000 [--feature_mode [--feature_npy]] [--render_mode RGB+ED] \
      [-r 1] [--skip_train] [--skip_test] [--eval] [--autotune] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from gags_torch import resolve_device
from gags_torch.scene.dataset import camera_from_info, detect_and_load
from gags_torch.scene.gaussian_data import GaussianScene
from gags_torch.splat.autotune import autotune_config, load_persisted
from gags_torch.splat.rasterizer import RasterizeConfig
from gags_torch.splat.render import render
from gags_torch.utils.colormaps import apply_depth_colormap, apply_pca_colormap
from gags_torch.utils.image import encode_png


def _save_png(path: str, img: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(img))


def _ensure(path: str) -> str:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    return path


def _to_host(tensors):
    """Start the copies of `tensors` to the host without waiting: pinned
    buffers and an event on the card, the tensors themselves on the CPU.
    Returns (host tensors, event or None)."""
    if not tensors[0].is_cuda:
        return tensors, None
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


def render_config(scene: GaussianScene, cam0, feature_mode: bool, autotune: bool,
                  device, timings: Optional[dict] = None) -> RasterizeConfig:
    """The inference config of a render run: the autotuned variant
    (--autotune; bf16 colour rows in feature mode), else the persisted
    winner of this shape, else the default unaligned config."""
    c = scene.semantic_features.shape[1] if feature_mode else 3
    n = scene.num_gaussians
    if autotune:
        colors = (scene.semantic_features if feature_mode else torch.as_tensor(
            np.random.default_rng(0).uniform(0, 1, (n, 3)).astype(np.float32), device=device))
        return autotune_config(
            scene.means, scene.quats, scene.scales, scene.opacities, colors,
            cam0.viewmat, cam0.K, cam0.width, cam0.height,
            base=RasterizeConfig(aligned=False, fast_color_rows=feature_mode),
            verbose=True, timings=timings, device=device)
    tuned = load_persisted(cam0.width, cam0.height, n, c)
    if tuned is not None:
        print("# render: persisted tuned config reused", flush=True)
        return tuned
    return RasterizeConfig(aligned=False)


def render_set(model_dir: str, split: str, iteration: int, cam_infos, scene: GaussianScene,
               feature_mode: bool, feature_npy: bool, render_mode: str, resolution: int,
               scale_decoder=None, autotune: bool = False, device="cuda") -> dict:
    """Render and save every camera of one split; returns {frames,
    seconds, frames_per_s, config, autotune} (seconds from the first
    dispatch to the last file written)."""
    dev = resolve_device(device)
    base = os.path.join(model_dir, split, f"ours_{iteration}")
    report = dict(frames=len(cam_infos), autotune={})
    if not cam_infos:
        return report
    cfg = render_config(scene, camera_from_info(cam_infos[0], resolution), feature_mode,
                        autotune, dev, timings=report["autotune"])
    report["config"] = dataclasses.asdict(cfg)
    zeros3 = torch.zeros((3,), dtype=torch.float32, device=dev)
    geo = dict(means=scene.means, quats=scene.quats, scales=scene.scales,
               opacities=scene.opacities, config=cfg, device=dev)
    pca_proj = None

    def dispatch(info):
        """Enqueue one camera's render and its copies to the host; the
        host work on the previous frame overlaps them."""
        cam = camera_from_info(info, resolution)
        name = os.path.splitext(info.name)[0]
        if feature_mode:
            out = render(cam, **geo, semantic_features=scene.semantic_features,
                         feature_mode=True, bg_color=zeros3).render
            maps = [out] if scale_decoder is None else [out, scale_decoder(out)]
        else:
            maps = [render(cam, **geo, sh=scene.sh, sh_degree=scene.max_sh_degree,
                           render_mode=render_mode, bg_color=zeros3).render]
        return name, _to_host(maps)

    def consume(name, pending):
        nonlocal pca_proj
        maps, ev = pending
        if ev is not None:
            ev.synchronize()
        maps = [m.numpy() for m in maps]
        if feature_mode:
            fmap = maps[0]
            if feature_npy:
                # the reference saves (C, H, W)
                np.save(_ensure(os.path.join(base, "saved_feature", name + "_fmap_CxHxW.npy")),
                        fmap.transpose(2, 0, 1))
            rgb, pca_proj = apply_pca_colormap(fmap, pca_proj)
            _save_png(os.path.join(base, "feature_pca", name + ".png"), rgb)
            if len(maps) > 1:
                _save_png(os.path.join(base, "scale_map", name + ".png"), maps[1])
        else:
            img = maps[0]
            if render_mode == "RGB+ED":
                depth = img[..., 3]
                img = img[..., :3]
                np.save(_ensure(os.path.join(base, "depth", name + "_depth.npy")), depth)
                _save_png(os.path.join(base, "depth", name + "_depth.png"),
                          apply_depth_colormap(depth))
            _save_png(os.path.join(base, "renders", name + ".png"), img)

    t0 = time.perf_counter()
    pending = None
    with torch.no_grad():
        for info in cam_infos:
            nxt = dispatch(info)
            if pending is not None:
                consume(*pending)
            pending = nxt
        consume(*pending)
    report["seconds"] = time.perf_counter() - t0
    report["frames_per_s"] = len(cam_infos) / report["seconds"]
    return report


def load_scale_decoder(model_path: str, scene: GaussianScene, device):
    """The scale decoder of the latest GAD checkpoint in `model_path`, or
    None where there is none."""
    from gags_torch.gad.checkpoints import latest_checkpoint_step, load_checkpoint
    from gags_torch.gad.train import GadConfig, create_train_state

    step = latest_checkpoint_step(model_path)
    if step is None:
        return None
    cfg = GadConfig.load(model_path, feature_dim=scene.semantic_features.shape[1])
    state = create_train_state(scene, cfg, device=device)
    return load_checkpoint(model_path, step, state).scale_decoder.eval()


def run(model_path: str, source_path: str, iteration: int = 30000, *,
        feature_mode: bool = False, feature_npy: bool = False, render_mode: str = "RGB",
        resolution: int = -1, skip_train: bool = False, skip_test: bool = False,
        eval_split: bool = False, autotune: bool = False, device="cuda") -> dict:
    """Render the model dir's snapshot point_cloud/iteration_<iteration>
    for the train and test cameras of `source_path`; returns {split:
    render_set's report}."""
    if feature_mode and render_mode == "RGB+ED":
        raise ValueError("feature mode and expected depth are mutually exclusive")
    dev = resolve_device(device)
    info = detect_and_load(source_path, eval_split=eval_split, foundation_model="none")
    ply = os.path.join(model_path, "point_cloud", f"iteration_{iteration}", "point_cloud.ply")
    scene = GaussianScene.from_ply(ply, device=dev)
    scale_decoder = None
    if feature_mode:
        if scene.semantic_features is None:
            raise ValueError(f"{ply}: feature mode needs semantic_* fields")
        scale_decoder = load_scale_decoder(model_path, scene, dev)
    args = (scene, feature_mode, feature_npy, render_mode, resolution, scale_decoder, autotune,
            dev)
    out = {}
    if not skip_train:
        out["train"] = render_set(model_path, "train", iteration, info.train_cameras, *args)
    if not skip_test and info.test_cameras:
        out["test"] = render_set(model_path, "test", iteration, info.test_cameras, *args)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-m", "--model_path", required=True)
    p.add_argument("-s", "--source_path", required=True)
    p.add_argument("--iteration", type=int, default=30000)
    p.add_argument("--feature_mode", action="store_true")
    p.add_argument("--feature_npy", action="store_true")
    p.add_argument("--render_mode", default="RGB", choices=["RGB", "RGB+ED"])
    p.add_argument("-r", "--resolution", type=int, default=-1)
    p.add_argument("--skip_train", action="store_true")
    p.add_argument("--skip_test", action="store_true")
    p.add_argument("--eval", dest="eval_split", action="store_true")
    p.add_argument("--autotune", action="store_true",
                   help="time the exact kernel variants on the card and render with the "
                        "fastest (gags_torch.splat.autotune); feature mode starts from "
                        "bf16 colour rows")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    reports = run(a.model_path, a.source_path, a.iteration, feature_mode=a.feature_mode,
                  feature_npy=a.feature_npy, render_mode=a.render_mode,
                  resolution=a.resolution, skip_train=a.skip_train, skip_test=a.skip_test,
                  eval_split=a.eval_split, autotune=a.autotune, device=a.device)
    for split, r in reports.items():
        if r.get("seconds"):
            print(f"{split}: {r['frames']} frames in {r['seconds']:.2f} s "
                  f"({r['frames_per_s']:.2f} frames/s)", flush=True)


if __name__ == "__main__":
    main()
