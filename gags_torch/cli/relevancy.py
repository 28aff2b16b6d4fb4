"""Text-query relevancy CLI (port of gags_tpu.cli.relevancy, the
reference `compute_relvancy.py`).

Modes:
  --image_mode (default): per training camera (or, with --video, per
    frame of a B-spline path through them), render the feature map,
    decode it, and write per prompt a turbo heat map, the thresholded and
    majority-smoothed mask and their composite as PNGs under
    <model>/relevancy/{heatmap,mask,composited}/<label>/, and with
    --video an mp4 per label (needs cv2; without it the PNGs stand).
    Frame i+1 renders on the card while frame i's PNGs are encoded.
  --pcd_mode: per-Gaussian relevancy → a thresholded, neighbour-smoothed
    3D selection, written as a recoloured point PLY per prompt under
    <model>/relevancy_pcd/.

The model directory is read by one rule, shared with the evaluate and
edit CLIs (`load_query_model`): the PLY of --iteration and decoders.pt
(as the server reads them); where a GAD checkpoint chkpnt<N>/state.pt
exists, the features and the feature decoder come from the newest one.
Text embeddings: an npz with 'labels', 'pos' and 'neg' (cli/encode_text).

  python -m gags_torch.cli.relevancy -m <model> -s <scene> --iteration N \
      --text_embeds e.npz [--image_mode -r 1 [--video --video_frames 8]] \
      [--pcd_mode [--no_smooth]] [--autotune] [--device cuda]
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
from gags_torch.cli.render import _to_host
from gags_torch.core.sh import sh_to_rgb
from gags_torch.gad.checkpoints import STATE_FILE, latest_checkpoint_step
from gags_torch.gad.train import GadConfig
from gags_torch.knn.knn import knn_with_indices
from gags_torch.models.decoders import feature_decoder_from_state
from gags_torch.models.weights import load_decoder_state
from gags_torch.query.grounding import (
    decode_features_chunked,
    decode_map_rows,
    point_relevancy,
    select_gaussians,
    vote_mask,
)
from gags_torch.query.relevancy import heatmap_to_mask, majority_smooth, max_across_levels
from gags_torch.scene.dataset import camera_from_info, detect_and_load
from gags_torch.scene.gaussian_data import GaussianScene
from gags_torch.scene.ply import write_points3d_ply
from gags_torch.splat.autotune import autotune_config, load_persisted
from gags_torch.splat.rasterizer import RasterizeConfig
from gags_torch.splat.render import render
from gags_torch.utils.campath import interpolate_path, novel_camera
from gags_torch.utils.colormaps import turbo
from gags_torch.utils.image import encode_png


def _save_png(path: str, img: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(img))


def load_query_model(model_path: str, iteration: int, device):
    """(scene with its semantic features, feature decoder) on `device`:
    the PLY of `iteration` and decoders.pt, with the features and decoder
    of the newest GAD checkpoint where one exists."""
    ply = os.path.join(model_path, "point_cloud", f"iteration_{iteration}", "point_cloud.ply")
    scene = GaussianScene.from_ply(ply, device=device)
    step = latest_checkpoint_step(model_path)
    if step is not None:
        blob = torch.load(os.path.join(model_path, f"chkpnt{step}", STATE_FILE),
                          map_location=device, weights_only=True)
        features = blob["features"].to(torch.float32)
        return scene.with_features(features), feature_decoder_from_state(blob["decoder"], device)
    if scene.semantic_features is None:
        raise ValueError(f"{ply}: no semantic_* fields and no checkpoint in {model_path}")
    state = load_decoder_state(os.path.join(model_path, "decoders.pt"))["feature_decoder"]
    return scene, feature_decoder_from_state(state, device)


def load_text_embeds(path: str):
    """(labels, pos (L, D), neg (N, D)) of an encode_text npz."""
    data = np.load(path)
    return [str(l) for l in data["labels"]], data["pos"], data["neg"]


def inference_config(model_path: str) -> RasterizeConfig:
    """The model dir's rasterizer settings for the unaligned inference
    binning (no SAT, dummies or gradient layout)."""
    return dataclasses.replace(GadConfig.load(model_path).raster, aligned=False)


def relevancy_config(scene: GaussianScene, cam0, base: RasterizeConfig, autotune: bool,
                     device, timings: Optional[dict] = None) -> RasterizeConfig:
    """--autotune: the fastest variant timed on the card now; else the
    persisted winner of this shape (bf16 variants allowed: relevancy
    tolerates their contract, as in JAX); else `base`."""
    c = int(scene.semantic_features.shape[1])
    if autotune:
        return autotune_config(scene.means, scene.quats, scene.scales, scene.opacities,
                               scene.semantic_features, cam0.viewmat, cam0.K, cam0.width,
                               cam0.height, base=base, verbose=True, timings=timings,
                               device=device)
    tuned = load_persisted(cam0.width, cam0.height, scene.num_gaussians, c, allow_bf16=True)
    if tuned is not None:
        print("# relevancy: persisted tuned config reused", flush=True)
        return tuned
    return base


@torch.no_grad()
def relevancy_maps(scene: GaussianScene, decoder, cam, pos: torch.Tensor, neg: torch.Tensor,
                   thresh: float, raster: RasterizeConfig, device):
    """One camera's (P, H, W) smoothed masks (uint8) and averaged heat
    maps (float32), on `device`."""
    out = render(cam, means=scene.means, quats=scene.quats, scales=scene.scales,
                 opacities=scene.opacities, semantic_features=scene.semantic_features,
                 feature_mode=True, bg_color=torch.zeros((3,), device=device), config=raster,
                 device=device)
    rel = max_across_levels(decode_map_rows(decoder, out.render)[None], pos, neg)[0]
    masks, heats = [], []
    for k in range(rel.shape[0]):
        mask, vm = heatmap_to_mask(rel[k], thresh)
        masks.append(majority_smooth(mask))
        heats.append(vm)
    return torch.stack(masks), torch.stack(heats)


def image_mode(model_path: str, scene: GaussianScene, decoder, cams, text, thresh: float,
               raster: RasterizeConfig, video: bool, device) -> dict:
    """Heat maps, masks and composites of every camera and prompt; returns
    {frames, seconds, frames_per_s, videos (written mp4 paths)}."""
    labels, pos, neg = text
    pos_t = torch.as_tensor(np.asarray(pos, np.float32), device=device)
    neg_t = torch.as_tensor(np.asarray(neg, np.float32), device=device)
    out_dir = os.path.join(model_path, "relevancy")
    video_frames = {label: [] for label in labels} if video else None

    def dispatch(cam):
        return cam.name, _to_host(list(relevancy_maps(scene, decoder, cam, pos_t, neg_t, thresh,
                                                      raster, device)))

    def consume(name, pending):
        (masks, heats), ev = pending
        if ev is not None:
            ev.synchronize()
        masks, heats = masks.numpy(), heats.numpy()
        for k, label in enumerate(labels):
            mask = masks[k][..., None].astype(np.float32)
            heat = turbo(heats[k])
            comp = heat * mask + 0.3 * heat * (1 - mask)
            _save_png(os.path.join(out_dir, "heatmap", label, name + ".png"), heat)
            _save_png(os.path.join(out_dir, "mask", label, name + ".png"), mask.repeat(3, -1))
            _save_png(os.path.join(out_dir, "composited", label, name + ".png"), comp)
            if video_frames is not None:
                video_frames[label].append(comp)

    t0 = time.perf_counter()
    pending = None
    for cam in cams:
        nxt = dispatch(cam)
        if pending is not None:
            consume(*pending)
        pending = nxt
    if pending is not None:
        consume(*pending)
    seconds = time.perf_counter() - t0
    videos = []
    if video_frames is not None:
        from gags_torch.utils.video import write_video

        for label, frames in video_frames.items():
            path = os.path.join(out_dir, "video", f"{label}.mp4")
            if write_video(path, frames, fps=30):
                print(f"wrote {path} ({len(frames)} frames)")
                videos.append(path)
    return dict(frames=len(cams), seconds=seconds, frames_per_s=len(cams) / max(seconds, 1e-9),
                videos=videos)


@torch.no_grad()
def pcd_mode(model_path: str, scene: GaussianScene, decoder, text, thresh: float,
             smooth: bool, device, k: int = 32) -> dict:
    """A recoloured point PLY per prompt (selected Gaussians red, the rest
    their dc colour at a quarter); the neighbour vote of the smoothing
    shares one KNN search across the prompts. Returns {selected: {label:
    count}, masks: {label: (N,) bool}, seconds: {decode, relevancy, knn,
    select}}."""
    labels, pos, neg = text
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    decoded = decode_features_chunked(decoder, scene.semantic_features)
    sync()
    t1 = time.perf_counter()
    rel = point_relevancy(decoded, torch.as_tensor(np.asarray(pos, np.float32), device=device),
                          torch.as_tensor(np.asarray(neg, np.float32), device=device))
    sync()
    t2 = time.perf_counter()
    knn = knn_with_indices(scene.means, k) if smooth else None
    sync()
    t3 = time.perf_counter()
    base_rgb = sh_to_rgb(scene.sh[:, 0, :]).cpu().numpy()
    xyz = scene.means.cpu().numpy()
    selected, masks = {}, {}
    for i, label in enumerate(labels):
        mask = select_gaussians(rel, i, thresh, smooth=False)
        if knn is not None:
            mask = vote_mask(mask, *knn)
        mask = mask.cpu().numpy()
        rgb = base_rgb * 0.25
        rgb[mask] = [1.0, 0.1, 0.1]
        out = os.path.join(model_path, "relevancy_pcd", f"{label}.ply")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        write_points3d_ply(out, xyz, np.clip(rgb, 0, 1))
        selected[label], masks[label] = int(mask.sum()), mask
        print(f"{label}: {selected[label]} gaussians selected → {out}")
    t4 = time.perf_counter()
    return dict(selected=selected, masks=masks,
                seconds=dict(decode=t1 - t0, relevancy=t2 - t1, knn=t3 - t2, select=t4 - t3))


def run(model_path: str, source_path: str, iteration: int = 30000, *, text_embeds: str,
        thresh: float = 0.5, pcd: bool = False, video: bool = False, video_frames: int = 150,
        smooth: bool = True, resolution: int = 2, autotune: bool = False,
        device="cuda") -> dict:
    """Image (default) or pcd mode on the model dir; returns the mode's
    report (image mode adds the config and the autotune times)."""
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False  # decode and relevancy in full float32
    scene, decoder = load_query_model(model_path, iteration, dev)
    text = load_text_embeds(text_embeds)
    if pcd:
        return pcd_mode(model_path, scene, decoder, text, thresh, smooth, dev)
    info = detect_and_load(source_path, foundation_model="none")
    cams = [camera_from_info(ci, resolution) for ci in info.train_cameras]
    if video:
        viewmats = np.stack([c.viewmat.numpy() for c in cams])
        path = interpolate_path(np.linalg.inv(viewmats), video_frames)
        cams = [novel_camera(vm, cams[0], f"novel_{i:04d}") for i, vm in enumerate(path)]
    timings = {}
    raster = relevancy_config(scene, cams[0].to(dev), inference_config(model_path), autotune,
                              dev, timings)
    report = image_mode(model_path, scene, decoder, cams, text, thresh, raster, video, dev)
    report.update(config=dataclasses.asdict(raster), autotune=timings)
    return report


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-m", "--model_path", required=True)
    p.add_argument("-s", "--source_path", required=True)
    p.add_argument("--iteration", type=int, default=30000)
    p.add_argument("--text_embeds", required=True)
    p.add_argument("--thresh", type=float, default=0.5)
    p.add_argument("--image_mode", action="store_true")
    p.add_argument("--pcd_mode", action="store_true")
    p.add_argument("--video", action="store_true")
    p.add_argument("--video_frames", type=int, default=150)
    p.add_argument("--no_smooth", action="store_true")
    p.add_argument("-r", "--resolution", type=int, default=2)
    p.add_argument("--autotune", action="store_true",
                   help="time the rasterizer variants on the first camera and render with "
                        "the fastest (gags_torch.splat.autotune)")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    rep = run(a.model_path, a.source_path, a.iteration, text_embeds=a.text_embeds,
              thresh=a.thresh, pcd=a.pcd_mode, video=a.video, video_frames=a.video_frames,
              smooth=not a.no_smooth, resolution=a.resolution, autotune=a.autotune,
              device=a.device)
    if not a.pcd_mode:
        print(f"{rep['frames']} frames in {rep['seconds']:.2f} s "
              f"({rep['frames_per_s']:.2f} frames/s)", flush=True)


if __name__ == "__main__":
    main()
