"""GAD distillation CLI (port of gags_tpu.cli.train_gad).

Usage:
  python -m gags_torch.cli.train_gad -s <scene_dir> -m <model_dir> \\
      (--ply <pretrained point_cloud.ply> | --start_checkpoint <chkpnt<N>.pth>) \\
      [-r 2] [--iterations 30000] [--resume] [--autotune_train] [--profile] \\
      [--viewer_port 6009] [--device cpu]

The scene dir holds a COLMAP (or Blender) reconstruction plus
`language_features/<img>_{f,s}.npy` from the GAS stage; the frozen
geometry comes from a pretrained RGB 3DGS PLY, or from the reference's
torch checkpoint (`--start_checkpoint`, the 12- or 13-tuple of
`gaussian_model.capture()`): a 13-tuple's features seed training, the
`decoder_chkpnt<N>.pth` / `scale_decoder_chkpnt<N>.pth` beside it are
restored where present and training resumes at N (Adam restarts);
`--resume` from the model dir's own checkpoint wins over it. The trainer
bins every camera once (geometry is frozen) and runs the binned train
step on the device (default "cuda"; "cpu" runs the kernels' plain
versions). `--autotune_train` times the step with and without the fused
supervision on the device before training and trains with the faster
(saved into the model dir's gad_cfg.json, times in train_autotune.json);
`--profile` writes a torch.profiler Chrome trace of iterations 50-60
under `<model>/profile/`; `--viewer_port` serves RGB frames of the frozen
geometry to a SIBR remote viewer (0 or less: off). At each save
iteration it writes `chkpnt<N>/`, `point_cloud/iteration_N/
point_cloud.ply` with the trained features and `decoders.pt`, which
`gags_torch.cli.serve` serves. Single device only: multi-device training
(`--devices`) is not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import time
from typing import Callable, Optional

import numpy as np
import torch

from gags_torch import resolve_device
from gags_torch.core.camera import intrinsics_from_fov
from gags_torch.core.sh import sh_colors
from gags_torch.gad.autotune import autotune_train_step, cand_cfg_summary
from gags_torch.gad.checkpoints import (
    export_ply,
    latest_checkpoint_step,
    load_checkpoint,
    save_checkpoint,
)
from gags_torch.gad.data import GadDataset, prefetch_to_device
from gags_torch.gad.interop import (load_reference_checkpoint, load_reference_decoder,
                                    load_reference_scale_decoder)
from gags_torch.gad.train import (
    GadConfig,
    TrainState,
    create_train_state,
    frozen_geometry,
    loss_weights,
    make_eval_step,
    make_train_step_binned,
)
from gags_torch.models.weights import save_decoders
from gags_torch.scene.dataset import camera_to_json, detect_and_load
from gags_torch.scene.gaussian_data import GaussianScene
from gags_torch.splat.rasterizer import RasterizeConfig, prepare_binning, rasterize
from gags_torch.utils.colormaps import turbo
from gags_torch.utils.config import save_config
from gags_torch.utils.image import encode_png
from gags_torch.utils.logging import EmaProgress, MetricsWriter


@dataclasses.dataclass(frozen=True)
class RunConfig:
    source_path: str = ""
    model_path: str = ""
    ply_path: str = ""
    resolution: int = 2          # GAD.sh runs -r 2
    iterations: int = 30000
    save_iterations: str = "15000,30000"
    test_iterations: str = "7000,30000"  # held-out reporting
    seed: int = 0
    eval_split: bool = False     # hold out every 8th camera
    resume: bool = False
    # the reference's warm start: a torch chkpnt<N>.pth (12- or 13-tuple);
    # a 13-tuple also restores decoder_chkpnt<N> / scale_decoder_chkpnt<N>.pth
    # where present beside it and resumes at iteration N
    start_checkpoint: str = ""
    profile: bool = False        # torch.profiler trace of iterations 50-60
    # SIBR remote viewer; the CLI defaults to the reference's port 6009,
    # programmatic runs default off
    viewer_port: int = -1
    autotune_train: bool = False  # time equivalent step variants at startup
    device: str = "cuda"


def _bin_cache(geom, dataset: GadDataset, gad_cfg: GadConfig, device):
    """Bin every camera once, then re-bin at the tight budget (the largest
    valid instance count plus two chunks): every instance-sized stream of
    the step scales with the budget. A camera that overflows gets its own
    doubled budget. Returns the per-camera batch entries and the budget."""
    n = int(geom["means"].shape[0])
    base = gad_cfg.raster.instance_budget(n)

    def bin_camera(ex, budget):
        for _ in range(4):
            cfg = dataclasses.replace(gad_cfg.raster, budget=budget)
            b = prepare_binning(
                geom["means"], geom["quats"], geom["scales"],
                torch.as_tensor(ex.viewmat, device=device), torch.as_tensor(ex.K, device=device),
                dataset.width, dataset.height, cfg, opacities=geom["opacities"],
            )
            if int(b.overflow) == 0:
                return b, budget
            print(f"  {ex.name}: overflow {int(b.overflow)} → budget {2 * budget}")
            budget *= 2
        raise RuntimeError(
            f"instance budget overflow persists for {ex.name} (last budget "
            f"{budget}); raise RasterizeConfig.budget_factor")

    def entry(b):
        return dict(inst_gid=b.inst_gid, tile_starts=b.tile_starts, tile_counts=b.tile_counts,
                    order=b.order, red_slot=b.red.slot_to_pos, red_rank=b.red.slot_rank,
                    red_block=b.red.chunk_block)

    cache, budgets, valids = [], [], []
    for ex in dataset.examples:
        b, budget = bin_camera(ex, base)
        cache.append(entry(b))
        budgets.append(budget)
        valids.append(int(b.num_valid))
    chunk = gad_cfg.raster.chunk
    tight = (max(valids) // chunk + 2) * chunk
    if tight < max(budgets):
        old = max(budgets)
        for i, ex in enumerate(dataset.examples):
            b, used = bin_camera(ex, tight)
            if used != tight:
                raise RuntimeError(
                    f"{ex.name}: auto-tight budget {tight} overflowed (re-binned at {used})")
            cache[i] = entry(b)
        budgets = [tight] * len(budgets)
        print(f"auto-tight budget: {old} → {tight} "
              f"(max valid {max(valids)} over {len(valids)} cameras)")
    print(f"cached binning for {len(cache)} cameras")
    return cache, max(budgets)


def _make_viewer(geometry: GaussianScene, rc: RunConfig, device):
    """SIBR remote-viewer bridge serving RGB frames of the frozen geometry
    (the reference's train.py:109-123; GAD trains features only, so the
    view is the pretrained scene), rendered by the unaligned rasterizer
    (K6 and K5). None when disabled or the port is taken."""
    if rc.viewer_port is None or rc.viewer_port <= 0:
        return None
    from gags_torch.utils.viewer import TrainingViewer, ViewerServer

    try:
        server = ViewerServer(port=rc.viewer_port)
    except OSError as e:
        print(f"viewer: port {rc.viewer_port} unavailable ({e}); disabled")
        return None
    cfg = RasterizeConfig(aligned=False)

    @torch.no_grad()
    def render_rgb(req):
        K = torch.as_tensor(intrinsics_from_fov(req.fovx, req.fovy, req.width, req.height),
                            dtype=torch.float32, device=device)
        viewmat = torch.as_tensor(req.viewmat, dtype=torch.float32, device=device)
        campos = -viewmat[:3, :3].T @ viewmat[:3, 3]
        colors = sh_colors(3, geometry.sh, geometry.means, campos)
        res = rasterize(geometry.means, geometry.quats,
                        geometry.scales * float(req.scaling_modifier), geometry.opacities,
                        colors, viewmat, K, req.width, req.height,
                        background=torch.zeros((3,), dtype=torch.float32, device=device),
                        config=cfg, device=device)
        return torch.clamp(res.image, 0.0, 1.0).cpu().numpy()

    print(f"viewer listening on port {rc.viewer_port}")
    return TrainingViewer(server, render_rgb, rc.source_path)


def _start_profile(device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    prof = profile(activities=acts)
    prof.start()
    return prof


def _stop_profile(prof, model_path: str) -> str:
    """End the trace and write it as `<model>/profile/trace_iter50-60.json`
    (Chrome trace format: chrome://tracing or Perfetto)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    out = os.path.join(model_path, "profile")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "trace_iter50-60.json")
    prof.export_chrome_trace(path)
    print(f"profile written to {path}")
    return path


def run(rc: RunConfig, gad_cfg: Optional[GadConfig] = None,
        on_step: Optional[Callable[[int, TrainState, dict], None]] = None) -> TrainState:
    """Train; returns the final state. `on_step(it, state, metrics)`, if
    given, observes the loop (timing, probes): it is called once with the
    first iteration's number minus one and metrics None just before the
    first step, then after every step with that step's metrics."""
    dev = resolve_device(rc.device)
    gad_cfg = gad_cfg or GadConfig()
    os.makedirs(rc.model_path, exist_ok=True)
    save_config(rc, rc.model_path)
    gad_cfg.save(rc.model_path)

    scene_info = detect_and_load(rc.source_path, eval_split=rc.eval_split)
    with open(os.path.join(rc.model_path, "cameras.json"), "w") as f:
        json.dump([camera_to_json(i, ci) for i, ci in enumerate(scene_info.train_cameras)], f)
    if not rc.start_checkpoint and not rc.ply_path:
        raise SystemExit("one of --ply / --start_checkpoint is required")
    warm_iter = 0
    if rc.start_checkpoint:
        geometry, warm_iter, _ = load_reference_checkpoint(rc.start_checkpoint, device=dev)
        print(f"torch checkpoint {rc.start_checkpoint}: iteration {warm_iter}")
    else:
        geometry = GaussianScene.from_ply(rc.ply_path, device=dev)
    print(f"{geometry.num_gaussians} gaussians; {len(scene_info.train_cameras)} train cams")

    dataset = GadDataset(scene_info.train_cameras, resolution=rc.resolution)
    print(f"render {dataset.width}x{dataset.height}, max {dataset.max_masks} masks")

    state = create_train_state(geometry, gad_cfg, seed=rc.seed, device=dev)
    first_iter = 0
    if warm_iter > 0:
        # a 13-tuple: the decoder heads saved beside it, where present
        d = os.path.dirname(rc.start_checkpoint)
        m = re.search(r"(\d+)", os.path.basename(rc.start_checkpoint))
        n = m.group(1) if m else str(warm_iter)
        for name, module, load in (("decoder", state.decoder, load_reference_decoder),
                                   ("scale_decoder", state.scale_decoder,
                                    load_reference_scale_decoder)):
            path = os.path.join(d, f"{name}_chkpnt{n}.pth")
            if os.path.exists(path):
                module.load_state_dict(load(path))
                print(f"restored {path}")
        first_iter = warm_iter
    if rc.resume:
        step0 = latest_checkpoint_step(rc.model_path)
        if step0 is not None:
            state = load_checkpoint(rc.model_path, step0, state)
            first_iter = step0
            print(f"resumed from iteration {step0}")

    geom = frozen_geometry(geometry)
    bin_cache, _ = _bin_cache(geom, dataset, gad_cfg, dev)
    if rc.autotune_train:
        # time the equivalent step variants on this device; the winner
        # runs the loop and the model dir carries it
        b0 = {k: torch.as_tensor(v, device=dev) for k, v in dataset.batch(0).items()}
        b0.update(bin_cache[0])
        times = {}
        gad_cfg, step_fn = autotune_train_step(dataset.width, dataset.height, gad_cfg, state,
                                               geom, b0, times=times)
        gad_cfg.save(rc.model_path)
        with open(os.path.join(rc.model_path, "train_autotune.json"), "w") as f:
            json.dump(dict(times_ms={k: v * 1e3 for k, v in times.items()},
                           winner=cand_cfg_summary(gad_cfg)), f, indent=2)
    else:
        step_fn = make_train_step_binned(dataset.width, dataset.height, gad_cfg)

    rng = np.random.default_rng(rc.seed)
    save_at = {int(s) for s in rc.save_iterations.split(",") if s}
    save_at.add(rc.iterations)
    test_at = {int(s) for s in rc.test_iterations.split(",") if s}

    metrics_w = MetricsWriter(rc.model_path)
    progress = EmaProgress(rc.iterations)

    eval_fn = test_ds = None
    if test_at and scene_info.test_cameras:
        try:
            test_ds = GadDataset(scene_info.test_cameras, resolution=rc.resolution,
                                 max_masks=dataset.max_masks)
            eval_fn = make_eval_step(test_ds.width, test_ds.height, gad_cfg)
        except Exception as e:
            print(f"held-out reporting disabled: {e}")

    def test_report(it):
        """Held-out losses and scale-map PNGs (test_renders/)."""
        vals, smap = [], None
        for ci in range(min(len(test_ds), 8)):
            batch = {k: torch.as_tensor(v, device=dev) for k, v in test_ds.batch(ci).items()}
            mtr, smap = eval_fn(state, geom, batch)
            vals.append({k: float(v) for k, v in mtr.items()})
        agg = {f"test_{k}": float(np.mean([v[k] for v in vals])) for k in vals[0]}
        metrics_w.write(it, agg)
        print(f"\n[iter {it}] test: " + ", ".join(f"{k}={v:.4f}" for k, v in agg.items()))
        out = os.path.join(rc.model_path, "test_renders")
        os.makedirs(out, exist_ok=True)
        sm = smap.cpu().numpy()
        with open(os.path.join(out, f"scale_map_{it}.png"), "wb") as f:
            f.write(encode_png(sm))
        for gi, gname in enumerate("sml"):
            with open(os.path.join(out, f"scale_map_{gname}_{it}.png"), "wb") as f:
                f.write(encode_png(turbo(sm[..., gi])))

    def batch_stream():
        while True:
            for i in dataset.epoch_order(rng):
                b = dataset.batch(int(i))
                b.update(bin_cache[int(i)])
                yield b

    viewer = _make_viewer(geometry, rc, dev)
    prof = None
    stream = prefetch_to_device(batch_stream(), dev)
    t_iter = time.time()
    if on_step is not None:
        on_step(first_iter, state, None)
    try:
        for it in range(first_iter + 1, rc.iterations + 1):
            if viewer is not None:
                viewer.poll(it, rc.iterations)
            if rc.profile and it == 50:
                prof = _start_profile(dev)
            if prof is not None and it == 60:
                _stop_profile(prof, rc.model_path)
                prof = None
            ew, rw = loss_weights(it, gad_cfg)
            state, m = step_fn(state, geom, next(stream), ew, rw)
            if on_step is not None:
                on_step(it, state, m)
            if it % 10 == 0:
                loss = float(m["loss"])  # a host sync every 10 iterations only
                if not np.isfinite(loss):
                    # keep the poisoned state for inspection OUTSIDE the
                    # chkpnt* namespace, so --resume finds the last good one
                    save_checkpoint(os.path.join(rc.model_path, "nan_dump"), state, it)
                    raise FloatingPointError(
                        f"non-finite loss at iteration {it}: state saved to "
                        f"nan_dump/chkpnt{it}; check learning rates and supervision")
                progress.update(it, loss)
            if it % 500 == 0:
                dt = time.time() - t_iter
                t_iter = time.time()
                row = {k: float(m[k]) for k in ("loss", "l1_feature", "entropy", "region_var")}
                row.update(scale_s=float(m["scale_mean_s"]), scale_m=float(m["scale_mean_m"]),
                           scale_l=float(m["scale_mean_l"]), overflow=float(m["overflow"]),
                           sec_per_500=dt)
                metrics_w.write(it, row)
            if it in test_at and eval_fn is not None:
                test_report(it)
            if it in save_at:
                print(f"\n[iter {it}] saving checkpoint + PLY + decoders")
                save_checkpoint(rc.model_path, state, it)
                export_ply(rc.model_path, geometry, state, it)
                save_decoders(os.path.join(rc.model_path, "decoders.pt"),
                              state.decoder, state.scale_decoder)
    finally:
        if prof is not None:
            _stop_profile(prof, rc.model_path)
        if viewer is not None:
            viewer.close()
        stream.close()
        metrics_w.close()
    return state


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-s", "--source_path", required=True)
    p.add_argument("-m", "--model_path", required=True)
    p.add_argument("--ply", dest="ply_path", default="")
    p.add_argument("--start_checkpoint", default="",
                   help="the reference's torch chkpnt<N>.pth to warm-start from")
    p.add_argument("-r", "--resolution", type=int, default=2)
    p.add_argument("--iterations", type=int, default=30000)
    p.add_argument("--save_iterations", default="15000,30000")
    p.add_argument("--test_iterations", default="7000,30000")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval", dest="eval_split", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--profile", action="store_true",
                   help="torch.profiler Chrome trace of iterations 50-60 under <model>/profile/")
    p.add_argument("--viewer_port", type=int, default=6009,
                   help="SIBR remote viewer port (0 or less: off)")
    p.add_argument("--autotune_train", action="store_true",
                   help="time the equivalent train-step variants on the device at "
                        "startup; train with the faster")
    p.add_argument("--device", default="cuda")
    p.add_argument("--no_fused_supervision", action="store_true",
                   help="use the generic supervision composition (same math)")
    p.add_argument("--decoder_bf16", action="store_true",
                   help="decoders under bfloat16 autocast (f32 params, normalise, softmax)")
    args = vars(p.parse_args(argv))
    gad_cfg = GadConfig(fused_supervision=not args.pop("no_fused_supervision"),
                        decoder_bf16=args.pop("decoder_bf16"))
    run(RunConfig(**args), gad_cfg)


if __name__ == "__main__":
    main()
