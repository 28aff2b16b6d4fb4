#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (gags_torch) on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which fails the run:
  1. print the card's name and power limit (nvidia-smi); no CUDA → exit 1;
  2. build every kernel from gags_torch/splat/csrc
     (one nvcc per source, all at once);
  3. K6 expand_gid vs its plain version on the smoke scene's real rank
     offsets: exact; times of the kernel, the plain version and
     torch.searchsorted (the library yardstick), by CUDA events around
     back-to-back calls and as device time per call (torch.profiler);
  4. K5 blend_forward vs its plain version on the full 1280x720 frame, for
     the 16 feature channels and the 3 SH colour channels: atol 2e-5 /
     rtol 1e-4 with the NUMERICS.md allowance for isolated threshold flips
     (at most 0.01% of values outside, mean abs error <= 1e-5);
  5. serve the bench scene (make_scene(250_000, seed=0, extent=3.0), 16-dim
     features, full-width decoders from a seeded torch.Generator) through
     SceneServer behind ThreadingHTTPServer on 127.0.0.1: /health,
     /render rgb, /render feature_pca and two /relevancy requests at
     1280x720, with the launch counts set to 0 just before and read just
     after; every kernel must have launched;
  6. check the outputs: finite, the expected shapes, overflow == 0, the
     served relevancy maximum equal to a direct computation, and the card's
     rasterize equal to the oracle (splat/reference.py) on a small scene;
  7. train: write the full-width training configuration of
     scripts/train_bench.py to a temporary directory with the port's own
     writers (make_scene(300_000, seed=0, extent=3.0) as a PLY, four
     PINHOLE cameras at 1280x720 around the bench camera, per camera 300
     unit-norm 512-dim f16 CLIP embeddings and a (4, 720, 1280) seg map with
     ids in [-1, 300)), then train 40 steps through
     gags_torch.cli.train_gad.run at -r 2 (640x360, 16-dim features,
     512-dim CLIP, 4096 segments) with the launch counts set to 0 just
     before and read just after: K1-K4 must each have launched, the loss
     must stay finite; step times from CUDA events;
  8. K1-K4 against their plain versions on camera 0's binning (overflow 0
     at budget factor 4) and the real cotangents of its loss, with times,
     bounds and index_add_ yardsticks (K4 at 1025 and 4097 segments, for
     2 and 33 channels; K3 on K2's rows, C = 16, also against index_add_
     over inst_gid and bit-identical on a second launch, with an index_add_
     yardstick over the live slots and one over all of inst_gid); K3, K4
     and their yardsticks as device time per call (torch.profiler) beside
     the CUDA-events time; profile one training step;
  9. serve the trained model dir (load_server) and check one relevancy map;
 9b. inference options: (a) K7 expand_keys against its plain version on
     the projection of make_scene(250_000) at 1280x720 and of
     make_scene(1_000_000) at 1920x1080 (budget factor 4), cull off and
     on: keys and per-chunk counts exact, the fused binning equal to the
     K6 binning field by field, fewer instances with the cull, K5's image
     the same with the cull off and on; K7's device time per launch
     (torch.profiler; back-to-back launches between CUDA events measure
     the host's launch rate), bound, plain time and the unfused chain's
     (K6 + gathers + key ops); (b) K5's
     fast_color_rows, blend_bf16 (also against the f32 image at its
     contract), exit_stats (totals exact, at most STATS_MOVED_TILES tiles
     moved by a threshold flip) and block_exit (bit-identical) on the
     serve frame, and exit_stats once more on a saturated 1280x720 frame
     (SAT_GAUSSIANS dense, near-opaque splats) where tiles must stop
     early; (c) gags_torch.cli.render.run on phase 7's model dir
     (four cameras at 1280x720, -r 1) with an autotune store of its own:
     RGB+ED, then --feature_mode
     --feature_npy --autotune, each with the launch counts set to 0 just
     before and read just after (autotune times, winner, frames/s, K7
     launches), then the cameras once more with fused_keys and tile_cull:
     K7 once per frame, the images equal to the unfused render's;
 10. RGB pretraining: write a COLMAP scene to a temporary directory with
     the port's own writers (ground-truth PNGs of make_scene(300_000,
     seed=0, extent=3.0) with SH-3 colours rendered by K5 from eight
     PINHOLE cameras at 1280x720 around the bench camera; an SfM seed
     cloud of 100,000 of its means plus N(0, 0.01) noise with their dc
     colours; camera 0's image once more Paeth-filtered, its read_png
     decode timed and held to the pixels), then train 300 steps through gags_torch.cli.train_rgb.run
     at -r 1 (SH degree 3, capacity factor 4: 400k slots; densify at 100
     and 200) with the launch counts set to 0 just before and read just
     after: K1, K6 and K8 must each have launched >= 300 times and K3 >=
     600, the loss must stay finite and the mean of the last 20 losses
     fall below that of the first 20; n_alive before and after each
     densify;
 11. time 30 more steps of make_rgb_step at SH degree 3 (median, p90 from
     CUDA events), count the host syncs of one (sync debug mode) and
     profile one;
 12. K8 against its plain version on camera 0's binning of the trained
     state (overflow 0) and the real cotangents of its L1 + SSIM loss, at
     the CPU test's tolerance, column by column (each colour channel and
     each of mx, my, ca, cb, cc, opacity against its own scale), and the
     means2d tap's gradient (K8 then K3) against the plain version's mx, my
     rows summed per Gaussian; with K8's time, bound and plain time; then
     K3 at the RGB widths on K8's colour (C = 3) and geometry (C = 8) rows
     over camera 0's ReductionLayout, checked and timed as in phase 8;
 13. load the snapshot PLY with GaussianScene.from_ply and render camera
     0: its PSNR against the ground truth must exceed the seed cloud's;
 14. print {"kernels": [...]} with times, bounds and launch counts of
     K1-K8 (K3 by width: GAD C = 16, RGB C = 3 and 8), then the card's
     name and power limit, then the final {"ok": true, ...}.
"""

from __future__ import annotations

import base64
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import zlib
from http.server import ThreadingHTTPServer

import numpy as np
import torch

WIDTH, HEIGHT = 1280, 720
N_GAUSSIANS = 250_000
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
ATOL, RTOL = 2e-5, 1e-4
FLIP_FRACTION = 1e-4  # NUMERICS.md: isolated threshold flips, <= 0.01%
FLIP_MEAN = 1e-5
# the training configuration (scripts/train_bench.py's full-width scene,
# rendered at -r 2 as scripts/GAD.sh runs it)
TRAIN_N = 300_000
TRAIN_SRC_W, TRAIN_SRC_H = 1280, 720
TRAIN_CAMERAS = 4
TRAIN_MASKS = 300
TRAIN_STEPS = 40
# the RGB pretraining configuration (the RGB model at full width: SH
# degree 3, 3 channels, 1280x720 at -r 1; cut to 8 cameras and 300 steps)
RGB_CAMERAS = 8
RGB_SEED_POINTS = 100_000
RGB_STEPS = 300
RGB_TIMED = 30


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20) -> float:
    """Device time per call of fn: the sum of its kernels' device time
    (torch.profiler), where back-to-back launches timed by events measure
    the host's launch rate instead (kernels of a few microseconds behind a
    Python wrapper)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)
    if busy <= 0:
        fail("torch.profiler recorded no device time")
    return busy / 1e3 / iters


def flip_tolerant_compare(got: torch.Tensor, want: torch.Tensor, what: str) -> dict:
    err = (got - want).abs()
    outside = err > (ATOL + RTOL * want.abs())
    res = {
        "max_abs_err": float(err.max()),
        "mean_abs_err": float(err.mean()),
        "frac_outside": float(outside.float().mean()),
    }
    ok = (torch.isfinite(got).all() and res["mean_abs_err"] <= FLIP_MEAN
          and res["frac_outside"] <= FLIP_FRACTION)
    print(f"# {what}: {res}", flush=True)
    if not ok:
        fail(f"{what} disagrees with its plain version: {res}")
    return res


def profile_request(fn, label: str, top: int = 8) -> dict:
    """Wall time, device busy time and idle share of one served request,
    and the kernels that took the most device time (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side rows only (kernels, copies): the CPU-op rows repeat them
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"# profile {label}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, "
          f"idle {100 * (1 - busy_ms / wall_ms):.1f}%")
    for e in rows[:top]:
        print(f"#   {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<4d} {e.key[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms}


def count_syncs(fn) -> dict:
    """Host syncs of one call of fn, under torch.cuda.set_sync_debug_mode:
    {file:line that asked: count}."""
    import warnings

    torch.cuda.synchronize()
    found: dict = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    for w in caught:  # (not the mode's own notice that it is a prototype)
        if "called a synchronizing" in str(w.message):
            key = f"{os.path.basename(w.filename)}:{w.lineno}"
            found[key] = found.get(key, 0) + 1
    torch.cuda.synchronize()
    return found


def ptxas_summary(log: str) -> list[str]:
    """'<kernel><T>: N registers, S bytes spill stores' per entry function,
    T its first integer template argument (the blends' channel count, K3's
    vector width, K4's strip length)."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"([a-z][a-z_]*_kernel)(?:ILi(\d+)E)?", line.split("'")[1])
            name = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
            name += "[bf16]" if "bfloat16" in line else ""
        elif "spill stores" in line:
            spill = line.split(",")[1].strip()
        elif "registers" in line and name:
            regs = line.split("Used")[1].split(",")[0].strip()
            out.append(f"{name}: {regs}, {spill}")
            name = None
    return out


def decode_png(b64: str) -> np.ndarray:
    b = base64.b64decode(b64)
    if b[:8] != b"\x89PNG\r\n\x1a\n":
        fail("response is not a PNG")
    w, h = np.frombuffer(b[16:24], ">u4")
    n = int(np.frombuffer(b[33:37], ">u4")[0])
    rows = np.frombuffer(zlib.decompress(b[41 : 41 + n]), np.uint8)
    return rows.reshape(int(h), 1 + 3 * int(w))[:, 1:].reshape(int(h), int(w), 3)


def sum_compare(got: torch.Tensor, want: torch.Tensor, abs_sum: torch.Tensor, what: str,
                rtol: float = 1e-5) -> dict:
    """Sums taken in another order: each value is held to rtol of the sum
    of its terms' absolute values (the scale of float32 reordering error)."""
    err = (got - want).abs()
    res = {"max_abs_err": float(err.max()), "max_rel_err": float((err / abs_sum.clamp_min(1e-30)).max())}
    print(f"# {what}: {res}", flush=True)
    if not torch.isfinite(got).all() or bool((err > rtol * abs_sum).any()):
        fail(f"{what} disagrees with its plain version: {res}")
    return res


DEVICE_TIMING = ("ms, library_ms, library_all_slots_ms: device time per call (torch.profiler); "
                 "events_ms, library_*events_ms: back-to-back calls between CUDA events")


def with_bound(r: dict) -> dict:
    r["bound_ms"] = max(r["bytes_ms"], r["ops_ms"])
    r["bound_by"] = "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations"
    return r


def k3_check(kernels, rows: torch.Tensor, b, num_ranks: int, what: str) -> dict:
    """K3 over binning b's ReductionLayout, as the rasterizer's backward
    calls it: against its plain version and against index_add_ over
    inst_gid (sum_compare), bit-identical on a second launch; its device
    and events times, bytes bound, plain time and the index_add_
    yardsticks' times: library_ms over the live slots (inst_gid below
    num_ranks, selected before timing), library_all_slots_ms over all of
    inst_gid, whose dummies and fillers all add into the sentinel row."""
    red, c, dev = b.red, rows.shape[1], rows.device
    args = (rows, red.slot_to_pos, red.slot_rank, red.chunk_block, num_ranks)
    got = kernels.sorted_segment_sum(*args)
    again = kernels.sorted_segment_sum(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = kernels.sorted_segment_sum_plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    if not torch.equal(got, again):
        fail(f"K3 {what}: two launches differ at {int((got != again).sum())} values")
    abs_sum = kernels.sorted_segment_sum_plain(rows.abs(), *args[1:])
    cmp = sum_compare(got, want, abs_sum, f"K3 sorted_segment_sum {what}")
    gid_l = b.inst_gid.long()
    all_fn = lambda: torch.zeros((num_ranks + 1, c), device=dev).index_add_(  # noqa: E731
        0, gid_l, rows)
    sum_compare(got, all_fn()[:num_ranks], abs_sum, f"K3 {what} vs index_add_")
    live = gid_l < num_ranks
    gid_live, rows_live = gid_l[live], rows[live]
    lib_fn = lambda: torch.zeros((num_ranks, c), device=dev).index_add_(  # noqa: E731
        0, gid_live, rows_live)
    sum_compare(got, lib_fn(), abs_sum, f"K3 {what} vs index_add_ over the live slots")
    fn = lambda: kernels.sorted_segment_sum(*args)  # noqa: E731
    # what this layout needs: the rows and slot entries of the instances of
    # ranks below num_ranks, chunk_block, the sums (dummies, fillers and
    # padding are never read)
    per_rank = torch.bincount(gid_l, minlength=num_ranks + 1)[:num_ranks]
    inst = int(per_rank.sum())
    nbytes = (inst * (c + 2) + red.chunk_block.numel() + got.numel()) * 4
    res = with_bound(dict(
        ms=device_ms(fn), events_ms=cuda_ms(fn, 50), plain_ms=plain_ms,
        bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3, ops_ms=inst * c / FP32_OPS_PER_S * 1e3,
        library_ms=device_ms(lib_fn), library_events_ms=cuda_ms(lib_fn, 50),
        library_all_slots_ms=device_ms(all_fn), library_all_slots_events_ms=cuda_ms(all_fn, 50),
        channels=c,
        instances=inst, slots=red.slot_rank.numel(), ranks=num_ranks,
        # ranks of more than 16 slots take K3's warp path
        max_slots_per_rank=int(per_rank.max()), ranks_over_16_slots=int((per_rank > 16).sum()),
        bit_identical=True, **cmp))
    print(f"# K3 {what}: {res}", flush=True)
    return res


def image_to_tiles(img, tiles_x, tiles_y, tile_h, tile_w):
    """(H, W, C) → (T, P, C), zero-padding to the tile grid."""
    h, w, c = img.shape
    img = torch.nn.functional.pad(img, (0, 0, 0, tiles_x * tile_w - w, 0, tiles_y * tile_h - h))
    img = img.reshape(tiles_y, tile_h, tiles_x, tile_w, c).permute(0, 2, 1, 3, 4)
    return img.reshape(tiles_x * tiles_y, tile_h * tile_w, c)


def write_train_fixture(root: str) -> str:
    """The training scene on disk, written with the port's own writers;
    returns the pretrained PLY's path."""
    import math

    from gags_torch.core.camera import look_at
    from gags_torch.models.weights import scene_from_arrays
    from gags_torch.scene import colmap as cm
    from gags_torch.utils.synthetic import make_scene

    rng = np.random.default_rng(0)
    sparse = os.path.join(root, "sparse", "0")
    feat_dir = os.path.join(root, "language_features")
    os.makedirs(sparse)
    os.makedirs(feat_dir)
    w, h = TRAIN_SRC_W, TRAIN_SRC_H
    fx = w / (2 * math.tan(math.radians(30.0)))  # make_camera's 60 degree field of view
    cams = {1: cm.ColmapCamera(1, "PINHOLE", w, h, np.array([fx, fx, w / 2, h / 2]))}
    imgs = {}
    for i in range(TRAIN_CAMERAS):
        ang = 2 * np.pi * i / TRAIN_CAMERAS
        eye = np.array([0.25 * np.cos(ang), 0.15 * np.sin(ang), -0.2])
        vm = look_at(eye, np.array([0.0, 0.0, 6.0]), np.array([0.0, -1.0, 0.0])).astype(np.float64)
        imgs[i + 1] = cm.ColmapImage(i + 1, cm.rotmat_to_qvec(vm[:3, :3]), vm[:3, 3], 1,
                                     f"cam{i:02d}.png")
        emb = rng.normal(size=(TRAIN_MASKS, 512))
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        np.save(os.path.join(feat_dir, f"cam{i:02d}_f.npy"), emb.astype(np.float16))
        seg = np.zeros((4, h, w), np.float32)
        for level, block in ((1, 24), (2, 48), (3, 96)):  # s, m, l regions
            coarse = rng.integers(-1, TRAIN_MASKS, size=(-(-h // block), -(-w // block)))
            seg[level] = np.repeat(np.repeat(coarse, block, 0), block, 1)[:h, :w]
        np.save(os.path.join(feat_dir, f"cam{i:02d}_s.npy"), seg)
    cm.write_cameras_binary(os.path.join(sparse, "cameras.bin"), cams)
    cm.write_images_binary(os.path.join(sparse, "images.bin"), imgs)
    raw = make_scene(TRAIN_N, seed=0, extent=3.0)
    scene = scene_from_arrays(raw["means"], raw["quats"], np.log(raw["scales"]),
                              np.log(raw["opacities"] / (1.0 - raw["opacities"])), raw["sh"])
    ply = os.path.join(root, "pretrained.ply")
    scene.save_ply(ply)
    return ply


def train_phase(dev: torch.device, gpu: str, after_serving) -> tuple:
    """Phases 7-9: train through the CLI entry point, hold K1-K4 against
    their plain versions on the run's own data, profile a step, serve the
    trained model dir; then `after_serving(scene dir, model dir)` (phase
    9b) while both exist. Returns the kernels' report entries and what
    after_serving returned."""
    from gags_torch.cli.serve import load_server
    from gags_torch.cli.train_gad import RunConfig, _bin_cache, run
    from gags_torch.core.camera import Camera
    from gags_torch.gad.data import GadDataset
    from gags_torch.gad.supervision import mixed_seg_map
    from gags_torch.gad.train import (GadConfig, _supervision_losses, frozen_geometry,
                                      make_train_step_binned, supervised_l1_pix)
    from gags_torch.scene.dataset import detect_and_load
    from gags_torch.scene.gaussian_data import GaussianScene
    from gags_torch.splat import kernels
    from gags_torch.splat.projection import project_gaussians
    from gags_torch.splat.rasterizer import (_geom_table, order_ext, prepare_binning,
                                             rasterize_binned)

    with tempfile.TemporaryDirectory() as tmp:
        root, model = os.path.join(tmp, "scene"), os.path.join(tmp, "model")
        t0 = time.perf_counter()
        ply = write_train_fixture(root)
        print(f"# training fixture written in {time.perf_counter() - t0:.1f} s", flush=True)

        # -- 7. train through the entry point --------------------------------
        events, metrics = [], []

        def on_step(it, state, m):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
            if m is not None:
                metrics.append(m)

        rc = RunConfig(source_path=root, model_path=model, ply_path=ply, resolution=2,
                       iterations=TRAIN_STEPS, save_iterations=str(TRAIN_STEPS),
                       test_iterations="", device="cuda")
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        state = run(rc, on_step=on_step)
        torch.cuda.synchronize()
        launches = dict(kernels.launch_counts)
        run_s = time.perf_counter() - t0
        print(f"# launches during training: {launches}")
        for name in ("blend_forward_aligned", "blend_backward", "sorted_segment_sum",
                     "dense_segment_sum"):
            if launches[name] <= 0:
                fail(f"{name} was not launched while training")
        losses = [float(m["loss"]) for m in metrics]
        if len(losses) != TRAIN_STEPS or not np.all(np.isfinite(losses)):
            fail(f"training losses {losses}")
        step_ms = [events[i - 1].elapsed_time(events[i]) for i in range(1, len(events))]
        steady = np.asarray(step_ms[9:])  # steps 10-40
        steps = dict(cold_first_ms=step_ms[0], median_ms=float(np.median(steady)),
                     p90_ms=float(np.percentile(steady, 90)), steps=len(step_ms))
        print(f"# train: {TRAIN_STEPS} steps in {run_s:.1f} s (set-up included); step ms: {steps}; "
              f"loss {losses[0]:.5f} -> {losses[-1]:.5f} ({gpu})", flush=True)

        # -- 8. K1-K4 vs their plain versions on camera 0 --------------------
        cfg = GadConfig()
        info = detect_and_load(root)
        ds = GadDataset(info.train_cameras, resolution=2)
        w, h = ds.width, ds.height
        geometry = GaussianScene.from_ply(
            os.path.join(model, "point_cloud", f"iteration_{TRAIN_STEPS}", "point_cloud.ply"),
            device=dev)
        geo = frozen_geometry(geometry)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in ds.batch(0).items()}
        b = prepare_binning(geo["means"], geo["quats"], geo["scales"], batch["viewmat"],
                            batch["K"], w, h, cfg.raster, opacities=geo["opacities"])
        if int(b.overflow) != 0:
            fail(f"training binning overflow {int(b.overflow)} at budget_factor "
                 f"{cfg.raster.budget_factor}")
        # the binning the trainer used: its cache at the auto-tight budget
        cache, budget = _bin_cache(geo, ds, cfg, dev)
        batch.update(cache[0])
        b = b._replace(inst_gid=cache[0]["inst_gid"], tile_starts=cache[0]["tile_starts"],
                       tile_counts=cache[0]["tile_counts"], order=cache[0]["order"],
                       red=b.red._replace(slot_to_pos=cache[0]["red_slot"],
                                          slot_rank=cache[0]["red_rank"],
                                          chunk_block=cache[0]["red_block"]))
        th, tw = cfg.raster.tile_h, cfg.raster.tile_w
        tx, ty = -(-w // tw), -(-h // th)
        n, fdim = geometry.semantic_features.shape
        print(f"# camera 0 at {w}x{h}: {int(b.num_valid)} instances, {b.inst_gid.numel()} slots "
              f"at the tight budget {budget}, {tx * ty} tiles of {th}x{tw}", flush=True)
        # the real cotangent of the tile image under the late-schedule loss
        feats = geometry.semantic_features.clone().requires_grad_(True)
        feat_map, _ = rasterize_binned(
            geo["means"], geo["quats"], geo["scales"], geo["opacities"], feats, batch["viewmat"],
            batch["K"], b.inst_gid, b.tile_starts, b.tile_counts, w, h, config=cfg.raster,
            order=b.order, red_slot=b.red.slot_to_pos, red_rank=b.red.slot_rank,
            red_block=b.red.chunk_block)
        feat_map.retain_grad()
        l1, ent, regvar, _ = _supervision_losses(cfg, state.decoder, state.scale_decoder,
                                                 feat_map, batch)
        (l1 + 2e-3 * ent + 0.1 * regvar).backward()
        g_tiles = image_to_tiles(feat_map.grad, tx, ty, th, tw)
        # K2 is linear in g: scaled to max |g| = 1, atol 1e-6 means something
        g_tiles = (g_tiles / g_tiles.abs().max()).contiguous()
        with torch.no_grad():
            proj = project_gaussians(geo["means"], geo["quats"], geo["scales"], batch["viewmat"],
                                     batch["K"], w, h)
            perm = order_ext(b.order.long())
            geom_p = _geom_table(proj, geo["opacities"])[perm].contiguous()
            cols_p = torch.cat([geometry.semantic_features,
                                torch.zeros((1, fdim), device=dev)])[perm].contiguous()
            px = feat_map.detach().reshape(-1, fdim)
            scale_px = state.scale_decoder(px)
            seg_mixed = mixed_seg_map(batch["seg_map"], scale_px.reshape(h, w, 3))
            l1_pix = supervised_l1_pix(cfg, state.decoder(px), scale_px, batch).reshape(-1)
        report = []

        # K1
        bg = torch.zeros((fdim,), device=dev)
        a1 = (geom_p, cols_p, b.inst_gid, b.tile_starts, b.tile_counts, bg, tx, ty, th, tw)
        out_k = kernels.blend_forward_aligned(*a1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_p, walked, blended = kernels.blend_forward_plain(*a1, return_pairs=True)
        torch.cuda.synchronize()
        k1_plain = (time.perf_counter() - t0) * 1e3
        cmp1 = flip_tolerant_compare(out_k, out_p, f"K1 blend_forward_aligned C={fdim}")
        nbytes = (geom_p.numel() + cols_p.numel() + b.inst_gid.numel()
                  + 2 * b.tile_starts.numel() + bg.numel() + out_k.numel()) * 4
        ops = 16 * walked + (4 + 2 * fdim) * blended
        report.append(dict(
            name="blend_forward_aligned", id="K1", route="cuda",
            source="gags_torch/splat/csrc/blend_forward.cu",
            replaces="gags_tpu/splat/pallas_kernel.py:1909",
            ms=cuda_ms(lambda: kernels.blend_forward_aligned(*a1), 20), plain_ms=k1_plain,
            bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3, ops_ms=ops / FP32_OPS_PER_S * 1e3,
            library_ms=None, pairs_walked=walked, pairs_blended=blended, **cmp1))
        del out_k, out_p

        # K2
        a2 = (geom_p, b.inst_gid, b.tile_starts, b.tile_counts, g_tiles, tx, ty, th, tw)
        grad_k = kernels.blend_backward(*a2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grad_p, walked2, blended2 = kernels.blend_backward_plain(*a2, return_pairs=True)
        torch.cuda.synchronize()
        k2_plain = (time.perf_counter() - t0) * 1e3
        err = (grad_k - grad_p).abs()
        outside = err > 1e-6 + 1e-4 * grad_p.abs()
        cmp2 = {"max_abs_err": float(err.max()), "mean_abs_err": float(err.mean()),
                "frac_outside": float(outside.float().mean()),
                "max_abs_grad": float(grad_p.abs().max())}
        print(f"# K2 blend_backward C={fdim}: {cmp2}", flush=True)
        if not torch.isfinite(grad_k).all() or cmp2["frac_outside"] > FLIP_FRACTION:
            fail(f"K2 blend_backward disagrees with its plain version: {cmp2}")
        nbytes = (geom_p.numel() + b.inst_gid.numel() + 2 * b.tile_starts.numel()
                  + g_tiles.numel() + grad_k.numel()) * 4
        ops = 16 * walked2 + 2 * fdim * blended2
        report.append(dict(
            name="blend_backward", id="K2", route="cuda",
            source="gags_torch/splat/csrc/blend_backward.cu",
            replaces="gags_tpu/splat/pallas_kernel.py:1969",
            ms=cuda_ms(lambda: kernels.blend_backward(*a2), 20), plain_ms=k2_plain,
            bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3, ops_ms=ops / FP32_OPS_PER_S * 1e3,
            library_ms=None, pairs_walked=walked2, pairs_blended=blended2,
            max_abs_err=cmp2["max_abs_err"], mean_abs_err=cmp2["mean_abs_err"]))
        del grad_p

        # K3, on K2's rows
        k3 = k3_check(kernels, grad_k, b, n, f"GAD C={fdim}")
        report.append(dict(
            name="sorted_segment_sum", id="K3", route="cuda",
            source="gags_torch/splat/csrc/sorted_segment_sum.cu",
            replaces="gags_tpu/splat/pallas_kernel.py:1431",
            timing=DEVICE_TIMING, **k3))

        # K4 at 1025 and 4097 segments, 2 and 33 channels
        ids = (seg_mixed + 1).reshape(-1).to(torch.int32).contiguous()
        ids_l = ids.long()
        ones = torch.ones_like(l1_pix)[:, None]
        inputs = {2: torch.cat([ones, l1_pix[:, None]], 1).contiguous(),
                  1 + 2 * fdim: torch.cat([ones, px, px * px], 1).contiguous()}
        k4 = {}
        for segs in (1025, cfg.max_segments + 1):
            for c, vals in inputs.items():
                got = kernels.dense_segment_sum(vals, ids, segs)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                kernels.dense_segment_sum_plain(vals, ids, segs)
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t0) * 1e3
                # the plain version in float64: its float32 form (index_add_,
                # atomics in no fixed order) rounds as much as the kernel. A
                # float32 running sum of n terms in no fixed order is off by
                # ~u * sqrt(n) of its terms' absolute sum; held at 4x that,
                # which leaves every count (the ones column) exact
                want = kernels.dense_segment_sum_plain(vals.double(), ids, segs)
                abs_sum = kernels.dense_segment_sum_plain(vals.double().abs(), ids, segs)
                terms = torch.bincount(ids_l[(ids_l >= 0) & (ids_l < segs)], minlength=segs)
                rtol = 4 * 2.0 ** -24 * terms.double().clamp_min(1).sqrt()[:, None]
                cmp4 = sum_compare(got.double(), want, abs_sum,
                                   f"K4 dense_segment_sum S={segs} C={c}", rtol=rtol)
                nbytes = (vals.numel() + ids.numel() + got.numel()) * 4
                k4_fn = lambda: kernels.dense_segment_sum(vals, ids, segs)  # noqa: E731
                lib_fn = lambda: torch.zeros((segs, c), device=dev).index_add_(  # noqa: E731
                    0, ids_l, vals)
                k4[f"S={segs},C={c}"] = dict(
                    ms=device_ms(k4_fn), events_ms=cuda_ms(k4_fn, 50),
                    plain_ms=plain_ms, bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                    ops_ms=vals.numel() / FP32_OPS_PER_S * 1e3,
                    library_ms=device_ms(lib_fn), library_events_ms=cuda_ms(lib_fn, 50),
                    **cmp4)
                print(f"# K4 S={segs} C={c}: {k4[f'S={segs},C={c}']} ({gpu})", flush=True)
        head = k4[f"S={cfg.max_segments + 1},C={1 + 2 * fdim}"]
        report.append(dict(
            name="dense_segment_sum", id="K4", route="cuda",
            source="gags_torch/splat/csrc/dense_segment_sum.cu",
            replaces="gags_tpu/splat/pallas_kernel.py:1853",
            timing=DEVICE_TIMING, **head, by_config=k4))
        for r in report[:2]:
            print(f"# {r['id']} {r['name']}: ms {r['ms']:.4f}, plain {r['plain_ms']:.1f} ms, "
                  f"bound {max(r['bytes_ms'], r['ops_ms']):.4f} ms ({gpu})", flush=True)

        # one training step, profiled (after the counted run)
        step_fn = make_train_step_binned(w, h, cfg)
        prof = profile_request(lambda: step_fn(state, geo, batch, 1e-3, 0.0),
                               f"train step {w}x{h} / {n} Gaussians", top=16)
        steps.update(prof)

        # -- 9. serve what the trainer wrote ---------------------------------
        server = load_server(model, TRAIN_STEPS, device=dev)
        cam = Camera(viewmat=batch["viewmat"], K=batch["K"], width=w, height=h)
        rng = np.random.default_rng(1)
        pos = rng.normal(size=(1, 512)).astype(np.float32)
        neg = rng.normal(size=(3, 512)).astype(np.float32)
        rel = server.relevancy_map(cam, torch.as_tensor(pos / np.linalg.norm(pos), device=dev),
                                   torch.as_tensor(neg / np.linalg.norm(neg, axis=1, keepdims=True),
                                                   device=dev))
        if rel.shape != (1, h, w) or not torch.isfinite(rel).all():
            fail(f"relevancy of the trained model: {tuple(rel.shape)}, finite "
                 f"{bool(torch.isfinite(rel).all())}")
        print(f"# served the trained model dir: relevancy max {float(rel.max()):.4f}", flush=True)
        del server, state, feats, feat_map, batch, cache
        extra = after_serving(root, model)

    for r in report:
        r["launches"] = launches[r["name"]]
        r["launches_per_step"] = launches[r["name"]] / TRAIN_STEPS
        r["check"] = "ok"
        with_bound(r)
    report[0]["train_steps"] = steps
    return report, extra


K7_SHAPES = (("1280x720/250k", 1280, 720, 250_000), ("1920x1080/1M", 1920, 1080, 1_000_000))
STATS_MOVED_TILES = 2  # tiles whose stop may move at a threshold flip (of 920)
SAT_GAUSSIANS = 16_000  # the saturated frame: tens of its 920 tiles stop early


def k7_phase(dev: torch.device, gpu: str) -> dict:
    """Phase 9b (a): K7 against its plain version on a real projection at
    the serve shape and at 1080p/1M (the shape whose packing needs JAX's
    u32 key tier), cull off and on: keys and counts exact, the fused
    binning equal to the K6 binning field by field, fewer instances with
    the cull, K5's image the same with the cull off and on; K7's time,
    bound, plain time and the unfused chain's time (K6 + gathers + key
    ops, the yardstick: no single PyTorch call computes K7)."""
    from gags_torch.splat import kernels, tiles
    from gags_torch.splat.projection import project_gaussians
    from gags_torch.splat.rasterizer import RasterizeConfig, _cull_rows, _geom_table, order_ext
    from gags_torch.utils.synthetic import make_camera, make_scene

    cfg = RasterizeConfig(aligned=False)
    th, tw = cfg.tile_h, cfg.tile_w
    out = {}
    for label, w, h, n in K7_SHAPES:
        raw = make_scene(n, seed=0, extent=3.0)
        t = {k: torch.as_tensor(raw[k], device=dev)
             for k in ("means", "quats", "scales", "opacities", "features")}
        del raw
        cam = make_camera(w, h, device=dev)
        with torch.no_grad():
            proj = project_gaussians(t["means"], t["quats"], t["scales"], cam.viewmat, cam.K, w,
                                     h, opacities=t["opacities"])
            tx, ty = -(-w // tw), -(-h // th)
            order, packed_p, offsets, inc = tiles.depth_ranks(
                proj.means2d, proj.radii_x, proj.depths, tw, th, tx, ty, radii_y=proj.radii_y)
            budget = cfg.instance_budget(n)
            mk = tiles.expansion_slots(budget, cfg.chunk)
            shift = max(1, n.bit_length())
            cull_rows = _cull_rows(proj, t["opacities"])
            geom = _geom_table(proj, t["opacities"])
        bins, images = {}, {}
        for cull in (False, True):
            what = f"K7 expand_keys {label} cull {'on' if cull else 'off'}"
            bins[cull] = {fused: tiles.bin_gaussians(
                proj.means2d, proj.radii_x, proj.depths, w, h, tw, th, budget=budget,
                chunk=cfg.chunk, radii_y=proj.radii_y, cull_rows=cull_rows if cull else None,
                fused_keys=fused) for fused in (False, True)}
            for field in ("inst_gid", "tile_starts", "tile_counts", "num_valid", "overflow",
                          "order"):
                if not torch.equal(getattr(bins[cull][False], field),
                                   getattr(bins[cull][True], field)):
                    fail(f"{what}: the fused binning's {field} differs from the K6 binning's")
            b = bins[cull][True]
            if int(b.overflow) != 0:
                fail(f"{what}: overflow {int(b.overflow)}")
            nv = bins[False][True].num_valid  # the uncut count: K7's input
            kw = dict(shift=shift, tiles_x=tx, tile_w=tw, tile_h=th,
                      cull_p=cull_rows[order].contiguous() if cull else None)
            a = (offsets, packed_p, nv, mk)
            keys, counts = kernels.expand_keys(*a, **kw)
            keys_p, counts_p = kernels.expand_keys_plain(*a, **kw)
            torch.cuda.synchronize()
            if not (torch.equal(keys, keys_p) and torch.equal(counts, counts_p)):
                fail(f"{what}: keys differ from the plain version at "
                     f"{int((keys != keys_p).sum())} of {mk} slots, counts at "
                     f"{int((counts != counts_p).sum())} chunks")
            if int(counts.sum()) != int(b.num_valid):
                fail(f"{what}: counts sum {int(counts.sum())} != num_valid {int(b.num_valid)}")
            perm = order_ext(b.order.long())
            cols = torch.cat([t["features"], torch.zeros((1, 16), device=dev)])[perm].contiguous()
            images[cull] = kernels.blend_forward(geom[perm].contiguous(), cols, b.inst_gid,
                                                 b.tile_starts, b.tile_counts,
                                                 torch.zeros(16, device=dev), tx, ty, th, tw)
            nbytes = n * (8 + (24 if cull else 0)) + 4 + mk * 8 + (mk // 1024) * 4
            ops = mk * (4 * int(n).bit_length() + 20 + (70 if cull else 0))
            r = dict(
                instances=int(b.num_valid), slots=mk, ranks=n,
                # device time per launch (torch.profiler); events_ms, back to
                # back launches between CUDA events, is the host's launch rate
                ms=device_ms(lambda: kernels.expand_keys(*a, **kw)),
                events_ms=cuda_ms(lambda: kernels.expand_keys(*a, **kw), 500, warmup=50),
                plain_ms=device_ms(lambda: kernels.expand_keys_plain(*a, **kw)),
                chain_ms=device_ms(lambda: kernels.slot_keys(kernels.expand_gid(offsets, mk),
                                                             offsets, packed_p, nv, **kw)),
                chain_events_ms=cuda_ms(lambda: kernels.slot_keys(
                    kernels.expand_gid(offsets, mk), offsets, packed_p, nv, **kw), 50),
                bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3, ops_ms=ops / FP32_OPS_PER_S * 1e3)
            with_bound(r)
            out[f"{label}, cull {'on' if cull else 'off'}"] = r
            print(f"# {what}: exact; {r} ({gpu})", flush=True)
        if not int(bins[True][True].num_valid) < int(bins[False][True].num_valid):
            fail(f"K7 {label}: the cull kept {int(bins[True][True].num_valid)} of "
                 f"{int(bins[False][True].num_valid)} instances")
        same = torch.equal(images[True], images[False])
        if not same:  # a corner pixel at the alpha floor may flip (NUMERICS.md)
            flip_tolerant_compare(images[True], images[False], f"K5 image, {label}, cull on/off")
        n_diff = int((images[True] != images[False]).sum())
        out[f"{label}, cull on"]["image_values_changed_by_cull"] = n_diff
        print(f"# K5 image at {label} with the cull on and off: identical {same} "
              f"({n_diff} values differ)", flush=True)
        del t, proj, bins, images, geom, cull_rows, keys, keys_p, order, packed_p, offsets, inc
        torch.cuda.empty_cache()
    return out


def saturated_frame(dev: torch.device) -> tuple:
    """K5's arguments on a 1280x720 frame whose centre tiles saturate: the
    card test's dense, near-opaque scene (extent 0.6, scales x3, opacities
    0.9-0.9999) at the serve width. No tile of the serve frame stops
    early, so there the counters' stop lanes (0, 2) equal their totals."""
    from gags_torch.splat.rasterizer import RasterizeConfig, _prepare, order_ext
    from gags_torch.utils.synthetic import make_camera, make_scene

    raw = make_scene(SAT_GAUSSIANS, seed=1, extent=0.6)
    raw["opacities"] = np.random.default_rng(1).uniform(0.9, 0.9999, SAT_GAUSSIANS).astype(
        np.float32)
    raw["scales"] *= 3.0
    t = {k: torch.as_tensor(v, device=dev) for k, v in raw.items()}
    cam = make_camera(WIDTH, HEIGHT, device=dev)
    cfg = RasterizeConfig(aligned=False, budget_factor=16)  # ~10 tiles per splat
    _, b, geom, tx, ty = _prepare(t["means"], t["quats"], t["scales"], t["opacities"],
                                  cam.viewmat, cam.K, WIDTH, HEIGHT, cfg)
    if int(b.overflow) != 0:
        fail(f"saturated frame: binning overflow {int(b.overflow)}")
    perm = order_ext(b.order.long())
    cols = torch.cat([t["features"], torch.zeros((1, 16), device=dev)])[perm].contiguous()
    return (geom[perm].contiguous(), cols, b.inst_gid, b.tile_starts, b.tile_counts,
            torch.zeros(16, device=dev), tx, ty, cfg.tile_h, cfg.tile_w)


def exit_stats_compare(st_k: torch.Tensor, st_p: torch.Tensor, what: str) -> dict:
    """K5's (T, 8, 128) counters against the plain version's: nothing
    outside row 0, lanes 0-4; the totals (lanes 1, 3) exact; the stop
    lanes (0, 2) exact on all but STATS_MOVED_TILES tiles (a threshold
    flip moves a stop); lane 4 within 1e-4 on the others."""
    s, sp = st_k[:, 0, :5], st_p[:, 0, :5]
    if st_k[:, 1:].any() or st_k[:, 0, 5:].any():
        fail(f"{what}: exit_stats writes outside row 0, lanes 0-4")
    if not (torch.equal(s[:, 1], sp[:, 1]) and torch.equal(s[:, 3], sp[:, 3])):
        fail(f"{what}: exit_stats totals (lanes 1, 3) differ from the plain version")
    moved = (s[:, 0] != sp[:, 0]) | (s[:, 2] != sp[:, 2])
    lane4 = float((s[~moved, 4] - sp[~moved, 4]).abs().max())
    r = dict(tiles=int(s.shape[0]), tiles_moved=int(moved.sum()), lane4_max_abs_err=lane4,
             tiles_stopped_early=int((s[:, 2] < s[:, 3]).sum()),
             plain_tiles_stopped_early=int((sp[:, 2] < sp[:, 3]).sum()),
             chunks_done=int(s[:, 2].sum()), chunks_total=int(s[:, 3].sum()))
    if r["tiles_moved"] > STATS_MOVED_TILES or lane4 > 1e-4:
        fail(f"{what}: exit_stats disagree with the plain version: {r}")
    return r


def k5_options_phase(serve: dict, gpu: str) -> dict:
    """Phase 9b (b): K5's options against their plain versions on the
    serve frame (16 feature channels): fast_color_rows with exit_stats and
    blend_bf16 at phase 4's tolerance, blend_bf16 also against the f32
    image at its contract, the counters exact but for STATS_MOVED_TILES,
    block_exit bit-identical; then the counters once more on the
    saturated frame, where some tile must stop early."""
    from gags_torch.splat import kernels

    args, chunk = serve["args"], serve["chunk"]
    c = args[1].shape[1]
    f32 = kernels.blend_forward(*args)
    res = {"f32": dict(ms=cuda_ms(lambda: kernels.blend_forward(*args), 20))}
    if not torch.equal(kernels.blend_forward(*args, block_exit=True), f32):
        fail("K5 block_exit changes the image")
    out_k, st_k = kernels.blend_forward(*args, fast_color_rows=True, exit_stats=True, chunk=chunk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_p, st_p = kernels.blend_forward_plain(*args, fast_color_rows=True, exit_stats=True,
                                              chunk=chunk)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    if not torch.equal(out_k, kernels.blend_forward(*args, fast_color_rows=True)):
        fail("K5 exit_stats changes the image")
    res["fast_color_rows"] = dict(
        ms=cuda_ms(lambda: kernels.blend_forward(*args, fast_color_rows=True), 20),
        plain_ms=plain_ms, **flip_tolerant_compare(out_k, out_p, f"K5 fast_color_rows C={c}"))
    res["exit_stats"] = dict(
        ms=cuda_ms(lambda: kernels.blend_forward(*args, fast_color_rows=True, exit_stats=True,
                                                 chunk=chunk), 20),
        **exit_stats_compare(st_k, st_p, "K5 serve frame"))
    print(f"# K5 exit_stats: {res['exit_stats']} ({gpu})", flush=True)

    sat = saturated_frame(args[0].device)
    out_s, st_s = kernels.blend_forward(*sat, exit_stats=True, chunk=chunk)
    out_sp, st_sp = kernels.blend_forward_plain(*sat, exit_stats=True, chunk=chunk)
    torch.cuda.synchronize()
    if not torch.equal(out_s, kernels.blend_forward(*sat)):
        fail("K5 exit_stats changes the saturated frame's image")
    r = dict(instances=int(sat[4].sum()), **exit_stats_compare(st_s, st_sp, "K5 saturated frame"),
             **flip_tolerant_compare(out_s, out_sp, "K5 saturated frame C=16"))
    res["exit_stats_saturated"] = r
    print(f"# K5 exit_stats on the saturated frame ({SAT_GAUSSIANS} splats): {r} ({gpu})",
          flush=True)
    if r["tiles_stopped_early"] <= 0:
        fail(f"K5 saturated frame: no tile stopped early, the stop lanes went untested: {r}")
    del sat, out_s, st_s, out_sp, st_sp
    out_b = kernels.blend_forward(*args, blend_bf16=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_bp = kernels.blend_forward_plain(*args, blend_bf16=True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    res["blend_bf16"] = dict(ms=cuda_ms(lambda: kernels.blend_forward(*args, blend_bf16=True), 20),
                             plain_ms=plain_ms,
                             **flip_tolerant_compare(out_b, out_bp, f"K5 blend_bf16 C={c}"))
    scale = float(f32[..., :c].abs().max())
    d = (out_b[..., :c] - f32[..., :c]).abs()
    contract = dict(max_rel=float(d.max()) / scale, mean_rel=float(d.mean()) / scale,
                    alpha_max_abs=float((out_b[..., c] - f32[..., c]).abs().max()))
    res["blend_bf16"]["vs_f32"] = contract
    print(f"# K5 blend_bf16 vs the f32 image: {contract} (contract 5e-2, 5e-3, 0.03)", flush=True)
    if contract["max_rel"] > 5e-2 or contract["mean_rel"] > 5e-3 or contract["alpha_max_abs"] > 0.03:
        fail(f"K5 blend_bf16 breaks its contract against f32: {contract}")
    print(f"# K5 options at 1280x720, C={c}: f32 {res['f32']['ms']:.4f} ms, bf16 rows "
          f"{res['fast_color_rows']['ms']:.4f} ms, bf16 blend {res['blend_bf16']['ms']:.4f} ms, "
          f"with exit_stats {res['exit_stats']['ms']:.4f} ms ({gpu})", flush=True)
    return res


def render_cli_phase(root: str, model: str, dev: torch.device, gpu: str) -> dict:
    """Phase 9b (c): gags_torch.cli.render on phase 7's model dir, its four
    cameras at 1280x720 (-r 1): RGB+ED, then --feature_mode --feature_npy
    --autotune, each with the launch counts set to 0 just before and read
    just after; then the same cameras with fused_keys and tile_cull: K7
    once per frame, the images equal to the unfused render's. The
    autotune store is a file beside `root` for this phase only: a winner
    persisted by an earlier run of this checkout would skip the timing,
    and with it K7's launches."""
    from gags_torch.cli import render as rcli
    from gags_torch.scene.dataset import camera_from_info, detect_and_load
    from gags_torch.scene.gaussian_data import GaussianScene
    from gags_torch.splat import autotune, kernels
    from gags_torch.splat.rasterizer import RasterizeConfig
    from gags_torch.splat.render import render

    runs = {}
    store = autotune.PERSIST_PATH
    autotune.PERSIST_PATH = os.path.join(os.path.dirname(root), "tune_cache.json")
    autotune._CACHE.clear()
    try:
        for label, kw in (("RGB+ED", dict(render_mode="RGB+ED")),
                          ("features", dict(feature_mode=True, feature_npy=True, autotune=True))):
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            runs[label] = rcli.run(model, root, TRAIN_STEPS, resolution=1, device=str(dev),
                                   **kw)["train"]
            torch.cuda.synchronize()
            runs[label]["launches"] = {k: v for k, v in kernels.launch_counts.items() if v}
    finally:
        autotune.PERSIST_PATH = store
    for label, rep in runs.items():
        launches = rep["launches"]
        print(f"# render CLI {label}: {rep['frames']} frames at {TRAIN_SRC_W}x{TRAIN_SRC_H}, "
              f"{rep['frames_per_s']:.2f} frames/s ({rep['seconds']:.2f} s, PNG/npy writes "
              f"included), autotune {rep['autotune'] or 'not asked'}, K7 launches "
              f"{launches.get('expand_keys', 0)}, launches {launches} ({gpu})", flush=True)
        if launches.get("blend_forward", 0) < rep["frames"]:
            fail(f"render CLI {label}: K5 launched {launches.get('blend_forward', 0)} times for "
                 f"{rep['frames']} frames")
        if launches.get("expand_gid", 0) + launches.get("expand_keys", 0) < rep["frames"]:
            fail(f"render CLI {label}: neither K6 nor K7 bins every frame: {launches}")
    if "winner" not in runs["features"]["autotune"]:
        fail(f"the render CLI's --autotune timed nothing: {runs['features']['autotune']}")
    if runs["features"]["launches"].get("expand_keys", 0) <= 0:
        fail("K7 expand_keys was not launched by the render CLI's autotune")
    base = os.path.join(model, "train", f"ours_{TRAIN_STEPS}")
    info = detect_and_load(root, foundation_model="none")
    names = [os.path.splitext(ci.name)[0] for ci in info.train_cameras]
    for name in names:
        depth = np.load(os.path.join(base, "depth", name + "_depth.npy"))
        fmap = np.load(os.path.join(base, "saved_feature", name + "_fmap_CxHxW.npy"))
        if depth.shape != (TRAIN_SRC_H, TRAIN_SRC_W) or not np.isfinite(depth).all():
            fail(f"render CLI depth {name}: {depth.shape}")
        if fmap.shape != (16, TRAIN_SRC_H, TRAIN_SRC_W) or not np.isfinite(fmap).all():
            fail(f"render CLI feature map {name}: {fmap.shape}")
        for sub in ("renders", "depth", "feature_pca", "scale_map"):
            path = os.path.join(base, sub, name + ("_depth" if sub == "depth" else "") + ".png")
            with open(path, "rb") as f:
                if f.read(8) != b"\x89PNG\r\n\x1a\n":
                    fail(f"render CLI wrote no PNG at {path}")

    scene = GaussianScene.from_ply(os.path.join(model, "point_cloud", f"iteration_{TRAIN_STEPS}",
                                                "point_cloud.ply"), device=dev)
    cams = [camera_from_info(ci, 1) for ci in info.train_cameras]
    geo = dict(means=scene.means, quats=scene.quats, scales=scene.scales,
               opacities=scene.opacities, semantic_features=scene.semantic_features,
               feature_mode=True, bg_color=torch.zeros(3, device=dev), device=dev)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    fused = [render(cam, config=RasterizeConfig(aligned=False, fused_keys=True, tile_cull=True),
                    **geo).render for cam in cams]
    torch.cuda.synchronize()
    k7 = kernels.launch_counts["expand_keys"]
    if k7 != len(cams) or kernels.launch_counts["expand_gid"] != 0:
        fail(f"fused render: K7 launched {k7} times for {len(cams)} frames "
             f"(K6 {kernels.launch_counts['expand_gid']})")
    n_diff = 0
    for i, cam in enumerate(cams):
        ref = render(cam, config=RasterizeConfig(aligned=False), **geo).render
        if not torch.equal(fused[i], ref):
            flip_tolerant_compare(fused[i], ref, f"fused + culled render, camera {i}")
            n_diff += int((fused[i] != ref).sum())
    print(f"# fused_keys + tile_cull render of {len(cams)} cameras: K7 launched {k7} times; "
          f"{n_diff} values differ from the unfused render", flush=True)
    return dict(runs=runs, fused_render_launches=k7, fused_render_values_changed=n_diff)


def options_phase(root: str, model: str, dev: torch.device, gpu: str, serve: dict) -> dict:
    """Phase 9b: K7 (a), K5's options (b), the render CLI (c)."""
    return dict(k7=k7_phase(dev, gpu), k5=k5_options_phase(serve, gpu),
                render=render_cli_phase(root, model, dev, gpu))


def encode_png_paeth(a: np.ndarray) -> bytes:
    """(H, W, 3) uint8 → an RGB PNG whose every row has filter 4 (Paeth),
    the filter that libpng and PIL choose for most rows of a photograph."""
    h, w, _ = a.shape
    x = a.astype(np.int32)
    left = np.pad(x, ((0, 0), (1, 0), (0, 0)))[:, :-1]
    up = np.pad(x, ((1, 0), (0, 0), (0, 0)))[:-1]
    ul = np.pad(x, ((1, 0), (1, 0), (0, 0)))[:-1, :-1]
    p = left + up - ul
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
    pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
    rows = np.concatenate([np.full((h, 1), 4, np.uint8),
                           ((x - pred) & 0xFF).astype(np.uint8).reshape(h, w * 3)], axis=1)

    def chunk(tag, data):
        return (len(data).to_bytes(4, "big") + tag + data
                + (zlib.crc32(tag + data) & 0xFFFFFFFF).to_bytes(4, "big"))

    ihdr = w.to_bytes(4, "big") + h.to_bytes(4, "big") + bytes([8, 2, 0, 0, 0])
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + chunk(b"IEND", b""))


def write_rgb_fixture(root: str, dev: torch.device) -> None:
    """The RGB pretraining scene on disk, written with the port's own
    writers: ground-truth PNGs of make_scene(300_000) with SH-3 colours
    rendered by the port (K5) from RGB_CAMERAS PINHOLE cameras around the
    bench camera, and an SfM seed cloud of RGB_SEED_POINTS of its means plus
    N(0, 0.01) noise with their dc colours. Camera 0's image is also
    written Paeth-filtered beside the scene, and read_png's decode of it is
    timed and held to the pixels."""
    import math

    from gags_torch.core.camera import Camera, look_at
    from gags_torch.core.sh import SH_C0
    from gags_torch.scene import colmap as cm
    from gags_torch.scene.ply import write_points3d_ply
    from gags_torch.splat.rasterizer import RasterizeConfig
    from gags_torch.splat.render import render
    from gags_torch.utils.image import encode_png, read_png
    from gags_torch.utils.synthetic import make_scene

    rng = np.random.default_rng(0)
    sparse = os.path.join(root, "sparse", "0")
    images = os.path.join(root, "images")
    os.makedirs(sparse)
    os.makedirs(images)
    w, h = WIDTH, HEIGHT
    fx = w / (2 * math.tan(math.radians(30.0)))  # make_camera's 60 degree field of view
    K = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1]], np.float32)
    raw = make_scene(TRAIN_N, seed=0, extent=3.0)
    t = {k: torch.as_tensor(v, device=dev) for k, v in raw.items()}
    imgs = {}
    for i in range(RGB_CAMERAS):
        ang = 2 * np.pi * i / RGB_CAMERAS
        eye = np.array([0.25 * np.cos(ang), 0.15 * np.sin(ang), -0.2])
        vm = look_at(eye, np.array([0.0, 0.0, 6.0]), np.array([0.0, -1.0, 0.0])).astype(np.float64)
        imgs[i + 1] = cm.ColmapImage(i + 1, cm.rotmat_to_qvec(vm[:3, :3]), vm[:3, 3], 1,
                                     f"cam{i:02d}.png")
        cam = Camera(viewmat=torch.as_tensor(vm, dtype=torch.float32), K=torch.as_tensor(K),
                     width=w, height=h)
        out = render(cam, means=t["means"], quats=t["quats"], scales=t["scales"],
                     opacities=t["opacities"], sh=t["sh"], sh_degree=3,
                     bg_color=torch.zeros(3, device=dev),
                     config=RasterizeConfig(aligned=False), device=dev)
        with open(os.path.join(images, f"cam{i:02d}.png"), "wb") as f:
            f.write(encode_png(out.render.cpu().numpy()))
        if i == 0:
            px = read_png(os.path.join(images, "cam00.png"))
            paeth = os.path.join(root, "cam00_paeth.png")
            with open(paeth, "wb") as f:
                f.write(encode_png_paeth(px))
            t0 = time.perf_counter()
            got = read_png(paeth)
            png_s = time.perf_counter() - t0
            if not np.array_equal(got, px):
                fail("read_png decodes a Paeth-filtered PNG to other pixels")
            print(f"# read_png: a Paeth-filtered {w}x{h} RGB PNG decoded in {png_s:.3f} s "
                  f"(host CPU)", flush=True)
    cm.write_cameras_binary(os.path.join(sparse, "cameras.bin"),
                            {1: cm.ColmapCamera(1, "PINHOLE", w, h, np.array([fx, fx, w / 2, h / 2]))})
    cm.write_images_binary(os.path.join(sparse, "images.bin"), imgs)
    pick = rng.choice(TRAIN_N, RGB_SEED_POINTS, replace=False)
    xyz = raw["means"][pick] + rng.normal(0, 0.01, size=(RGB_SEED_POINTS, 3)).astype(np.float32)
    rgb = np.clip(SH_C0 * raw["sh"][pick, 0] + 0.5, 0.0, 1.0)
    write_points3d_ply(os.path.join(sparse, "points3D.ply"), xyz, rgb)


def rgb_phase(dev: torch.device, gpu: str) -> dict:
    """Phases 10-13: RGB pretraining through cli.train_rgb.run at 1280x720,
    the step's times and profile, K8 against its plain version on the
    trained state with the loss's real cotangents, and the snapshot PLY
    rendered. Returns K8's report entry and K3's at the RGB widths."""
    import dataclasses

    from gags_torch.cli.train_rgb import RunConfig, run
    from gags_torch.core.sh import sh_colors
    from gags_torch.rgb.train import RgbConfig, make_rgb_step
    from gags_torch.scene.dataset import camera_from_info, detect_and_load
    from gags_torch.scene.gaussian_data import GaussianScene
    from gags_torch.splat import kernels
    from gags_torch.splat.rasterizer import _prepare, order_ext, rasterize
    from gags_torch.splat.render import render
    from gags_torch.utils.image import load_rgb
    from gags_torch.scene.ply import read_points3d_ply
    from gags_torch.utils.metrics import psnr, ssim

    with tempfile.TemporaryDirectory() as tmp:
        root, model = os.path.join(tmp, "scene"), os.path.join(tmp, "model")
        t0 = time.perf_counter()
        write_rgb_fixture(root, dev)
        print(f"# RGB fixture written in {time.perf_counter() - t0:.1f} s", flush=True)

        # -- 10. train through the entry point -------------------------------
        cfg = RgbConfig(densify_from_iter=50, densification_interval=100,
                        densify_until_iter=RGB_STEPS)
        rc = RunConfig(source_path=root, model_path=model, resolution=1, iterations=RGB_STEPS,
                       save_iterations=str(RGB_STEPS), capacity_factor=4, sh_degree=3,
                       device=str(dev))
        metrics = []

        def on_step(it, state, m):
            if m is not None:
                metrics.append(m)

        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        state = run(rc, cfg, on_step=on_step)
        torch.cuda.synchronize()
        launches = dict(kernels.launch_counts)
        run_s = time.perf_counter() - t0
        print(f"# launches during RGB training: {launches}")
        for name, least in (("blend_forward_aligned", RGB_STEPS), ("expand_gid", RGB_STEPS),
                            ("blend_backward_full", RGB_STEPS),
                            ("sorted_segment_sum", 2 * RGB_STEPS)):
            if launches[name] < least:
                fail(f"{name} launched {launches[name]} times in {RGB_STEPS} RGB steps "
                     f"(at least {least} expected)")
        losses = np.array([float(m["loss"]) for m in metrics])
        alive = [int(m["n_alive"]) for m in metrics]
        if len(losses) != RGB_STEPS or not np.all(np.isfinite(losses)):
            fail(f"RGB training losses {losses}")
        first, last = losses[:20].mean(), losses[-20:].mean()
        if not last < first:
            fail(f"RGB loss did not fall: first 20 mean {first}, last 20 mean {last}")
        for it in range(cfg.densify_from_iter + 1, RGB_STEPS):
            if it % cfg.densification_interval == 0:
                print(f"# densify at {it}: n_alive {alive[it - 1]} -> {alive[it]} "
                      f"of {state.capacity} slots")
        print(f"# RGB: {RGB_STEPS} steps in {run_s:.1f} s (set-up included); loss "
              f"first-20 mean {first:.5f} -> last-20 mean {last:.5f} ({gpu})", flush=True)

        # -- 11. time the step at SH degree 3 ----------------------------------
        info = detect_and_load(root, foundation_model="none")
        cams = [camera_from_info(ci, 1).to(dev) for ci in info.train_cameras]
        imgs = [torch.as_tensor(load_rgb(ci.image_path, c.width, c.height), device=dev)
                .to(torch.float32) / 255.0 for ci, c in zip(info.train_cameras, cams)]
        w, h = cams[0].width, cams[0].height
        step = make_rgb_step(cfg, w, h, spatial_scale=info.radius)
        batches = [dict(viewmat=c.viewmat, K=c.K, image=im) for c, im in zip(cams, imgs)]
        events = [torch.cuda.Event(enable_timing=True) for _ in range(RGB_TIMED + 1)]
        step(state, batches[0], 1e-5, 3)  # warm the SH-3 path
        torch.cuda.synchronize()
        events[0].record()
        for i in range(RGB_TIMED):
            step(state, batches[i % len(batches)], 1e-5, 3)
            events[i + 1].record()
        torch.cuda.synchronize()
        step_ms = np.array([events[i].elapsed_time(events[i + 1]) for i in range(RGB_TIMED)])
        steps = dict(median_ms=float(np.median(step_ms)), p90_ms=float(np.percentile(step_ms, 90)),
                     steps=RGB_TIMED, n_alive=int(state.alive.sum()), slots=state.capacity)
        steps["host_syncs"] = count_syncs(lambda: step(state, batches[1], 1e-5, 3))
        print(f"# RGB step at SH 3, {w}x{h}: {steps} ({gpu})", flush=True)
        steps.update(profile_request(lambda: step(state, batches[0], 1e-5, 3),
                                     f"RGB step {w}x{h} / {steps['n_alive']} alive", top=16))

        # -- 12. K8 vs its plain version on camera 0 ---------------------------
        p = state.params
        geo = (p["means"], p["quats"], torch.exp(p["scales_raw"]),
               torch.sigmoid(p["opacities_raw"]))
        vm, K = batches[0]["viewmat"], batches[0]["K"]
        raster = cfg.raster
        with torch.no_grad():
            for factor in (raster.budget_factor, 2 * raster.budget_factor):
                raster = dataclasses.replace(raster, budget_factor=factor)
                _, b, geom, tx, ty = _prepare(*geo, vm, K, w, h, raster)
                if int(b.overflow) == 0:
                    break
            else:
                fail(f"camera 0 binning overflow {int(b.overflow)} at budget factor {factor}")
        colors = sh_colors(3, state.sh, p["means"], -(vm[:3, :3].T @ vm[:3, 3])).detach()
        leaf = colors.clone().requires_grad_(True)
        tap = torch.zeros((state.capacity, 2), device=dev, requires_grad=True)
        res = rasterize(*geo, leaf, vm, K, w, h, background=torch.zeros(3, device=dev),
                        config=raster, means2d_tap=tap, device=dev)
        img = res.image
        img.retain_grad()
        l1 = torch.mean(torch.abs(img - batches[0]["image"]))
        (0.8 * l1 + 0.2 * (1.0 - ssim(img, batches[0]["image"]))).backward()
        th, tw = raster.tile_h, raster.tile_w
        g_img = image_to_tiles(img.grad, tx, ty, th, tw)
        # K8 is linear in the cotangents: scaled to max |g| = 1; the loss
        # does not read alpha and the background is 0, so g_alpha is 0
        g_max = g_img.abs().max()
        g_img = (g_img / g_max).contiguous()
        g_alpha = torch.zeros_like(g_img[..., :1])
        perm = order_ext(b.order.long())
        geom_p = geom[perm].contiguous()
        cols_p = torch.cat([colors, torch.zeros((1, 3), device=dev)])[perm].contiguous()
        a8 = (geom_p, cols_p, b.inst_gid, b.tile_starts, b.tile_counts, g_img, g_alpha,
              tx, ty, th, tw)
        got = kernels.blend_backward_full(*a8)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want_col, want_geo, walked, blended = kernels.blend_backward_full_plain(
            *a8, return_pairs=True)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        # dL/dmeans2d, the densification signal: the plain version's mx and
        # my rows summed per Gaussian in float64 (slots of the sentinel rank
        # n dropped), against the tap's gradient through K8 and K3
        n_g = geo[0].shape[0]
        rank_sum = torch.zeros((n_g + 1, 2), dtype=torch.float64, device=dev).index_add_(
            0, b.inst_gid.long(), want_geo[:, :2].double())
        want_tap = torch.zeros((n_g, 2), dtype=torch.float64, device=dev).index_copy_(
            0, b.order.long(), rank_sum[:n_g]) * g_max.double()
        if bool(got[1][:, 6:].any()):
            fail("K8 blend_backward_full writes geometry rows 6-7")
        cmp8 = {}
        for what, g, wnt in ([(f"colour {j}", got[0][:, j], want_col[:, j]) for j in range(3)]
                             + [(name, got[1][:, j], want_geo[:, j]) for j, name in
                                enumerate(("mx", "my", "ca", "cb", "cc", "opacity"))]
                             + [(f"tap {name}", tap.grad[:, j].double(), want_tap[:, j])
                                for j, name in enumerate(("x", "y"))]):
            # the CPU test's tolerance, column by column (the conic columns
            # are thousands of times larger than mx, my and opacity): at
            # most 0.1% of values outside 1e-5 max|g| + 1e-4 rel (isolated
            # threshold flips, atomics in no fixed order), mean error at
            # most 1e-5 max|g| and 1e-3 mean|g|
            scale = float(wnt.abs().max())
            err = (g - wnt).abs()
            c = {"max_abs_err": float(err.max()), "mean_abs_err": float(err.mean()),
                 "frac_outside": float((err > 1e-5 * scale + 1e-4 * wnt.abs()).float().mean()),
                 "max_abs_grad": scale, "mean_abs_grad": float(wnt.abs().mean())}
            print(f"# K8 blend_backward_full {what}: {c}", flush=True)
            if (not torch.isfinite(g).all() or scale == 0 or c["frac_outside"] > 1e-3
                    or c["mean_abs_err"] > 1e-5 * scale
                    or c["mean_abs_err"] > 1e-3 * c["mean_abs_grad"]):
                fail(f"K8 blend_backward_full {what} disagrees with its plain version: {c}")
            cmp8[what] = c
        nbytes = (geom_p.numel() + cols_p.numel() + b.inst_gid.numel() + 2 * b.tile_starts.numel()
                  + g_img.numel() + g_alpha.numel() + got[0].numel() + got[1].numel()) * 4
        # per walked pair and walk: the blend_common arithmetic (16); per
        # blended pair: walk A 5 + 2C, walk B ~40 + 4C (u, the prefix, the
        # chain rule, C + 6 products and their sums)
        ops = 2 * 16 * walked + (45 + 6 * 3) * blended
        k8 = dict(
            name="blend_backward_full", id="K8", route="cuda",
            source="gags_torch/splat/csrc/blend_backward_full.cu",
            replaces="gags_tpu/splat/pallas_kernel.py:1253",
            launches=launches["blend_backward_full"],
            launches_per_step=launches["blend_backward_full"] / RGB_STEPS,
            check="ok", max_abs_err=max(c["max_abs_err"] for k, c in cmp8.items()
                                         if not k.startswith("tap")),
            ms=cuda_ms(lambda: kernels.blend_backward_full(*a8), 10), plain_ms=plain_ms,
            bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3, ops_ms=ops / FP32_OPS_PER_S * 1e3,
            library_ms=None, pairs_walked=walked, pairs_blended=blended,
            instances=int(b.num_valid), slots=b.inst_gid.numel(), budget_factor=factor,
            check_resolution=f"{w}x{h}", by_output=cmp8, rgb_steps=steps,
            rgb_launches={k: v for k, v in launches.items() if v})
        with_bound(k8)
        print(f"# K8 blend_backward_full: ms {k8['ms']:.4f}, plain {plain_ms:.1f} ms, bound "
              f"{k8['bound_ms']:.4f} ms ({k8['bound_by']}), {walked} pairs walked, {blended} "
              f"blended, {k8['instances']} instances ({gpu})", flush=True)
        # K3 at the RGB widths, on K8's real colour and geometry rows, for
        # the n ranks (as _BlendFull's backward calls it)
        k3_rgb = {f"RGB C={r.shape[1]}": k3_check(kernels, r, b, n_g, f"RGB C={r.shape[1]}")
                  for r in got}
        del got, want_col, want_geo

        # -- 13. the snapshot PLY renders, closer to camera 0 than the seed --
        ply = os.path.join(model, "point_cloud", f"iteration_{RGB_STEPS}", "point_cloud.ply")
        scene = GaussianScene.from_ply(ply, device=dev)
        if scene.num_gaussians != alive[-1]:
            fail(f"snapshot holds {scene.num_gaussians} Gaussians, {alive[-1]} were alive")
        xyz, rgb, _ = read_points3d_ply(info.points_path)
        seed = GaussianScene.from_point_cloud(xyz, rgb, max_sh_degree=3, device=dev)
        db = {}
        for name, sc in (("seed", seed), ("snapshot", scene)):
            out = render(cams[0], means=sc.means, quats=sc.quats, scales=sc.scales,
                         opacities=sc.opacities, sh=sc.sh, sh_degree=3,
                         bg_color=torch.zeros(3, device=dev), device=dev)
            if out.render.shape != (h, w, 3) or not torch.isfinite(out.render).all():
                fail(f"{name} render {tuple(out.render.shape)} not finite")
            db[name] = float(psnr(out.render, batches[0]["image"]))
        if not db["snapshot"] > db["seed"]:
            fail(f"camera 0 PSNR of the snapshot {db['snapshot']} dB is not above the seed "
                 f"cloud's {db['seed']} dB")
        print(f"# snapshot PLY: {scene.num_gaussians} Gaussians, camera 0 PSNR "
              f"{db['snapshot']:.3f} dB (seed cloud {db['seed']:.3f} dB)", flush=True)
    return k8, k3_rgb


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA card")
    from gags_torch.cli.serve import SceneServer, encode_png, make_handler
    from gags_torch.utils.colormaps import apply_pca_colormap
    from gags_torch.models.decoders import FeatureDecoder
    from gags_torch.models.weights import scene_from_arrays
    from gags_torch.core.sh import sh_colors
    from gags_torch.splat import kernels, tiles
    from gags_torch.splat.projection import project_gaussians
    from gags_torch.splat.rasterizer import RasterizeConfig, _prepare, order_ext, rasterize
    from gags_torch.splat.reference import rasterize_reference
    from gags_torch.utils.synthetic import make_camera, make_scene

    gpu = gpu_line()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    print(f"# card: {gpu}", flush=True)
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    logs = kernels.build_all()
    print(f"# {len(logs)} kernel libraries ready in {time.perf_counter() - t0:.1f} s")
    for log in logs.values():
        for line in ptxas_summary(log):
            print(f"#   {line}")

    # -- scene ---------------------------------------------------------------
    raw = make_scene(N_GAUSSIANS, seed=0, extent=3.0)
    scene = scene_from_arrays(
        raw["means"], raw["quats"], np.log(raw["scales"]),
        np.log(raw["opacities"] / (1.0 - raw["opacities"])), raw["sh"],
        semantic_features=raw["features"], device=dev,
    )
    cam = make_camera(WIDTH, HEIGHT, device=dev)
    cfg = RasterizeConfig(aligned=False)  # the serving layout
    g = dict(means=scene.means, quats=scene.quats, scales=scene.scales,
             opacities=scene.opacities)
    proj, binned, geom, tx, ty = _prepare(
        g["means"], g["quats"], g["scales"], g["opacities"], cam.viewmat, cam.K,
        WIDTH, HEIGHT, cfg,
    )
    if int(binned.overflow) != 0:
        fail(f"binning overflow {int(binned.overflow)} at budget_factor {cfg.budget_factor}")
    print(f"# binning: {int(binned.num_valid)} instances, overflow 0, "
          f"{tx * ty} tiles of {cfg.tile_h}x{cfg.tile_w}")

    # -- 3. K6 -----------------------------------------------------------------
    _, _, offsets, _ = tiles.depth_ranks(
        proj.means2d, proj.radii_x, proj.depths, cfg.tile_w, cfg.tile_h, tx, ty,
        radii_y=proj.radii_y,
    )
    slots = tiles.expansion_slots(cfg.instance_budget(N_GAUSSIANS), cfg.chunk)
    gid_k = kernels.expand_gid(offsets, slots)
    gid_p = kernels.expand_gid_plain(offsets, slots)
    torch.cuda.synchronize()
    if not torch.equal(gid_k, gid_p):
        fail(f"expand_gid differs from its plain version at "
             f"{int((gid_k != gid_p).sum())} of {slots} slots")
    idx = torch.arange(slots, dtype=torch.int32, device=dev)
    k6 = dict(
        ms=cuda_ms(lambda: kernels.expand_gid(offsets, slots), 50),
        plain_ms=cuda_ms(lambda: kernels.expand_gid_plain(offsets, slots), 50),
        library_ms=cuda_ms(lambda: torch.searchsorted(offsets, idx, right=True), 50),
        # the same three as device time per call (torch.profiler): the events
        # above time back-to-back launches, which a few-microsecond kernel
        # behind a Python wrapper leaves host-bound
        device_ms=device_ms(lambda: kernels.expand_gid(offsets, slots)),
        plain_device_ms=device_ms(lambda: kernels.expand_gid_plain(offsets, slots)),
        library_device_ms=device_ms(lambda: torch.searchsorted(offsets, idx, right=True)),
    )
    k6_bytes = offsets.numel() * 4 + slots * 4
    k6_ops = slots * (int(offsets.numel()).bit_length() * 4 + 4)
    k6["bytes_ms"] = k6_bytes / HBM_BYTES_PER_S * 1e3
    k6["ops_ms"] = k6_ops / FP32_OPS_PER_S * 1e3
    print(f"# K6 expand_gid: {slots} slots over {offsets.numel()} ranks, exact; {k6}", flush=True)

    # -- 4. K5 -----------------------------------------------------------------
    perm = order_ext(binned.order.long())
    geom_p = geom[perm].contiguous()
    k5 = {}
    rgb_cols = sh_colors(scene.max_sh_degree, scene.sh, scene.means, cam.campos)
    for label, cols in (("features", scene.semantic_features), ("rgb", rgb_cols)):
        c = cols.shape[1]
        cols_p = torch.cat([cols, torch.zeros((1, c), device=dev)])[perm].contiguous()
        bg = torch.zeros((c,), device=dev)
        args = (geom_p, cols_p, binned.inst_gid, binned.tile_starts,
                binned.tile_counts, bg, tx, ty, cfg.tile_h, cfg.tile_w)
        out_k = kernels.blend_forward(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_p, walked, blended = kernels.blend_forward_plain(*args, return_pairs=True)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        cmp = flip_tolerant_compare(out_k, out_p, f"K5 blend_forward C={c} ({label})")
        nbytes = (geom_p.numel() + cols_p.numel() + binned.inst_gid.numel()
                  + 2 * binned.tile_starts.numel() + bg.numel() + out_k.numel()) * 4
        ops = 16 * walked + (4 + 2 * c) * blended
        k5[label] = dict(
            channels=c, ms=cuda_ms(lambda: kernels.blend_forward(*args), 20),
            plain_ms=plain_ms, pairs_walked=walked, pairs_blended=blended,
            bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3, ops_ms=ops / FP32_OPS_PER_S * 1e3,
            **cmp,
        )
        print(f"# K5 {label}: {k5[label]}", flush=True)
    del out_k, out_p

    # -- 5. serve --------------------------------------------------------------
    decoder = FeatureDecoder(generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    pos = rng.normal(size=(2, 512)).astype(np.float32)
    neg = rng.normal(size=(4, 512)).astype(np.float32)
    pos /= np.linalg.norm(pos, axis=1, keepdims=True)
    neg /= np.linalg.norm(neg, axis=1, keepdims=True)
    server = SceneServer(scene, decoder, text_embeds=(["query_a", "query_b"], pos, neg),
                         raster=cfg, device=dev)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    req = dict(viewmat=cam.viewmat.reshape(-1).tolist(), K=cam.K.reshape(-1).tolist(),
               width=WIDTH, height=HEIGHT)
    requests = [
        ("GET", "/health", None),
        ("POST", "/render", dict(req, mode="rgb")),
        ("POST", "/render", dict(req, mode="feature_pca")),
        ("POST", "/relevancy", dict(req, label="query_a")),
        ("POST", "/relevancy", dict(req, pos=pos[1].tolist(), neg=neg.tolist(), thresh=0.4)),
    ]
    replies = []
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        for method, path, body in requests:
            data = None if body is None else json.dumps(body).encode()
            r = urllib.request.Request(base + path, data=data, method=method,
                                       headers={"Content-Type": "application/json"})
            t0 = time.perf_counter()
            with urllib.request.urlopen(r, timeout=300) as resp:
                status, payload = resp.status, json.loads(resp.read())
            ms = (time.perf_counter() - t0) * 1e3
            replies.append((path, status, payload, ms))
            print(f"# {method} {path} {body.get('mode', body.get('label', 'pos/neg')) if body else ''}: "
                  f"status {status}, {ms:.1f} ms ({gpu})", flush=True)
        torch.cuda.synchronize()
        launches = dict(kernels.launch_counts)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    print(f"# launches during serving: {launches}")

    # -- 6. checks -------------------------------------------------------------
    for path, status, payload, _ in replies:
        if status != 200:
            fail(f"{path} returned {status}: {payload}")
    health = replies[0][2]
    if health["n_gaussians"] != N_GAUSSIANS or health["feature_dim"] != 16:
        fail(f"/health: {health}")
    for path, _, payload, _ in replies[1:3]:
        img = decode_png(payload["image_png"])
        if img.shape != (HEIGHT, WIDTH, 3) or img.max() == 0:
            fail(f"{path} {payload['mode']}: image {img.shape}, max {img.max()}")
    for path, _, payload, _ in replies[3:]:
        if not np.isfinite(payload["relevancy_max"]) or not 0 <= payload["relevancy_max"] <= 1:
            fail(f"{path}: relevancy_max {payload['relevancy_max']}")
        for key in ("heatmap_png", "mask_png"):
            if decode_png(payload[key]).shape != (HEIGHT, WIDTH, 3):
                fail(f"{path}: {key} shape")
    fmap = server.render_features(cam)
    if fmap.shape != (HEIGHT, WIDTH, 16) or not torch.isfinite(fmap).all():
        fail(f"feature map {tuple(fmap.shape)} not finite")
    direct = server.relevancy_map(cam, torch.as_tensor(pos[:1], device=dev),
                                  torch.as_tensor(neg, device=dev))
    if abs(float(direct.max()) - replies[3][2]["relevancy_max"]) > 1e-6:
        fail(f"served relevancy_max {replies[3][2]['relevancy_max']} != direct {float(direct.max())}")
    for name in ("expand_gid", "blend_forward"):
        if launches[name] <= 0:
            fail(f"{name} was not launched while serving")

    # where a request's time goes (outside the counted window)
    profile_request(lambda: server.render(dict(req, mode="rgb")), "/render rgb")
    profile_request(lambda: server.render(dict(req, mode="feature_pca")), "/render feature_pca")
    profile_request(lambda: server.relevancy(dict(req, label="query_a")), "/relevancy")
    rgb = server.render_rgb(cam).cpu().numpy()
    t0 = time.perf_counter()
    encode_png(rgb)
    png_ms = (time.perf_counter() - t0) * 1e3
    fmap_host = fmap.cpu().numpy()
    t0 = time.perf_counter()
    apply_pca_colormap(fmap_host, None)
    pca_ms = (time.perf_counter() - t0) * 1e3
    print(f"# host: encode_png 720p {png_ms:.1f} ms, apply_pca_colormap 720p x16 {pca_ms:.1f} ms")

    # the card's rasterize against the oracle on a small scene
    small = make_scene(3000, seed=1, extent=2.0, feature_dim=8)
    scam = make_camera(160, 96, device=dev)
    st = {k: torch.as_tensor(v, device=dev) for k, v in small.items()}
    res = rasterize(st["means"], st["quats"], st["scales"], st["opacities"], st["features"],
                    scam.viewmat, scam.K, 160, 96, config=RasterizeConfig(tile_h=16, tile_w=16, aligned=False),
                    device=dev)
    p = project_gaussians(st["means"], st["quats"], st["scales"], scam.viewmat, scam.K, 160, 96)
    ref_img, ref_alpha = rasterize_reference(p.means2d, p.conics, p.depths, p.radii,
                                             st["opacities"] * p.compensations, st["features"],
                                             160, 96)
    flip_tolerant_compare(res.image, ref_img, "rasterize vs oracle (3000 Gaussians, 160x96)")
    flip_tolerant_compare(res.alpha, ref_alpha, "rasterize alpha vs oracle")

    # -- 7-9. train, K1-K4, serve the trained model; 9b. inference options -------
    cols_f = torch.cat([scene.semantic_features, torch.zeros((1, 16), device=dev)])[perm]
    serve_k5 = dict(chunk=cfg.chunk, args=(
        geom_p, cols_f.contiguous(), binned.inst_gid, binned.tile_starts, binned.tile_counts,
        torch.zeros(16, device=dev), tx, ty, cfg.tile_h, cfg.tile_w))
    train_kernels, options = train_phase(
        dev, gpu, lambda root, model: options_phase(root, model, dev, gpu, serve_k5))
    del serve_k5, cols_f

    # -- 10-13. RGB pretraining, K8 ---------------------------------------------
    k8, k3_rgb = rgb_phase(dev, gpu)
    rgb_kernels = [k8]
    for r in k3_rgb.values():  # two launches a step: C = 3 and C = 8
        r["launches"] = k8["rgb_launches"]["sorted_segment_sum"] // 2
    k3 = next(r for r in train_kernels if r["id"] == "K3")
    k3["by_width"] = {"GAD C=16": {k: k3[k] for k in k3_rgb["RGB C=3"]}, **k3_rgb}

    # -- 14. report --------------------------------------------------------------
    f16 = k5["features"]
    keep = ("name", "id", "route", "source", "replaces", "launches", "check", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels_line = {"kernels": [
        {**{k: r[k] for k in keep}, **{k: v for k, v in r.items()
                                       if k not in keep and k not in ("bytes_ms", "ops_ms")}}
        for r in train_kernels + rgb_kernels
    ] + [
        {
            "name": "expand_gid", "id": "K6", "route": "cuda",
            "source": "gags_torch/splat/csrc/expand_gid.cu",
            "replaces": "gags_tpu/splat/pallas_kernel.py:1559",
            "launches": launches["expand_gid"], "check": "exact", "max_abs_err": 0.0,
            "ms": k6["ms"], "plain_ms": k6["plain_ms"],
            "bound_ms": max(k6["bytes_ms"], k6["ops_ms"]),
            "bound_by": "bytes" if k6["bytes_ms"] >= k6["ops_ms"] else "operations",
            "library_ms": k6["library_ms"], "slots": slots,
            **{k: k6[k] for k in ("device_ms", "plain_device_ms", "library_device_ms")},
        },
        {
            "name": "blend_forward", "id": "K5", "route": "cuda",
            "source": "gags_torch/splat/csrc/blend_forward.cu",
            "replaces": "gags_tpu/splat/pallas_kernel.py:719",
            "launches": launches["blend_forward"], "check": "ok",
            "max_abs_err": max(v["max_abs_err"] for v in k5.values()),
            "ms": f16["ms"], "plain_ms": f16["plain_ms"],
            "bound_ms": max(f16["bytes_ms"], f16["ops_ms"]),
            "bound_by": "bytes" if f16["bytes_ms"] >= f16["ops_ms"] else "operations",
            "library_ms": None,
            "by_option": options["k5"],
            "by_channels": {
                str(v["channels"]): {
                    "ms": v["ms"], "plain_ms": v["plain_ms"],
                    "bound_ms": max(v["bytes_ms"], v["ops_ms"]),
                    "pairs_walked": v["pairs_walked"], "pairs_blended": v["pairs_blended"],
                    "max_abs_err": v["max_abs_err"], "mean_abs_err": v["mean_abs_err"],
                }
                for v in k5.values()
            },
        },
    ]}
    k7 = options["k7"]
    head = k7["1280x720/250k, cull off"]
    render_runs = options["render"]["runs"]
    kernels_line["kernels"].append({
        "name": "expand_keys", "id": "K7", "route": "cuda",
        "source": "gags_torch/splat/csrc/expand_keys.cu",
        "replaces": "gags_tpu/splat/pallas_kernel.py:1763",
        "launches": sum(r["launches"].get("expand_keys", 0) for r in render_runs.values()),
        "check": "exact", "max_abs_err": 0.0,
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": None, "yardstick_ms": head["chain_ms"],
        "yardstick": "the unfused chain it replaces: K6 + gathers + key ops (kernels.slot_keys)",
        "timing": "ms, plain_ms, yardstick_ms: device time per call (torch.profiler); "
                  "events_ms: back-to-back launches between CUDA events",
        "events_ms": head["events_ms"],
        "fused_render_launches": options["render"]["fused_render_launches"],
        "by_shape": k7,
        "render_cli": {k: {kk: r[kk] for kk in ("frames", "seconds", "frames_per_s",
                                                 "autotune", "launches")}
                       for k, r in render_runs.items()},
    })
    print(f"# smoke run time: {time.perf_counter() - t_start:.1f} s (builds included)")
    print(json.dumps(kernels_line))
    print(f"gpu: {gpu}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
