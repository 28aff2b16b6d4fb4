#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (gags_torch) on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which fails the run:
  1. print the card's name and power limit (nvidia-smi); no CUDA → exit 1;
  2. build every kernel from gags_torch/splat/csrc
     (one nvcc per source, all at once);
  3. K6 expand_gid vs its plain version on the smoke scene's real rank
     offsets: exact; times of the kernel, the plain version and
     torch.searchsorted (the library yardstick);
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
     2 and 33 channels); profile one training step;
  9. serve the trained model dir (load_server) and check one relevancy map;
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
     rows summed per Gaussian; with K8's time, bound and plain time;
 13. load the snapshot PLY with GaussianScene.from_ply and render camera
     0: its PSNR against the ground truth must exceed the seed cloud's;
 14. print {"kernels": [...]} with times, bounds and launch counts of
     K1-K6 and K8, then the card's name and power limit, then the final
     {"ok": true, ...}.
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
    """'<kernel>[<C>]: N registers, S bytes spill stores' per entry function."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"([a-z][a-z_]*_kernel)(?:ILi(\d+)E)?", line.split("'")[1])
            name = m.group(1) + (f"[C={m.group(2)}]" if m.group(2) else "")
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


def train_phase(dev: torch.device, gpu: str) -> list:
    """Phases 7-9: train through the CLI entry point, hold K1-K4 against
    their plain versions on the run's own data, profile a step, serve the
    trained model dir. Returns the kernels' report entries."""
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
        red = b.red
        a3 = (grad_k, red.slot_to_pos, red.slot_rank, red.chunk_block, n)  # as _Blend calls it
        got = kernels.sorted_segment_sum(*a3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = kernels.sorted_segment_sum_plain(*a3)
        torch.cuda.synchronize()
        k3_plain = (time.perf_counter() - t0) * 1e3
        abs_sum = kernels.sorted_segment_sum_plain(grad_k.abs(), *a3[1:])
        cmp3 = sum_compare(got, want, abs_sum, f"K3 sorted_segment_sum C={fdim}")
        gid_l = b.inst_gid.long()
        lib = torch.zeros((n + 1, fdim), device=dev).index_add_(0, gid_l, grad_k)
        sum_compare(got, lib[:n], abs_sum, "K3 vs index_add_")
        nbytes = (grad_k.numel() + 2 * red.slot_rank.numel() + red.chunk_block.numel()
                  + got.numel()) * 4
        report.append(dict(
            name="sorted_segment_sum", id="K3", route="cuda",
            source="gags_torch/splat/csrc/sorted_segment_sum.cu",
            replaces="gags_tpu/splat/pallas_kernel.py:1431",
            ms=cuda_ms(lambda: kernels.sorted_segment_sum(*a3), 50), plain_ms=k3_plain,
            bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            ops_ms=grad_k.numel() / FP32_OPS_PER_S * 1e3,
            library_ms=cuda_ms(lambda: torch.zeros((n + 1, fdim), device=dev).index_add_(
                0, gid_l, grad_k), 50),
            **cmp3))

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
                k4[f"S={segs},C={c}"] = dict(
                    ms=cuda_ms(lambda: kernels.dense_segment_sum(vals, ids, segs), 50),
                    plain_ms=plain_ms, bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                    ops_ms=vals.numel() / FP32_OPS_PER_S * 1e3,
                    library_ms=cuda_ms(lambda: torch.zeros((segs, c), device=dev).index_add_(
                        0, ids_l, vals), 50),
                    **cmp4)
                print(f"# K4 S={segs} C={c}: {k4[f'S={segs},C={c}']}", flush=True)
        head = k4[f"S={cfg.max_segments + 1},C={1 + 2 * fdim}"]
        report.append(dict(
            name="dense_segment_sum", id="K4", route="cuda",
            source="gags_torch/splat/csrc/dense_segment_sum.cu",
            replaces="gags_tpu/splat/pallas_kernel.py:1853",
            **head, by_config=k4))
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

    for r in report:
        r["launches"] = launches[r["name"]]
        r["launches_per_step"] = launches[r["name"]] / TRAIN_STEPS
        r["check"] = "ok"
        r["bound_ms"] = max(r["bytes_ms"], r["ops_ms"])
        r["bound_by"] = "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations"
    report[0]["train_steps"] = steps
    return report


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
    rendered. Returns K8's report entry."""
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
        k8["bound_ms"] = max(k8["bytes_ms"], k8["ops_ms"])
        k8["bound_by"] = "bytes" if k8["bytes_ms"] >= k8["ops_ms"] else "operations"
        print(f"# K8 blend_backward_full: ms {k8['ms']:.4f}, plain {plain_ms:.1f} ms, bound "
              f"{k8['bound_ms']:.4f} ms ({k8['bound_by']}), {walked} pairs walked, {blended} "
              f"blended, {k8['instances']} instances ({gpu})", flush=True)

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
    return k8


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

    # -- 7-9. train, K1-K4, serve the trained model ------------------------------
    train_kernels = train_phase(dev, gpu)

    # -- 10-13. RGB pretraining, K8 ---------------------------------------------
    rgb_kernels = [rgb_phase(dev, gpu)]

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
    print(f"# smoke run time: {time.perf_counter() - t_start:.1f} s (builds included)")
    print(json.dumps(kernels_line))
    print(f"gpu: {gpu}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
