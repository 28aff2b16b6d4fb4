#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (gags_torch) on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py
(one card; `python3 chip_smoke.py --nccl` on four cards runs only the
NCCL check of `nccl_main`: gags_torch.parallel with one rank a card)

Phases, each of which fails the run:
  1. print the card's name and power limit (nvidia-smi); no CUDA → exit 1;
  2. build every kernel from gags_torch/splat/csrc, gags_torch/probes/csrc
     and gags_torch/utils/csrc (one nvcc per source, all at once);
  3. K6 expand_gid vs its plain version on the smoke scene's real rank
     offsets: exact; times of the kernel, the plain version and
     torch.searchsorted (the library yardstick), as device time per call
     (torch.profiler) and by CUDA events around back-to-back calls; the
     device time of an empty launch (torch.cuda._sleep(0)), the launch
     floor beside K6's bound;
  4. K5 blend_forward vs its plain version on the full 1280x720 frame, for
     the 16 feature channels and the 3 SH colour channels: atol 2e-5 /
     rtol 1e-4 with the NUMERICS.md allowance for isolated threshold flips
     (at most 0.01% of values outside, mean abs error <= 1e-5), and
     bit-identical on a second launch; its device time per call
     (torch.profiler) beside the CUDA-events time;
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
     bounds and index_add_ yardsticks (K1 and K2 by device time per call
     beside the CUDA-events time, both bit-identical on a second launch; K4
     at 1025 and 4097 segments, for
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
     serve frame, each leg (and f32) timed by device time per call beside
     the CUDA-events time, and exit_stats once more on a saturated 1280x720 frame
     (SAT_GAUSSIANS dense, near-opaque splats) where tiles must stop
     early; (c) gags_torch.cli.render.run on phase 7's model dir
     (four cameras at 1280x720, -r 1) with an autotune store of its own:
     RGB+ED, then --feature_mode
     --feature_npy --autotune, each with the launch counts set to 0 just
     before and read just after (autotune times, winner, frames/s, K7
     launches), then the cameras once more with fused_keys and tile_cull:
     K7 once per frame, the images equal to the unfused render's;
 9c. query and evaluation on phase 7's model dir (300k Gaussians, F = 16,
     CLIP 512, 1280x720), with an npz of three prompts from
     gags_torch.cli.encode_text.run on a seeded random ViT-B/16 (as phase
     14(e) writes it): (a) gags_torch.cli.relevancy image mode over the
     four cameras with the launch counts set to 0 just before and read
     just after (K5 and K6 or K7 once a frame at least), camera 0's PNGs
     equal to relevancy_maps on the card, and its heat maps and masks
     against the same functions on CPU tensors from the card's feature
     map (heat maps at phase 4's tolerance; every threshold flip of a
     mask within the heat map's error, stretched as the mask stretches
     it, of the threshold, and at most 49 smoothed flips a threshold
     flip; flips counted); (b)
     --video over QUERY_VIDEO_FRAMES frames (the mp4 is reported skipped
     where cv2 is missing); (c) --pcd_mode over every Gaussian with the
     neighbour vote (seconds of the decode, relevancy, KNN and selection),
     the KNN timed again in 4096x16384 blocks against the CLI's
     1024x4096, and the vote on QUERY_SUBSET points card against CPU at a
     radius from the data (any flip must sit at the radius; flips listed);
     (d) gags_torch.cli.evaluate on a labelme folder written for two
     cameras at QUERY_GT_W x QUERY_GT_H (float vertices, one label twice),
     each frame's IoUs and hits recomputed on the CPU from the card's
     decoded map, and once more with --clip_ckpt --bpe (the same IoUs);
     (e) gags_torch.cli.edit, color_func / deletion / extraction at the
     median similarity: the PLYs read back, deleted + extracted = N;
 9d. reference interop, the train-step tuner, the profile, the viewer
     (phase 7's scene and model dir): (a) its chkpnt40 in the reference's
     layout (a 13-tuple chkpnt40.pth: the PLY's geometry, the trained
     features, a real torch.optim.Adam state dict; decoder_chkpnt40.pth and
     scale_decoder_chkpnt40.pth as 1x1-conv state dicts), then
     cli.train_gad.run with start_checkpoint, autotune_train, profile and a
     free viewer_port for iterations 41-60, the launch counts set to 0 just
     before and read just after; (b) the first iteration is 41, its loss
     equal (rtol 1e-4) to iteration 41 of a --resume run from
     chkpnt40/state.pt with the same parameters before the first update,
     K1-K4 launched every step, the loss finite, the tuner's two times and
     winner printed and the winner saved in the model dir, the Chrome trace
     naming blend_forward_kernel (K1); (c) a viewer client connected just
     before the first step sends one 1280x720 camera: the frame equals a
     direct rasterize byte for byte, K5 and K6 launched; (d)
     make_surface_scene(300_000, 1280, 720, seed=3, opaque_frac=0.7): K5
     with exit_stats against its plain version as in 9b (b), the share of
     tiles that stop early (> 0), K5's device time there and on the fog
     scene make_scene(300_000); the scene as a reference 12-tuple, 5 GAD
     steps warm-started from it on phase 7's cameras from iteration 1;
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
     rows summed per Gaussian; once more with a seeded N(0, 1) alpha
     cotangent (the loss gives 0); bit-identical on a second launch; with
     K8's device time per call, events time, bound and plain time; K1 on
     the same binning and colours (C = 3) against its plain version at
     phase 4's tolerance, bit-identical on a second launch, with its device
     and events times, its bound from the plain version's pair counts and
     its launches in the 300 steps; then
     K3 at the RGB widths on K8's colour (C = 3) and geometry (C = 8) rows
     over camera 0's ReductionLayout, checked and timed as in phase 8; K6
     on the step's aligned binning of camera 0 (every slot of the state,
     the parked ones an empty tail), checked and timed as in phase 3;
 13. load the snapshot PLY with GaussianScene.from_ply and render camera
     0: its PSNR against the ground truth must exceed the seed cloud's;
 14. GAS (scripts/GAS.sh, stage 2) in the RGB phase's temporary directory:
     (a) gags_torch.cli.render.run RGB+ED on its model dir (K5 and K6 launch
     counts set to 0 just before and read just after); (b)
     gags_torch.cli.depth_sample.run, each map held to the same functions
     on CPU tensors bit for bit, with the count of projected (u, v) that
     differ between card and CPU; (c) seeded random ViT-H SAM (f32, the
     real file's 2.4 GiB) and OpenCLIP ViT-B/16 checkpoints in the upstream
     layout, then gags_torch.cli.gas.run through its loaders on every
     camera: at the CLI's thresholds, with --bf16 --encoder_batch 4, and
     with the thresholds lowered as tests/test_gas_to_gad.py lowers them
     (every camera must be written, f.shape[0] == s.max() + 1); the
     encoder's ms and peak memory per image at f32 and at bf16 batch 4,
     the decoder's ms per prompt batch, generate's wall against device
     busy time (torch.profiler), CLIP's ms per crop batch, GAS seconds per
     image; the card's f32 SAM against the CPU's at ViT-H widths cut to a
     windowed and a global block (max relative error at most
     GAS_REL_LIMIT); (d) GAS_GAD_STEPS GAD steps through
     gags_torch.cli.train_gad.run on the RGB snapshot PLY and the GAS
     output; (e) gags_torch.cli.encode_text.run with a small merge table,
     its npz served by load_server on (d)'s model: one /relevancy reply;
     (f) gags_torch.cli.metrics on (a)'s renders with the scene's PNGs as
     gt/ and seeded random VGG16 / LPIPS-head files in torchvision's key
     layout, cuDNN's TF32 switched on before the call (the CLI turns it
     off): each view's PSNR, SSIM and LPIPS against the same functions on
     CPU tensors (rtol 1e-6, atol 1e-6, rtol 1e-6; LPIPS at least 1e-3,
     and a control with TF32 convolutions that must miss), seconds per
     image;
 18. JPEG scenes (run after 14, before 15, in the RGB phase's temporary
     directory): (a) every JPEG fixture of tests/data/torch_jpeg through
     J1 jpeg_decode (host C++ entropy decoding, then the dequant + IDCT and
     upsampling + colour kernels) equal to PIL's stored pixels and to the
     plain decode, bit-identical on a second launch; (b) phase 10's eight
     1280x720 ground truths written as JPEG by encode_jpeg (Pillow's save
     defaults), each decoded on the card equal to the CPU's plain decode
     (per frame: parse, host entropy and H2D ms; J1's device time, bound
     and plain time on the card), then gags_torch.cli.train_rgb.run on
     that scene at -r 1 (SH 3, 400k slots) for JPEG_STEPS steps with the
     launch counts set to 0 just before and read just after: J1 once an
     image, K1, K6 and K8 every step, the loss finite and falling; (c)
     the images at -r 2 through load_rgb's BICUBIC on the card equal to
     the CPU's; (d) gags_torch.cli.gas.run on two of the JPEG cameras with
     phase 14's random checkpoints and lowered thresholds: every camera
     written; (e) convert's LANCZOS pyramid of the eight JPEGs on the card
     byte for byte the CPU's;
 15. the probes' kernels P1 vpu_chain and P2 slab_chain (the TPU probes
     scripts/vpu_probe.py and scripts/slab_probe.py): their entry points
     (vpu_probe.main, slab_probe.main) with the launch counts set to 0
     just before and read just after; registers and spills of both
     libraries; P1 and P2 on all 65,536 bf16 bit patterns, bit for bit
     (NaNs as bits); P1 at the TPU block (512x256, reps 1) and at the
     rate shape (8192x512, reps 64), P2 at every slab and slab 1 (with its
     launch geometry: at least 132 blocks) and at slab None with 10x the
     reps, in float32 and bfloat16, each against its plain version (bit
     for bit; P1 in float32 within 1 ulp) and bit-identical on a second
     launch; each P1 shape and each distinct P2 launch timed: device time
     per call (torch.profiler), CUDA-events time, the plain version's
     times, the published-peak bound and the kernel's own-instruction
     bound (its rep loop's instructions and MUFUs from cuobjdump -sass at
     the card's maximum SM clock);
 16. multi-rank training and rendering (gags_torch.parallel) in phase 7's
     temporary directory, after 9d, two ranks sharing the card over gloo
     (every figure labelled so; none is a speed-up): (a)
     gags_torch.cli.train_gad.run with devices=2 for 20 iterations into a
     model dir of its own, rank 0 alone writing it, its on_step on rank 0
     recording step times, losses and launches; its parameters after
     iteration 1 (chkpnt1) against one process that accumulates the same
     two cameras' gradients, halves them and takes the three Adam steps
     (the first loss at rtol 2e-5; every parameter within 1e-6 but for
     at most 1e-4 of them, sign flips of gradients within K4's atomic
     rounding of zero, each within 2 lr); (b) the strip step on camera 0
     at 640x360 (2 strips of 6 tile rows, 24 pad rows): losses of 2 steps
     at rtol 2e-5, the raw gradients of each feature channel and decoder
     tensor within 1e-4 of its largest, the features after 2 steps as in
     (a), overflow 0; its median step and the per-step all_gathers and
     reduce_scatter (bytes, ms); (c) make_gshard_render at the serve
     configuration (1280x720, 250k, F = 16, 2 strips of 12 tile rows)
     with K6 and with K7 + the cull against one-process rasterize at
     phase 4's tolerance; (d) make_dp_render of the four cameras against
     sequential renders, bit for bit; each kernel's launches inside the
     ranks read around each path (the kernels line's
     distributed_launches);
 17. print {"kernels": [...]} with times, bounds and launch counts of
     K1-K8 (K1 by width: GAD C = 16, RGB C = 3; K3: GAD C = 16, RGB C = 3
     and 8; K6 by shape: serve, RGB aligned; K5, K6, K7 with their GAS
     stage-A launches; every kernel with its phase-16 launches), P1-P2
     and J1 (its launches in phase 18's training, GAS and convert runs),
     the query and multi-rank reports, then the card's name and power
     limit, then the final {"ok": true, ...}.
"""

from __future__ import annotations

import base64
import collections
import dataclasses
import gzip
import json
import math
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
PROFILE_RUNS = 5  # device_ms's profiled runs at most before it gives up
# device_ms's runs by calling function: accepted, short of records, the least share of a
# name's records kept, refused by reason
PROFILE_TALLY = collections.defaultdict(lambda: collections.Counter({"least kept": 1.0}))
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


def device_ms(fn, iters: int = 20, floor_ms: float = 0.0) -> float:
    """Device time per call of fn: the sum of its kernels' device time
    (torch.profiler), where back-to-back launches timed by events measure
    the host's launch rate instead (kernels of a few microseconds behind a
    Python wrapper). Every call launches the same kernels and copies, so a
    name's records number a multiple of `iters`; the profiler on the H100
    loses some, more as the process ages (19 of 20 early in the smoke,
    6 of 20 by phase 12, the same in five runs of five), so a name's mean
    time per record stands in for its missing ones, and the shortfall is
    tallied by calling function in PROFILE_TALLY. A profiled run with no
    device record, or reading below `floor_ms` (the least time the work
    can take), is refused and fn profiled again, up to PROFILE_RUNS runs
    in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    caller = sys._getframe(1).f_code.co_name
    tally = PROFILE_TALLY[caller]
    fn()
    torch.cuda.synchronize()
    refused = []
    for _ in range(PROFILE_RUNS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        busy, kept = 0.0, 1.0
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA or not e.count:
                continue
            n = -(-e.count // iters) * iters  # the records fn's calls made
            kept = min(kept, e.count / n)
            busy += e.self_device_time_total / e.count * n
        ms = busy / iters / 1e3
        why = ("no device record" if ms <= 0 else
               "below its floor" if ms < floor_ms else None)
        if why is None:
            tally["runs"] += 1
            tally["short of records"] += kept < 1
            tally["least kept"] = min(tally["least kept"], kept)
            return ms
        tally[f"refused, {why}"] += 1
        refused.append(f"{why} ({ms:.6f} ms, floor {floor_ms:.6f})")
        print(f"# device_ms ({caller}): run refused, {refused[-1]}", flush=True)
    fail(f"device_ms ({caller}): all {PROFILE_RUNS} profiled runs refused: {refused}")


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
    """'<kernel><T,...>: N registers, S bytes spill stores, L bytes spill
    loads' per entry function, T,... its integer and bool template
    arguments (the blends' channel count and pixels a thread, K3's vector
    width, K4's strip length, K7's cull)."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            name = re.search(r"([a-z][a-z_]*_kernel)", mangled).group(1)
            args = re.search(name + r"I(.*?)EEv", mangled)
            ints = re.findall(r"L[ib](\d+)E", args.group(1)) if args else []
            name += f"<{','.join(ints)}>" if ints else ""
            name += "[bf16]" if "bfloat16" in line else ""
        elif "spill stores" in line:
            spill = ", ".join(part.strip() for part in line.split(",")[1:])
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


def tile_stats(counts: torch.Tensor) -> dict:
    """Instances per tile of a binning: the length of each tile's walk in
    the blends (K1, K2, K8 take a tile per cluster or block)."""
    c = counts.double()
    q = torch.quantile(c, torch.tensor([0.5, 0.9, 1.0], dtype=torch.float64, device=c.device))
    return dict(tiles=c.numel(), mean=float(c.mean()), median=float(q[0]), p90=float(q[1]),
                max=float(q[2]))


def blend_ops(near: int, blended: int, per_blended: int, walks: int = 1) -> int:
    """The operations a blend must do on this data: per walk, the
    blend_common.cuh arithmetic (16) on each pair near enough to its splat
    that no exact test short of alpha excludes it (the plain versions'
    `near` count), and per_blended on each blended pair. The other walked
    pairs cost a kernel a few compares per warp (the box test) and are not
    charged."""
    return walks * 16 * near + per_blended * blended


def with_bound(r: dict) -> dict:
    r["bound_ms"] = max(r["bytes_ms"], r["ops_ms"])
    r["bound_by"] = "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations"
    return r


def k6_check(kernels, offsets: torch.Tensor, slots: int, what: str) -> dict:
    """K6 against its plain version on real rank offsets (exact), with the
    kernel's, the plain version's and torch.searchsorted's (the library
    yardstick) device time per call and events time, and its bound: each
    offset read once, each gid written once; operations, a merge of the
    sorted slot ids with the offsets, one compare each."""
    gid_k = kernels.expand_gid(offsets, slots)
    gid_p = kernels.expand_gid_plain(offsets, slots)
    torch.cuda.synchronize()
    if not torch.equal(gid_k, gid_p):
        fail(f"K6 expand_gid {what}: differs from its plain version at "
             f"{int((gid_k != gid_p).sum())} of {slots} slots")
    idx = torch.arange(slots, dtype=torch.int32, device=offsets.device)
    k6 = lambda: kernels.expand_gid(offsets, slots)  # noqa: E731
    plain = lambda: kernels.expand_gid_plain(offsets, slots)  # noqa: E731
    library = lambda: torch.searchsorted(offsets, idx, right=True)  # noqa: E731
    n = offsets.numel()
    r = with_bound(dict(
        slots=slots, ranks=n, ranks_owning_slots=int((torch.diff(offsets) > 0).sum()) + 1,
        ms=device_ms(k6), events_ms=cuda_ms(k6, 50),
        plain_ms=device_ms(plain), plain_events_ms=cuda_ms(plain, 50),
        library_ms=device_ms(library), library_events_ms=cuda_ms(library, 50),
        bytes_ms=(n + slots) * 4 / HBM_BYTES_PER_S * 1e3,
        ops_ms=(n + slots) / FP32_OPS_PER_S * 1e3, timing=K6_TIMING))
    print(f"# K6 expand_gid {what}: {slots} slots over {n} ranks, exact; {r}", flush=True)
    return r


K6_TIMING = ("ms, plain_ms, library_ms: device time per call (torch.profiler); "
             "*events_ms: back-to-back calls between CUDA events")


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
        if not torch.equal(out_k, kernels.blend_forward_aligned(*a1)):  # one writer per pixel
            fail(f"K1 C={fdim}: two launches differ")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_p, walked, blended, near = kernels.blend_forward_plain(*a1, return_pairs=True)
        torch.cuda.synchronize()
        k1_plain = (time.perf_counter() - t0) * 1e3
        cmp1 = flip_tolerant_compare(out_k, out_p, f"K1 blend_forward_aligned C={fdim}")
        nbytes = (geom_p.numel() + cols_p.numel() + b.inst_gid.numel()
                  + 2 * b.tile_starts.numel() + bg.numel() + out_k.numel()) * 4
        ops = blend_ops(near, blended, 4 + 2 * fdim)
        k1_fn = lambda: kernels.blend_forward_aligned(*a1)  # noqa: E731
        report.append(dict(
            name="blend_forward_aligned", id="K1", route="cuda",
            source="gags_torch/splat/csrc/blend_forward.cu",
            replaces="gags_tpu/splat/pallas_kernel.py:1909",
            ms=device_ms(k1_fn), events_ms=cuda_ms(k1_fn, 20), plain_ms=k1_plain,
            bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3, ops_ms=ops / FP32_OPS_PER_S * 1e3,
            library_ms=None, channels=fdim, pairs_walked=walked, pairs_blended=blended,
            pairs_near=near, bit_identical=True, instances_per_tile=tile_stats(b.tile_counts),
            timing=DEVICE_TIMING, **cmp1))
        del out_k, out_p

        # K2
        a2 = (geom_p, b.inst_gid, b.tile_starts, b.tile_counts, g_tiles, tx, ty, th, tw)
        grad_k = kernels.blend_backward(*a2)
        again = kernels.blend_backward(*a2)
        torch.cuda.synchronize()
        if not torch.equal(grad_k, again):  # one writer per row, a fixed order of addition
            fail(f"K2: two launches differ at {int((grad_k != again).sum())} values")
        del again
        t0 = time.perf_counter()
        grad_p, walked2, blended2, near2 = kernels.blend_backward_plain(*a2, return_pairs=True)
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
        ops = blend_ops(near2, blended2, 2 * fdim)
        k2_fn = lambda: kernels.blend_backward(*a2)  # noqa: E731
        report.append(dict(
            name="blend_backward", id="K2", route="cuda",
            source="gags_torch/splat/csrc/blend_backward.cu",
            replaces="gags_tpu/splat/pallas_kernel.py:1969",
            ms=device_ms(k2_fn), events_ms=cuda_ms(k2_fn, 20), plain_ms=k2_plain,
            bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3, ops_ms=ops / FP32_OPS_PER_S * 1e3,
            library_ms=None, pairs_walked=walked2, pairs_blended=blended2, pairs_near=near2,
            max_abs_err=cmp2["max_abs_err"], mean_abs_err=cmp2["mean_abs_err"],
            bit_identical=True, timing=DEVICE_TIMING, instances_per_tile=tile_stats(b.tile_counts)))
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


K7_KEY_OPS = 20
K7_CULL_OPS = 72
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
            # the function's own work, whatever finds the owners: per slot
            # the rect unpack, the floor division, the tile id and the key
            # (~20 integer operations); with the cull, per slot its 72 float
            # operations (the four divisions counted as one each)
            ops = mk * (K7_KEY_OPS + (K7_CULL_OPS if cull else 0))
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
    saturated frame, where some tile must stop early. Each leg (f32,
    bf16 rows, bf16 blend, bf16 rows with the counters) is timed by device
    time per call beside the CUDA-events time."""
    from gags_torch.splat import kernels

    args, chunk = serve["args"], serve["chunk"]
    c = args[1].shape[1]
    f32 = kernels.blend_forward(*args)
    res = {"f32": {}}
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
        plain_ms=plain_ms, **flip_tolerant_compare(out_k, out_p, f"K5 fast_color_rows C={c}"))
    res["exit_stats"] = exit_stats_compare(st_k, st_p, "K5 serve frame")
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
    res["blend_bf16"] = dict(plain_ms=plain_ms,
                             **flip_tolerant_compare(out_b, out_bp, f"K5 blend_bf16 C={c}"))
    scale = float(f32[..., :c].abs().max())
    d = (out_b[..., :c] - f32[..., :c]).abs()
    contract = dict(max_rel=float(d.max()) / scale, mean_rel=float(d.mean()) / scale,
                    alpha_max_abs=float((out_b[..., c] - f32[..., c]).abs().max()))
    res["blend_bf16"]["vs_f32"] = contract
    print(f"# K5 blend_bf16 vs the f32 image: {contract} (contract 5e-2, 5e-3, 0.03)", flush=True)
    if contract["max_rel"] > 5e-2 or contract["mean_rel"] > 5e-3 or contract["alpha_max_abs"] > 0.03:
        fail(f"K5 blend_bf16 breaks its contract against f32: {contract}")
    legs = {"f32": {}, "fast_color_rows": dict(fast_color_rows=True),
            "blend_bf16": dict(blend_bf16=True),
            "exit_stats": dict(fast_color_rows=True, exit_stats=True, chunk=chunk)}
    for option, kw in legs.items():
        fn = lambda: kernels.blend_forward(*args, **kw)  # noqa: E731
        res[option].update(ms=device_ms(fn), events_ms=cuda_ms(fn, 20))
    print(f"# K5 options at 1280x720, C={c}, device ms (events ms): "
          + ", ".join(f"{k} {res[k]['ms']:.4f} ({res[k]['events_ms']:.4f})" for k in legs)
          + f" ({gpu})", flush=True)
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


# phase 9c: query and evaluation on phase 7's model dir (the train configuration)
QUERY_LABELS = ("hello world", "a photo", "teapot")
QUERY_THRESH = 0.5  # the relevancy CLI's default
QUERY_VIDEO_FRAMES = 8
QUERY_GT_W, QUERY_GT_H = 960, 540  # the labels' resolution (cameras resized to it)
QUERY_GT_CAMERAS = (0, 2)
QUERY_SUBSET = 20_000  # points of the card-vs-CPU neighbour vote
QUERY_VOTE_K, QUERY_VOTE_RANK, QUERY_VOTE_MIN = 32, 16, 8


def write_labelme(root: str, cameras, labels, w: int, h: int, seed: int) -> str:
    """frame_<i + 1>.json per camera index i in the LERF labelme layout:
    per label one polygon of 5-23 float vertices (the first label two, so
    its masks merge), with its bounding box."""
    rng = np.random.default_rng(seed)
    os.makedirs(root)
    for i in cameras:
        objects = []
        for label in tuple(labels) + tuple(labels[:1]):
            n = int(rng.integers(5, 24))
            ang = np.sort(rng.uniform(0, 2 * np.pi, n))
            r = rng.uniform(0.05, 0.3, n) * min(w, h)
            c = rng.uniform([0.2 * w, 0.2 * h], [0.8 * w, 0.8 * h])
            pts = np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], 1)
            (x0, y0), (x1, y1) = pts.min(0), pts.max(0)
            objects.append(dict(category=label, bbox=[float(x0), float(y0), float(x1), float(y1)],
                                segmentation=pts.tolist()))
        with open(os.path.join(root, f"frame_{i + 1:05d}.json"), "w") as f:
            json.dump(dict(info=dict(height=h, width=w, name=f"frame_{i + 1:05d}.jpg"),
                           objects=objects), f)
    return root


def counted(fn):
    """fn()'s result and the splat kernels' launches during it (counts set
    to 0 just before, read just after)."""
    from gags_torch.splat import kernels

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in kernels.launch_counts.items() if v}


def query_phase(root: str, model: str, dev: torch.device, gpu: str) -> dict:
    """Phase 9c: the query and evaluation CLIs on phase 7's model dir (300k
    Gaussians, F = 16, CLIP 512, 1280x720), with text embeddings written
    by gags_torch.cli.encode_text.run as phase 14(e) writes them. Returns
    the report."""
    from gags_torch.cli import edit as edit_cli
    from gags_torch.cli import encode_text
    from gags_torch.cli import evaluate as eval_cli
    from gags_torch.cli import relevancy as rel_cli
    from gags_torch.knn.knn import knn_with_indices
    from gags_torch.models.clip import CLIP, CLIPConfig
    from gags_torch.models.decoders import feature_decoder_from_state
    from gags_torch.query import edit as qedit
    from gags_torch.query import eval_iou, grounding
    from gags_torch.query.relevancy import heatmap_to_mask, majority_smooth, max_across_levels
    from gags_torch.scene.dataset import camera_from_info, detect_and_load
    from gags_torch.scene.gaussian_data import GaussianScene
    from gags_torch.splat.rasterizer import RasterizeConfig
    from gags_torch.splat.render import render
    from gags_torch.utils.colormaps import turbo
    from gags_torch.utils.image import encode_png

    cpu = torch.device("cpu")
    rep = {}
    qdir = os.path.join(os.path.dirname(root), "query")
    os.makedirs(qdir)
    clip_path = os.path.join(qdir, "clip_vit_b_16.pt")
    random_checkpoint(CLIP(CLIPConfig.vit_b_16(), device="meta"), clip_path, 3, dev)
    bpe = write_bpe(os.path.join(qdir, "bpe.txt.gz"))
    npz = os.path.join(qdir, "embeds.npz")
    encode_text.run(clip_path, list(QUERY_LABELS), npz, bpe=bpe, device=dev)
    labels, pos, neg = rel_cli.load_text_embeds(npz)
    pos_d, neg_d = torch.as_tensor(pos, device=dev), torch.as_tensor(neg, device=dev)

    # -- (a) image mode over the four cameras, camera 0 against the CPU ------
    img, launches = counted(lambda: rel_cli.run(model, root, TRAIN_STEPS, text_embeds=npz,
                                                resolution=1, device=dev))
    if launches.get("blend_forward", 0) < img["frames"]:
        fail(f"relevancy image mode: K5 launched {launches} for {img['frames']} frames")
    if launches.get("expand_gid", 0) + launches.get("expand_keys", 0) < img["frames"]:
        fail(f"relevancy image mode: neither K6 nor K7 bins every frame: {launches}")
    print(f"# relevancy image mode: {img['frames']} frames at {TRAIN_SRC_W}x{TRAIN_SRC_H}, "
          f"{len(labels)} prompts, {img['frames_per_s']:.3f} frames/s ({img['seconds']:.2f} s, "
          f"PNG writes included), launches {launches} ({gpu})", flush=True)
    rep["image"] = dict(frames=img["frames"], seconds=img["seconds"],
                        frames_per_s=img["frames_per_s"], launches=launches)
    scene, dec = rel_cli.load_query_model(model, TRAIN_STEPS, dev)
    raster = RasterizeConfig(**img["config"])
    info = detect_and_load(root, foundation_model="none")
    cam0 = camera_from_info(info.train_cameras[0], 1)
    masks_k, heats_k = rel_cli.relevancy_maps(scene, dec, cam0, pos_d, neg_d, QUERY_THRESH,
                                              raster, dev)
    masks_k, heats_k = masks_k.cpu(), heats_k.cpu()
    # where a frame's time goes: the card's part (render, decode, relevancy,
    # masks), then the host's (turbo and three PNGs a prompt)
    prof = profile_request(lambda: rel_cli.relevancy_maps(
        scene, dec, cam0, pos_d, neg_d, QUERY_THRESH, raster, dev), "relevancy_maps, camera 0")
    t0 = time.perf_counter()
    for k in range(len(labels)):
        heat, mask = turbo(heats_k[k].numpy()), masks_k[k].numpy()[..., None].astype(np.float32)
        for img_ in (heat, mask.repeat(3, -1), heat * mask + 0.3 * heat * (1 - mask)):
            encode_png(img_)
    host_ms = (time.perf_counter() - t0) * 1e3
    print(f"# relevancy frame breakdown: card part wall {prof['wall_ms']:.2f} ms (busy "
          f"{prof['busy_ms']:.2f}), host part {host_ms:.1f} ms ({gpu})", flush=True)
    rep["image"].update(card_wall_ms=prof["wall_ms"], card_busy_ms=prof["busy_ms"],
                        host_ms=host_ms)
    out_dir = os.path.join(model, "relevancy")
    for k, label in enumerate(labels):  # the CLI's camera-0 files are these maps
        heat = turbo(heats_k[k].numpy())
        with open(os.path.join(out_dir, "heatmap", label, cam0.name + ".png"), "rb") as f:
            if f.read() != encode_png(heat):
                fail(f"relevancy CLI heat map '{label}' camera 0 differs from relevancy_maps")
    with torch.no_grad():
        fmap = render(cam0, means=scene.means, quats=scene.quats, scales=scene.scales,
                      opacities=scene.opacities, semantic_features=scene.semantic_features,
                      feature_mode=True, bg_color=torch.zeros(3, device=dev), config=raster,
                      device=dev).render
        rel_k = max_across_levels(grounding.decode_map_rows(dec, fmap)[None], pos_d, neg_d)[0]
        dec_cpu = feature_decoder_from_state({k: v.cpu() for k, v in dec.state_dict().items()},
                                             cpu)
        rel_c = max_across_levels(grounding.decode_map_rows(dec_cpu, fmap.cpu())[None],
                                  torch.as_tensor(pos), torch.as_tensor(neg))[0]
    rep["camera0"] = {}
    for k, label in enumerate(labels):
        raw_k, vm_k = heatmap_to_mask(rel_k[k], QUERY_THRESH)
        if not (torch.equal(vm_k.cpu(), heats_k[k])
                and torch.equal(majority_smooth(raw_k).cpu(), masks_k[k])):
            fail(f"relevancy_maps camera 0 '{label}' differs from its steps run one by one")
        raw_c, vm_c = heatmap_to_mask(rel_c[k], QUERY_THRESH)
        cmp = flip_tolerant_compare(heats_k[k], vm_c, f"relevancy heat map, camera 0, '{label}' "
                                    "(card vs the same functions on CPU tensors)")
        # the mask thresholds vm stretched by 2 / (max - min): a flip is explained where
        # the CPU's stretched value lies within the stretched heat-map error of the
        # threshold; a threshold flip moves at most the 7x7 majority windows holding it
        span = float(vm_c.max() - vm_c.min())
        out_c = torch.clamp((vm_c - vm_c.min()) / (span + 1e-9) * 2.0 - 1.0, 0.0, 1.0)
        band = 4.0 * cmp["max_abs_err"] / max(span, 1e-30) + 1e-6
        flipped = raw_k.cpu() != raw_c
        flips = int(flipped.sum())
        unexplained = int((flipped & ((out_c - QUERY_THRESH).abs() > band)).sum())
        smooth_flips = int((masks_k[k] != majority_smooth(raw_c)).sum())
        if unexplained or smooth_flips > 49 * flips:
            fail(f"relevancy mask camera 0 '{label}': {flips} threshold flips ({unexplained} "
                 f"farther than {band:.3g} from the threshold), {smooth_flips} after the "
                 f"majority smoothing, of {raw_c.numel()} pixels")
        rep["camera0"][label] = dict(heat=cmp, heat_span=span, threshold_band=band,
                                     threshold_flips=flips, smoothed_flips=smooth_flips,
                                     selected_px=int(masks_k[k].sum()))
    print(f"# relevancy camera 0 vs CPU: {rep['camera0']}", flush=True)
    del fmap, rel_k, rel_c

    # -- (b) --video along the interpolated path -------------------------------
    vid, launches = counted(lambda: rel_cli.run(model, root, TRAIN_STEPS, text_embeds=npz,
                                                resolution=1, video=True,
                                                video_frames=QUERY_VIDEO_FRAMES, device=dev))
    if vid["frames"] != QUERY_VIDEO_FRAMES or launches.get("blend_forward", 0) < vid["frames"]:
        fail(f"relevancy --video: {vid['frames']} frames, launches {launches}")
    names = [f"{label}.mp4" for label in labels]
    mp4 = "written" if vid["videos"] else f"skipped (no cv2 on this machine): {names}"
    print(f"# relevancy --video: {vid['frames']} frames, {vid['frames_per_s']:.3f} frames/s, "
          f"mp4 {mp4}, launches {launches} ({gpu})", flush=True)
    rep["video"] = dict(frames=vid["frames"], frames_per_s=vid["frames_per_s"], mp4=mp4,
                        launches=launches)

    # -- (c) pcd mode over all the Gaussians, with the neighbour vote -----------
    pcd = rel_cli.run(model, root, TRAIN_STEPS, text_embeds=npz, pcd=True, device=dev)
    print(f"# relevancy --pcd_mode: {scene.num_gaussians} Gaussians, selected "
          f"{pcd['selected']}, seconds {pcd['seconds']} ({gpu})", flush=True)
    rep["pcd"] = dict(selected=pcd["selected"], seconds=pcd["seconds"])
    means = scene.means
    t0 = time.perf_counter()
    big = knn_with_indices(means, QUERY_VOTE_K, row_block=4096, col_block=16384)
    torch.cuda.synchronize()
    big_s = time.perf_counter() - t0
    small = knn_with_indices(means, QUERY_VOTE_K)
    same_rows = bool(torch.equal(small[0], big[0]))
    rows_differ = int((torch.sort(small[1], 1).values != torch.sort(big[1], 1).values)
                      .any(1).sum())
    print(f"# KNN k={QUERY_VOTE_K} over {scene.num_gaussians} points: 1024x4096 blocks "
          f"{pcd['seconds']['knn']:.2f} s (in the CLI), 4096x16384 blocks {big_s:.2f} s; "
          f"distances equal {same_rows}, rows whose index sets differ {rows_differ} ({gpu})",
          flush=True)
    rep["knn"] = dict(cli_blocks_s=pcd["seconds"]["knn"], big_blocks_s=big_s,
                      distances_equal=same_rows, index_rows_differ=rows_differ)
    del big, small
    # the vote on a subset, card against CPU, at a radius from the data
    sub = torch.as_tensor(np.sort(np.random.default_rng(0).choice(
        scene.num_gaussians, QUERY_SUBSET, replace=False)), device=dev)
    xyz = means[sub]
    with torch.no_grad():
        rel_pts = grounding.point_relevancy(
            grounding.decode_features_chunked(dec, scene.semantic_features[sub]), pos_d, neg_d)
    mask = rel_pts[:, 0] > QUERY_THRESH
    d_card, i_card = knn_with_indices(xyz, QUERY_VOTE_K)
    radius = float(torch.sqrt(torch.median(d_card[:, QUERY_VOTE_RANK - 1])))
    vote = dict(k=QUERY_VOTE_K, radius=radius, min_votes=QUERY_VOTE_MIN)
    m_card = grounding.smooth_point_mask(xyz, mask, **vote).cpu()
    d_cpu, i_cpu = knn_with_indices(xyz.cpu(), QUERY_VOTE_K)
    m_cpu = grounding.smooth_point_mask(xyz.cpu(), mask.cpu(), **vote)
    flips = torch.nonzero(m_card != m_cpu).flatten().tolist()
    r2 = radius * radius
    near = (((d_cpu - r2).abs() <= 1e-5 * r2) | ((d_card.cpu() - r2).abs() <= 1e-5 * r2)).any(1)
    off_radius = [i for i in flips if not bool(near[i])]
    print(f"# neighbour vote on {QUERY_SUBSET} points (k {QUERY_VOTE_K}, radius {radius:.5f} = "
          f"median distance to the {QUERY_VOTE_RANK}th neighbour, min votes {QUERY_VOTE_MIN}): "
          f"{int(mask.sum())} selected before, card {int(m_card.sum())}, CPU {int(m_cpu.sum())}; "
          f"flips {len(flips)} {flips[:20]}, all at the radius {not off_radius}", flush=True)
    if off_radius or int(m_cpu.sum()) in (0, int(mask.sum())):
        fail(f"the neighbour vote: card and CPU differ off the radius at {off_radius[:20]} "
             f"(or the vote kept all or none: CPU {int(m_cpu.sum())} of {int(mask.sum())})")
    rep["vote"] = dict(vote, points=QUERY_SUBSET, selected=int(mask.sum()),
                       card=int(m_card.sum()), cpu=int(m_cpu.sum()), flips=flips)

    # -- (d) evaluate on a labelme folder of two cameras -------------------------
    gt_dir = write_labelme(os.path.join(qdir, "labels"), QUERY_GT_CAMERAS, labels, QUERY_GT_W,
                           QUERY_GT_H, seed=5)
    gt, _, _ = eval_iou.load_lerf_gt(gt_dir)
    checks = {}

    def on_frame(idx, decoded, result):
        d_cpu = decoded.cpu()
        ann, lbl = gt[idx], result["labels"]
        p = pos[[labels.index(l) for l in lbl]]
        ious = eval_iou.eval_frame_iou(d_cpu, p, neg, ann, lbl)
        hits = eval_iou.eval_frame_localization(d_cpu, p, neg, ann, lbl)
        checks[idx] = dict(iou_diff=float(np.max(np.abs(np.subtract(ious, result["ious"])))),
                           hits_card=result["loc_hits"], hits_cpu=hits)

    summ, launches = counted(lambda: eval_cli.run(model, root, gt_dir, TRAIN_STEPS,
                                                  text_embeds=npz, device=dev,
                                                  on_frame=on_frame))
    summ_clip = eval_cli.run(model, root, gt_dir, TRAIN_STEPS, clip_ckpt=clip_path, bpe=bpe,
                             device=dev)
    print(f"# evaluate: {len(summ['frames'])} frames at {QUERY_GT_W}x{QUERY_GT_H}, mIoU "
          f"{summ['miou']:.4f}, loc {summ['loc_acc']:.3f}, {summ['seconds_per_frame']:.3f} s a "
          f"frame; with --clip_ckpt {summ_clip['seconds_per_frame']:.3f} s a frame; CPU "
          f"recomputation {checks}; launches {launches} ({gpu})", flush=True)
    for idx, c in checks.items():
        # a heat map's threshold flip moves an IoU by about 1 / union
        if c["iou_diff"] > 1e-3 or c["hits_card"] != c["hits_cpu"]:
            fail(f"evaluate frame {idx}: card vs CPU recomputation {c}")
    if [r["ious"] for r in summ["frames"].values()] != [
            r["ious"] for r in summ_clip["frames"].values()]:
        fail("evaluate: --clip_ckpt and --text_embeds from the same checkpoint disagree")
    if launches.get("blend_forward", 0) < len(summ["frames"]):
        fail(f"evaluate: K5 launched {launches} for {len(summ['frames'])} frames")
    rep["evaluate"] = dict(miou=summ["miou"], loc_acc=summ["loc_acc"],
                           seconds_per_frame=summ["seconds_per_frame"],
                           clip_seconds_per_frame=summ_clip["seconds_per_frame"], cpu=checks)

    # -- (e) edit: the three operations ------------------------------------------
    with torch.no_grad():
        decoded = grounding.decode_features_chunked(dec, scene.semantic_features)
        e = pos_d / pos_d.norm(dim=-1, keepdim=True)
        sims = (decoded / decoded.norm(dim=-1, keepdim=True)) @ e[1]
    thr = float(torch.median(sims))  # about half the Gaussians
    del decoded
    edits = {}
    for op in ("color_func", "deletion", "extraction"):
        cfg = qedit.EditConfig(objects=list(labels), operation=op, targets=[labels[1]],
                               threshold=thr, color_func="lambda c: np.clip(1.0 - c, 0, 1)")
        out = os.path.join(qdir, f"edit_{op}.ply")
        t0 = time.perf_counter()
        r = edit_cli.run(model, cfg, npz, TRAIN_STEPS, out, device=dev)
        seconds = time.perf_counter() - t0
        back = GaussianScene.from_ply(out)
        if back.num_gaussians != r["n_out"]:
            fail(f"edit {op}: the PLY holds {back.num_gaussians}, not {r['n_out']}")
        edits[op] = dict(selected=r["selected"], n_out=r["n_out"], seconds=seconds)
    n = scene.num_gaussians
    if (edits["deletion"]["n_out"] + edits["extraction"]["n_out"] != n
            or edits["color_func"]["n_out"] != n or not 0 < edits["deletion"]["selected"] < n):
        fail(f"edit: {edits}")
    print(f"# edit (threshold {thr:.4f}, target '{labels[1]}'): {edits}; deleted + extracted = "
          f"{edits['deletion']['n_out'] + edits['extraction']['n_out']} = N ({gpu})", flush=True)
    rep["edit"] = edits
    return rep


# phase 9d: reference interop, the train-step tuner, the profile and the
# viewer on phase 7's fixture and model dir; the trained-statistics scene
WARM_FROM, WARM_TO = TRAIN_STEPS, 60  # iterations 41-60 (the profile takes 50-60)
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-7  # tests/test_torch_train_step.py's loss tolerance
SURFACE_N, SURFACE_SEED, SURFACE_OPAQUE = 300_000, 3, 0.7
SURFACE_GAD_STEPS = 5


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def write_reference_tuple(path: str, means, sh, opacities_raw, scales_raw, quats, iteration: int,
                          features=None) -> None:
    """The reference's `torch.save((gaussian_model.capture(), iteration))`:
    nn.Parameters, the densification buffers, a real Adam state dict (one
    step on zero gradients: moments 0, parameters unchanged), the spatial
    lr scale (a numpy.float64, as getNerfppNorm gives it), and the semantic
    features for a 13-tuple."""
    def param(a):
        return torch.nn.Parameter(torch.as_tensor(np.ascontiguousarray(a, np.float32)))

    sh = np.asarray(sh, np.float32)
    params = [param(means), param(sh[:, :1]), param(sh[:, 1:]), param(scales_raw), param(quats),
              param(np.asarray(opacities_raw, np.float32)[:, None])]
    opt = torch.optim.Adam([{"params": [p], "lr": 1e-3} for p in params], eps=1e-15)
    for p in params:
        p.grad = torch.zeros_like(p)
    opt.step()
    n = params[0].shape[0]
    args = (3, *params, torch.zeros(n), torch.zeros(n, 1), torch.zeros(n, 1), opt.state_dict(),
            np.float64(4.0))
    if features is not None:
        args += (param(features),)
    torch.save((args, iteration), path)


def write_reference_decoder(path: str, state: dict) -> None:
    """A d0..dK nn.Linear state dict as the reference's 1x1-Conv2d file."""
    sd = {}
    for k, v in state.items():
        i, kind = k[1:].split(".")
        sd[f"decoder.{2 * int(i)}.{kind}"] = (v[:, :, None, None] if kind == "weight" else v).cpu()
    torch.save({"module_state_dict": sd, "optimizer_state_dict": {}}, path)


def viewer_message(viewmat: np.ndarray, w: int, h: int, fovx: float, fovy: float) -> bytes:
    """A SIBR camera message: the wire carries the view matrix transposed,
    with its y and z columns flipped."""
    wire = np.asarray(viewmat, np.float32).T.copy()
    wire[:, 1] *= -1
    wire[:, 2] *= -1
    msg = dict(resolution_x=w, resolution_y=h, train=True, fov_x=fovx, fov_y=fovy, z_near=0.01,
               z_far=100.0, shs_python=False, rot_scale_python=False, keep_alive=True,
               scaling_modifier=1.0, view_matrix=wire.flatten().tolist(),
               view_projection_matrix=wire.flatten().tolist())
    raw = json.dumps(msg).encode()
    return len(raw).to_bytes(4, "little") + raw


def surface_phase(root: str, tmp: str, dev: torch.device, gpu: str) -> dict:
    """Phase 9d (d): K5 with exit_stats on make_surface_scene at 1280x720
    against its plain version (as phase 9b (b)), the share of tiles that
    stop early (> 0) and K5's device time there and on the fog scene of
    the same size; then the scene as a reference 12-tuple, warm-started for
    SURFACE_GAD_STEPS GAD steps on phase 7's cameras from iteration 0."""
    from gags_torch.cli.train_gad import RunConfig, run
    from gags_torch.splat import kernels
    from gags_torch.splat.rasterizer import RasterizeConfig, _prepare, order_ext
    from gags_torch.utils.synthetic import make_camera, make_scene, make_surface_scene

    cam = make_camera(WIDTH, HEIGHT, device=dev)
    cfg = RasterizeConfig(aligned=False, budget_factor=16)
    out = {}
    surf = make_surface_scene(SURFACE_N, WIDTH, HEIGHT, seed=SURFACE_SEED,
                              opaque_frac=SURFACE_OPAQUE)
    fog = make_scene(SURFACE_N, seed=0, extent=3.0)
    for label, raw in (("surface", surf), ("fog", fog)):
        t = {k: torch.as_tensor(v, device=dev) for k, v in raw.items()}
        _, b, geom, tx, ty = _prepare(t["means"], t["quats"], t["scales"], t["opacities"],
                                      cam.viewmat, cam.K, WIDTH, HEIGHT, cfg)
        if int(b.overflow) != 0:
            fail(f"{label} scene: binning overflow {int(b.overflow)}")
        perm = order_ext(b.order.long())
        cols = torch.cat([t["features"], torch.zeros((1, 16), device=dev)])[perm].contiguous()
        args = (geom[perm].contiguous(), cols, b.inst_gid, b.tile_starts, b.tile_counts,
                torch.zeros(16, device=dev), tx, ty, cfg.tile_h, cfg.tile_w)
        img, st = kernels.blend_forward(*args, exit_stats=True, chunk=cfg.chunk)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img_p, st_p = kernels.blend_forward_plain(*args, exit_stats=True, chunk=cfg.chunk)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        if not torch.equal(img, kernels.blend_forward(*args)):
            fail(f"K5 exit_stats changes the {label} scene's image")
        r = dict(instances=int(b.num_valid), plain_ms=plain_ms,
                 **exit_stats_compare(st, st_p, f"K5 {label} scene"),
                 **flip_tolerant_compare(img, img_p, f"K5 {label} scene C=16"))
        r["early_stop_share"] = r["tiles_stopped_early"] / r["tiles"]
        r["chunks_done_share"] = r["chunks_done"] / max(r["chunks_total"], 1)
        fn = lambda: kernels.blend_forward(*args, exit_stats=True, chunk=cfg.chunk)  # noqa: E731
        r.update(ms=device_ms(fn), events_ms=cuda_ms(fn, 20),
                 ms_no_stats=device_ms(lambda: kernels.blend_forward(*args)))
        out[label] = r
        del t, b, geom, args, img, st, img_p, st_p, cols
        torch.cuda.empty_cache()
    s, f = out["surface"], out["fog"]
    print(f"# 9d surface scene ({SURFACE_N} splats, 1280x720): {s['tiles_stopped_early']} of "
          f"{s['tiles']} tiles stop early (share {s['early_stop_share']:.4f}), chunks done "
          f"{s['chunks_done_share']:.4f}; K5 exit_stats {s['ms']:.4f} ms device (events "
          f"{s['events_ms']:.4f}), {s['instances']} instances; fog scene: share "
          f"{f['early_stop_share']:.4f}, K5 {f['ms']:.4f} ms, {f['instances']} instances ({gpu})",
          flush=True)
    if s["tiles_stopped_early"] <= 0:
        fail(f"surface scene: no tile stopped early: {s}")

    # the scene as a reference 12-tuple (raw opacity and scales), 5 GAD steps
    ck = os.path.join(tmp, "surface_chkpnt.pth")
    op = surf["opacities"].astype(np.float64)
    write_reference_tuple(ck, surf["means"], surf["sh"], np.log(op / (1.0 - op)),
                          np.log(surf["scales"]), surf["quats"], 30000)
    seen, metrics = [], []
    rc = RunConfig(source_path=root, model_path=os.path.join(tmp, "surface_model"),
                   start_checkpoint=ck, resolution=2, iterations=SURFACE_GAD_STEPS,
                   save_iterations="", test_iterations="", device="cuda")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    run(rc, on_step=lambda it, st, m: (seen.append(it), m is not None and metrics.append(m)))
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.launch_counts.items() if v}
    losses = [float(m["loss"]) for m in metrics]
    print(f"# 9d surface scene as a 12-tuple: iterations {seen[0] + 1}-{seen[-1]}, losses "
          f"{losses}, launches {launches} ({gpu})", flush=True)
    if seen[0] != 0 or len(losses) != SURFACE_GAD_STEPS or not np.all(np.isfinite(losses)):
        fail(f"surface warm start: first iteration {seen[0] + 1}, losses {losses}")
    for name in ("blend_forward_aligned", "blend_backward", "sorted_segment_sum",
                 "dense_segment_sum"):
        if launches.get(name, 0) <= 0:
            fail(f"{name} was not launched in the surface scene's GAD steps")
    out["gad"] = dict(losses=losses, launches=launches)
    return out


def warm_phase(root: str, model: str, dev: torch.device, gpu: str) -> dict:
    """Phase 9d (a-c) on phase 7's scene dir and model dir: its chkpnt40 in
    the reference's layout (a 13-tuple with the PLY's geometry, the trained
    features and a real Adam state dict; both decoders as 1x1-conv files),
    then cli.train_gad.run with start_checkpoint, autotune_train, profile
    and a viewer_port for iterations 41-60, a viewer client connected and
    one 1280x720 camera sent just before the first step; (d) the surface
    scene. Returns the report."""
    import shutil
    import socket

    from gags_torch.cli.train_gad import RunConfig, run
    from gags_torch.core.camera import intrinsics_from_fov
    from gags_torch.core.sh import sh_colors
    from gags_torch.gad.train import GadConfig
    from gags_torch.scene.ply import read_gaussian_ply
    from gags_torch.splat import kernels
    from gags_torch.splat.rasterizer import RasterizeConfig, rasterize
    from gags_torch.utils.synthetic import make_camera

    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        ref = os.path.join(tmp, "reference")
        os.makedirs(ref)
        blob = torch.load(os.path.join(model, f"chkpnt{WARM_FROM}", "state.pt"),
                          map_location="cpu", weights_only=True)
        geo = read_gaussian_ply(os.path.join(root, "pretrained.ply"))
        ck = os.path.join(ref, f"chkpnt{WARM_FROM}.pth")
        write_reference_tuple(ck, geo["means"], geo["sh"], geo["opacities_raw"],
                              geo["scales_raw"], geo["quats"], WARM_FROM,
                              features=blob["features"].numpy())
        write_reference_decoder(os.path.join(ref, f"decoder_chkpnt{WARM_FROM}.pth"),
                                blob["decoder"])
        write_reference_decoder(os.path.join(ref, f"scale_decoder_chkpnt{WARM_FROM}.pth"),
                                blob["scale_decoder"])

        # the --resume run from chkpnt40/state.pt: iteration 41's loss
        resumed = os.path.join(tmp, "resumed")
        shutil.copytree(os.path.join(model, f"chkpnt{WARM_FROM}"),
                        os.path.join(resumed, f"chkpnt{WARM_FROM}"))
        first = {}

        def first_params(key):
            def on_step(it, state, m):
                if m is None:
                    first[key] = dict(it=it, features=state.features.detach().clone(),
                                      decoder={k: v.clone() for k, v in
                                               state.decoder.state_dict().items()},
                                      scale={k: v.clone() for k, v in
                                             state.scale_decoder.state_dict().items()})
                elif it == WARM_FROM + 1:
                    first[key]["loss"] = float(m["loss"])
            return on_step

        run(RunConfig(source_path=root, model_path=resumed,
                      ply_path=os.path.join(root, "pretrained.ply"), resolution=2,
                      iterations=WARM_FROM + 1, save_iterations="", test_iterations="",
                      resume=True, device="cuda"), on_step=first_params("resume"))

        # the warm start with the tuner, the profile and the viewer
        cam = make_camera(WIDTH, HEIGHT)
        fovx = 2 * math.atan(WIDTH / (2 * float(cam.K[0, 0])))
        fovy = 2 * math.atan(HEIGHT / (2 * float(cam.K[1, 1])))
        port, reply, clients = free_port(), {}, []
        events, metrics, at_first = [], [], {}
        resume_cb = first_params("warm")

        def on_step(it, state, m):
            resume_cb(it, state, m)
            if m is None:
                at_first.update({k: v for k, v in kernels.launch_counts.items() if v})
                c = socket.create_connection(("127.0.0.1", port), timeout=600)
                c.sendall(viewer_message(cam.viewmat.numpy(), WIDTH, HEIGHT, fovx, fovy))

                def read():
                    img = b""
                    while len(img) < WIDTH * HEIGHT * 3:
                        chunk = c.recv(WIDTH * HEIGHT * 3 - len(img))
                        if not chunk:
                            break
                        img += chunk
                    n = int.from_bytes(c.recv(4), "little")
                    reply.update(img=img, verify=c.recv(n))
                    c.close()
                t = threading.Thread(target=read, daemon=True)
                t.start()
                clients.append(t)
            else:
                metrics.append(m)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)

        warm = os.path.join(tmp, "warm")
        rc = RunConfig(source_path=root, model_path=warm, start_checkpoint=ck, resolution=2,
                       iterations=WARM_TO, save_iterations=str(WARM_TO), test_iterations="",
                       profile=True, autotune_train=True, viewer_port=port, device="cuda")
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        run(rc, on_step=on_step)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {k: v for k, v in kernels.launch_counts.items() if v}
        for t in clients:
            t.join(timeout=60)

        # (b) the checks
        w = first["warm"]
        if w["it"] != WARM_FROM:
            fail(f"warm start: first iteration {w['it'] + 1}, not {WARM_FROM + 1}")
        r = first["resume"]
        same = (torch.equal(w["features"], r["features"])
                and all(torch.equal(w["decoder"][k], r["decoder"][k]) for k in r["decoder"])
                and all(torch.equal(w["scale"][k], r["scale"][k]) for k in r["scale"]))
        if not same:
            fail("warm start and --resume differ in their parameters before the first update")
        if abs(w["loss"] - r["loss"]) > LOSS_ATOL + LOSS_RTOL * abs(r["loss"]):
            fail(f"iteration {WARM_FROM + 1}: warm-start loss {w['loss']} vs --resume "
                 f"{r['loss']} (rtol {LOSS_RTOL})")
        losses = [float(m["loss"]) for m in metrics]
        if len(losses) != WARM_TO - WARM_FROM or not np.all(np.isfinite(losses)):
            fail(f"warm start losses {losses}")
        loop = {k: v - at_first.get(k, 0) for k, v in launches.items() if v - at_first.get(k, 0)}
        for name in ("blend_forward_aligned", "blend_backward", "sorted_segment_sum",
                     "dense_segment_sum"):
            if loop.get(name, 0) < WARM_TO - WARM_FROM:
                fail(f"{name} launched {loop.get(name, 0)} times in the warm start's "
                     f"{WARM_TO - WARM_FROM} steps")
        tuned = json.load(open(os.path.join(warm, "train_autotune.json")))
        saved = GadConfig.load(warm)
        if len(tuned["times_ms"]) != 2 or tuned["winner"] != f"fsup={saved.fused_supervision}":
            fail(f"train autotune: {tuned}, saved fused_supervision {saved.fused_supervision}")
        trace_path = os.path.join(warm, "profile", "trace_iter50-60.json")
        with open(trace_path) as f:
            trace = f.read()
        if "blend_forward_kernel" not in trace:
            fail(f"{trace_path} names no blend_forward_kernel (K1)")
        step_ms = [events[i - 1].elapsed_time(events[i]) for i in range(1, len(events))]
        # step i is iteration 41 + i: 41 also serves the viewer's frame, 50-59 are
        # traced and 60 follows the trace's export
        prof_steps = set(range(50 - WARM_FROM - 1, 60 - WARM_FROM - 1))
        steady = [t for i, t in enumerate(step_ms) if 0 < i < 50 - WARM_FROM - 1]
        report["warm_start"] = dict(
            first_iteration=w["it"] + 1, loss=w["loss"], resume_loss=r["loss"],
            loss_rel_diff=abs(w["loss"] - r["loss"]) / abs(r["loss"]), losses=losses,
            tuner_ms=tuned["times_ms"], tuner_winner=tuned["winner"],
            step_median_ms=float(np.median(steady)), steps_timed=len(steady),
            profiled_step_median_ms=float(np.median([step_ms[i] for i in sorted(prof_steps)])),
            run_s=run_s, launches_setup_and_tuner=at_first, launches_loop=loop,
            trace_mb=len(trace) / 2 ** 20)
        print(f"# 9d warm start from a reference 13-tuple: first iteration {w['it'] + 1}, loss "
              f"{w['loss']:.6f} vs --resume {r['loss']:.6f}; tuner {tuned['times_ms']} ms, "
              f"winner {tuned['winner']}; step median {report['warm_start']['step_median_ms']:.3f}"
              f" ms over {len(steady)} unprofiled steps; launches set-up + tuner {at_first}, "
              f"loop {loop}; trace {report['warm_start']['trace_mb']:.1f} MiB ({gpu})", flush=True)
        del trace

        # (c) the viewer's frame against a direct rasterize of the same camera
        if reply.get("verify") != root.encode() or len(reply.get("img", b"")) != WIDTH * HEIGHT * 3:
            fail(f"viewer: no full frame came back ({len(reply.get('img', b''))} bytes)")
        for name in ("blend_forward", "expand_gid"):
            if loop.get(name, 0) <= 0:
                fail(f"viewer: {name} was not launched for its frame")
        g = {k: torch.as_tensor(v, device=dev) for k, v in geo.items()}
        vm, K = cam.viewmat.to(dev), torch.as_tensor(
            intrinsics_from_fov(fovx, fovy, WIDTH, HEIGHT), device=dev)
        with torch.no_grad():
            colors = sh_colors(3, g["sh"], g["means"], -vm[:3, :3].T @ vm[:3, 3])
            res = rasterize(g["means"], g["quats"], torch.exp(g["scales_raw"]),
                            torch.sigmoid(g["opacities_raw"]), colors, vm, K, WIDTH, HEIGHT,
                            background=torch.zeros(3, device=dev),
                            config=RasterizeConfig(aligned=False), device=dev)
        want = (np.clip(res.image.cpu().numpy(), 0, 1) * 255).astype(np.uint8).tobytes()
        n_diff = sum(a != b for a, b in zip(reply["img"], want))
        if n_diff:
            fail(f"viewer frame differs from a direct rasterize at {n_diff} bytes")
        report["viewer"] = dict(bytes=len(want), equal=True, launches={
            k: loop.get(k, 0) for k in ("blend_forward", "expand_gid")})
        print(f"# 9d viewer: a 1280x720 frame equal to a direct rasterize byte for byte; "
              f"launches {report['viewer']['launches']} ({gpu})", flush=True)
        del g, res, blob, geo

        # (d) the trained-statistics scene
        report["surface"] = surface_phase(root, tmp, dev, gpu)
    return report


# phase 16: multi-rank training and rendering (gags_torch.parallel) on
# phase 7's fixture and model dir, two ranks sharing the one card over gloo
# (NCCL takes one card a rank); no figure here is a speed-up figure

MULTI_RANKS = 2
MULTI_LABEL = "2 ranks sharing one H100 over gloo"
DP_STEPS = 20
GSHARD_TIMED = 8
COLLECTIVE_REPS = 5
# the multi-rank runs against one process: K4 adds with float atomics in
# no fixed order, and Adam divides each gradient by its own running scale,
# so a gradient within rounding of zero may move its parameter by up to
# 2 lr a step; at most MULTI_FLIP_FRACTION of the parameters may, every
# other one must agree within MULTI_ATOL
MULTI_ATOL = 1e-6
MULTI_FLIP_FRACTION = 1e-4
# the strip step against one process: each feature channel and each
# decoder tensor within this share of its largest gradient (K3 and K4 sum
# per strip, then across the ranks)
GSHARD_GRAD_RTOL = 1e-4


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class StepRecorder:
    """on_step of the data-parallel trainer (pickled; it runs on rank 0):
    a CUDA event (on the card) and the loss of every step and rank 0's
    kernel launches over the loop, written to `path` as JSON after the last
    step."""

    def __init__(self, path: str, last: int, device: str):
        self.path, self.last, self.device = path, last, torch.device(device)
        self.marks, self.losses, self.start = [], [], None

    def __call__(self, it, state, metrics):
        from gags_torch.splat import kernels

        if self.device.type == "cuda":
            mark = torch.cuda.Event(enable_timing=True)
            mark.record()
        else:  # a rehearsal on the CPU
            mark = time.perf_counter()
        self.marks.append(mark)
        if metrics is None:
            self.start = dict(kernels.launch_counts)
            return
        self.losses.append(metrics["loss"].detach().clone())
        if it == self.last:
            _sync(self.device)
            pairs = zip(self.marks, self.marks[1:])
            ms = ([a.elapsed_time(b) for a, b in pairs] if self.device.type == "cuda"
                  else [(b - a) * 1e3 for a, b in pairs])
            with open(self.path, "w") as f:
                json.dump(dict(
                    step_ms=ms, losses=[float(x) for x in self.losses], pid=os.getpid(),
                    launches={k: v - self.start[k] for k, v in kernels.launch_counts.items()}), f)


def _synced_ms(fn, reps: int, dev: torch.device) -> list:
    """Host-clock ms of `reps` calls of fn, each between synchronises (a
    gloo collective waits on the host)."""
    out = []
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _train_inputs(root: str, ply: str, dev: torch.device):
    from gags_torch.gad.data import GadDataset
    from gags_torch.gad.train import GadConfig, create_train_state, frozen_geometry
    from gags_torch.scene.dataset import detect_and_load
    from gags_torch.scene.gaussian_data import GaussianScene

    cfg = GadConfig()
    ds = GadDataset(detect_and_load(root).train_cameras, resolution=2)
    scene = GaussianScene.from_ply(ply, device=dev)
    state = create_train_state(scene, cfg, seed=0, device=dev)
    return cfg, ds, state, frozen_geometry(scene)


def _named_grads(state, features_grad) -> dict:
    out = {"features": features_grad}
    for mod in ("decoder", "scale_decoder"):
        out.update({f"{mod}.{k}": p.grad for k, p in getattr(state, mod).named_parameters()})
    return out


def _one_process_step(cfg, ds, state, geom, cams, ew, rw, cache=None) -> float:
    """One process on card 0: the cameras' gradients accumulated, divided
    by their count, the three Adam steps (binned where `cache` is given).
    Returns the mean loss."""
    from gags_torch.gad.train import camera_loss
    from gags_torch.parallel.sharding import train_params

    loss = 0.0
    for i in cams:
        batch = {k: torch.as_tensor(v, device=state.device) for k, v in ds.batch(int(i)).items()}
        if cache is not None:
            batch.update(cache[int(i)])
        total, _ = camera_loss(state, geom, batch, ew, rw, ds.width, ds.height, cfg,
                               binned=cache is not None)
        total.backward()
        loss += float(total.detach()) / len(cams)
    for p in train_params(state):
        p.grad /= len(cams)
    for opt in (state.opt_feat, state.opt_dec, state.opt_scale):
        opt.step()
    return loss


def _checkpoint_params(path: str) -> dict:
    blob = torch.load(path, map_location="cpu", weights_only=True)
    return {"features": blob["features"],
            **{f"decoder.{k}": v for k, v in blob["decoder"].items()},
            **{f"scale_decoder.{k}": v for k, v in blob["scale_decoder"].items()}}


def _state_params(state) -> dict:
    return {"features": state.features.detach(),
            **{f"decoder.{k}": v for k, v in state.decoder.state_dict().items()},
            **{f"scale_decoder.{k}": v for k, v in state.scale_decoder.state_dict().items()}}


def multi_rank(ctx, root: str, ply: str, trained_ply: str, serve: tuple) -> dict:
    """Phase 16 (b)-(d) on one of the ranks; the launch counts of each
    distributed path are read around it, so rank 0's own references do not
    count. serve: (Gaussians, width, height) of (c)."""
    from gags_torch.gad.train import loss_weights
    from gags_torch.parallel import (gshard_state, make_dp_render, make_gshard_render,
                                     make_gshard_train_step, make_mesh, shard_gaussians)
    from gags_torch.parallel.collectives import all_gather_tensor, reduce_scatter_tensor
    from gags_torch.parallel.gshard import _real_rows, _strip_geometry
    from gags_torch.scene.gaussian_data import GaussianScene
    from gags_torch.splat import kernels
    from gags_torch.splat.rasterizer import RasterizeConfig, rasterize
    from gags_torch.utils.synthetic import make_camera, make_scene

    dev, mesh, lead = ctx.device, make_mesh(), ctx.rank == 0
    n_serve, width, height = serve
    out = {}

    # (b) the strip step at the train configuration, camera 0
    cfg, ds, state, geom = _train_inputs(root, ply, dev)
    w, h = ds.width, ds.height
    batch = {k: torch.as_tensor(v, device=dev) for k, v in ds.batch(0).items()}
    ew, rw = loss_weights(1, cfg)
    geom_l, _ = shard_gaussians(geom, state.features, mesh)
    gs = gshard_state(state, mesh)
    del state
    step = make_gshard_train_step(mesh, w, h, cfg)
    _sync(dev)
    kernels.reset_launch_counts()
    gs, m1 = step(gs, geom_l, batch, ew, rw)
    full_grad = all_gather_tensor(gs.features.grad)
    grads1 = {k: v.detach().cpu() for k, v in _named_grads(gs, full_grad).items()}
    gs, m2 = step(gs, geom_l, batch, ew, rw)
    _sync(dev)
    out["gshard_launches"] = dict(kernels.launch_counts)
    feats2 = all_gather_tensor(gs.features.detach())
    step_ms = _synced_ms(lambda: step(gs, geom_l, batch, ew, rw), GSHARD_TIMED, dev)
    rows = torch.zeros((geom_l["means"].shape[0], 9), device=dev)
    feats_l = gs.features.detach()
    colls = dict(
        all_gather_rows=(_synced_ms(lambda: all_gather_tensor(rows), COLLECTIVE_REPS, dev),
                         rows.numel() * 4 * MULTI_RANKS),
        all_gather_features=(_synced_ms(lambda: all_gather_tensor(feats_l), COLLECTIVE_REPS,
                                        dev), feats_l.numel() * 4 * MULTI_RANKS),
        reduce_scatter_features=(_synced_ms(lambda: reduce_scatter_tensor(full_grad),
                                            COLLECTIVE_REPS, dev), full_grad.numel() * 4))
    strip_h = _strip_geometry(cfg.raster, h, MULTI_RANKS)[1]
    if lead:
        out["gshard"] = dict(
            losses=[float(m1["loss"]), float(m2["loss"])],
            overflow=[int(m1["overflow"]), int(m2["overflow"])],
            grads=grads1,
            features2=feats2.cpu(), step_ms=step_ms, strip_h=strip_h,
            real_rows=[_real_rows(cfg.raster, h, MULTI_RANKS, r)[1] for r in range(MULTI_RANKS)],
            collectives={k: dict(ms=float(np.median(v)), bytes=b) for k, (v, b) in colls.items()})
    del gs, geom_l, full_grad, feats2, feats_l, rows, geom

    # (c) the strip render at the serve configuration
    raw = make_scene(n_serve, seed=0, extent=3.0)
    g = {k: torch.as_tensor(raw[k], device=dev) for k in ("means", "quats", "scales", "opacities")}
    colors = torch.as_tensor(raw["features"], device=dev)
    cam = make_camera(width, height, device=dev)
    g_l, c_l = shard_gaussians(g, colors, mesh)
    renders = {}
    for label, rcfg in (("K6", RasterizeConfig()),
                        ("K7, cull", RasterizeConfig(fused_keys=True, tile_cull=True))):
        render = make_gshard_render(mesh, width, height, colors.shape[1], rcfg)
        _sync(dev)
        kernels.reset_launch_counts()
        img, alpha, ovf = render(g_l, c_l, cam.viewmat, cam.K)
        _sync(dev)
        renders[label] = dict(launches=dict(kernels.launch_counts), overflow=int(ovf),
                              ms=float(np.median(_synced_ms(
                                  lambda: render(g_l, c_l, cam.viewmat, cam.K), 5, dev))))
        if lead:
            one = rasterize(g["means"], g["quats"], g["scales"], g["opacities"], colors,
                            cam.viewmat, cam.K, width, height,
                            config=RasterizeConfig(aligned=False), device=dev)
            renders[label].update(
                image=flip_tolerant_compare(img, one.image,
                                            f"strip render ({label}) vs one-process rasterize"),
                alpha=flip_tolerant_compare(alpha, one.alpha,
                                            f"strip render alpha ({label}) vs one-process"))
    out["gshard_render"] = renders
    del g, colors, g_l, c_l, img, alpha

    # (d) the camera-parallel render: phase 7's four cameras, trained features
    scene = GaussianScene.from_ply(trained_ply, device=dev)
    gt = dict(means=scene.means, quats=scene.quats, scales=scene.scales,
              opacities=scene.opacities)
    vms = torch.stack([torch.as_tensor(ex.viewmat, device=dev) for ex in ds.examples])
    Ks = torch.stack([torch.as_tensor(ex.K, device=dev) for ex in ds.examples])
    bg = torch.zeros((scene.semantic_features.shape[1],), device=dev)
    render = make_dp_render(mesh, w, h, cfg.raster)
    _sync(dev)
    kernels.reset_launch_counts()
    imgs, alphas = render(gt, scene.semantic_features, vms, Ks, bg)
    _sync(dev)
    out["dp_render"] = dict(launches=dict(kernels.launch_counts), cameras=int(vms.shape[0]))
    if lead:
        one = dataclasses.replace(cfg.raster, aligned=False)
        seq = [rasterize(gt["means"], gt["quats"], gt["scales"], gt["opacities"],
                         scene.semantic_features, vms[i], Ks[i], w, h, background=bg,
                         config=one, device=dev) for i in range(vms.shape[0])]
        out["dp_render"]["bit_identical"] = all(
            torch.equal(imgs[i], s.image) and torch.equal(alphas[i], s.alpha)
            for i, s in enumerate(seq))
    return out


def _sum_launches(results, key) -> dict:
    out = {}
    for r in results:
        for k, v in r[key].items():
            out[k] = out.get(k, 0) + v
    return out


def _flip_tolerant_params(got: dict, want: dict, lr: dict, what: str, steps: int = 1) -> dict:
    """max |got - want| over each tensor, and the elements beyond
    MULTI_ATOL: at most MULTI_FLIP_FRACTION of them, each within 2 lr a
    step of its group plus MULTI_ATOL (an Adam step of a flipped sign)."""
    res, beyond, total = {}, 0, 0
    for k, t in want.items():
        d = (got[k].float() - t.float().cpu()).abs()
        n_bad = int((d > MULTI_ATOL).sum())
        res[k] = dict(max_abs_diff=float(d.max()), beyond_atol=n_bad)
        if float(d.max()) > 2 * steps * lr[k.split(".")[0]] + MULTI_ATOL:
            fail(f"{what}: {k} differs by {float(d.max())} (more than 2 lr a step)")
        beyond += n_bad
        total += d.numel()
    summary = dict(max_abs_diff=max(v["max_abs_diff"] for v in res.values()), beyond_atol=beyond,
                   elements=total, bit_identical=beyond == 0 and all(
                       torch.equal(got[k].float(), want[k].float().cpu()) for k in want))
    print(f"# {what}: {summary}", flush=True)
    if beyond > MULTI_FLIP_FRACTION * total:
        fail(f"{what}: {beyond} of {total} parameters beyond {MULTI_ATOL}")
    return summary


def multi_phase(root: str, model: str, dev: torch.device, gpu: str) -> dict:
    """Phase 16 on phase 7's scene dir and model dir: (a) cli.train_gad.run
    with devices=2 (gloo, both ranks on this card) for DP_STEPS iterations,
    its parameters after iteration 1 against one process that accumulates
    the same two cameras' gradients, halves them and takes the three Adam
    steps; (b) the strip step (2 strips of 6 tile rows at 640x360, 24 pad
    rows) against the one-process step: loss, raw gradients, features
    after 2 steps; (c) the strip render at the serve configuration against
    one-process rasterize; (d) make_dp_render of the four cameras against
    sequential renders. Returns the report."""
    from gags_torch.cli.train_gad import RunConfig, _bin_cache, run
    from gags_torch.gad.train import loss_weights, make_train_step
    from gags_torch.parallel import launch

    ply = os.path.join(root, "pretrained.ply")
    trained_ply = os.path.join(model, "point_cloud", f"iteration_{TRAIN_STEPS}", "point_cloud.ply")
    report = dict(backend="gloo", ranks=MULTI_RANKS, label=MULTI_LABEL)
    print(f"# phase 16: {MULTI_RANKS} ranks over gloo on one card ({MULTI_LABEL}; {gpu})",
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        # -- (a) the data-parallel trainer ------------------------------------
        dp_model = os.path.join(tmp, "model_dp")
        rec = os.path.join(tmp, "steps.json")
        rc = RunConfig(source_path=root, model_path=dp_model, ply_path=ply, resolution=2,
                       iterations=DP_STEPS, save_iterations=f"1,{DP_STEPS}",
                       test_iterations="", device=dev.type, devices=MULTI_RANKS,
                       dist_backend="gloo", deadline=600)
        t0 = time.perf_counter()
        final = run(rc, on_step=StepRecorder(rec, DP_STEPS, dev.type))
        run_s = time.perf_counter() - t0
        with open(rec) as f:
            steps = json.load(f)
        if final.step != DP_STEPS or len(steps["losses"]) != DP_STEPS or not np.all(
                np.isfinite(steps["losses"])):
            fail(f"data-parallel trainer: step {final.step}, losses {steps['losses']}")
        want = sorted(["cameras.json", "cfg.json", "gad_cfg.json", "chkpnt1",
                       f"chkpnt{DP_STEPS}", "decoders.pt", "metrics.jsonl", "point_cloud"])
        have = sorted(n for n in os.listdir(dp_model) if "tfevents" not in n)
        if have != want or steps["pid"] == os.getpid():
            fail(f"data-parallel model dir {have}, wanted {want} written by rank 0")
        for name in ("blend_forward_aligned", "blend_backward", "sorted_segment_sum",
                     "dense_segment_sum"):
            if dev.type == "cuda" and steps["launches"][name] < DP_STEPS:
                fail(f"{name}: {steps['launches'][name]} launches on rank 0 in {DP_STEPS} steps")
        # one process: the same two cameras, gradients halved, three Adam steps
        cfg, ds, state, geom = _train_inputs(root, ply, dev)
        cache, _ = _bin_cache(geom, ds, cfg, dev)
        ew, rw = loss_weights(1, cfg)
        loss1 = _one_process_step(cfg, ds, state, geom,
                                  ds.epoch_order(np.random.default_rng(rc.seed))[:MULTI_RANKS],
                                  ew, rw, cache)
        if not np.isclose(steps["losses"][0], loss1, rtol=2e-5, atol=0):
            fail(f"DP trainer iteration 1 loss {steps['losses'][0]} vs one process {loss1}")
        lr = dict(features=cfg.feature_lr, decoder=cfg.decoder_lr, scale_decoder=cfg.decoder_lr)
        check = _flip_tolerant_params(_checkpoint_params(os.path.join(dp_model, "chkpnt1",
                                                                      "state.pt")),
                                      _state_params(state), lr,
                                      "DP trainer iteration 1 vs one process")
        steady = np.asarray(steps["step_ms"][2:])
        report["dp_train"] = dict(
            steps=DP_STEPS, seconds=run_s, median_ms=float(np.median(steady)),
            p90_ms=float(np.percentile(steady, 90)), first_ms=steps["step_ms"][0],
            loss_first=steps["losses"][0], one_process_loss_first=loss1,
            loss_last=steps["losses"][-1],
            launches_rank0=steps["launches"], iteration1_vs_one_process=check)
        print(f"# phase 16 (a) DP trainer, {DP_STEPS} iterations of 2 cameras in {run_s:.1f} s "
              f"(set-up and spawn included): iteration median {report['dp_train']['median_ms']:.2f}"
              f" ms, p90 {report['dp_train']['p90_ms']:.2f} ({MULTI_LABEL}; {gpu})", flush=True)
        del state, geom, cache

        # -- (b)-(d) in one rank group ----------------------------------------
        results = [r.result for r in launch.spawn(
            multi_rank, MULTI_RANKS, "gloo", dev.type,
            args=(root, ply, trained_ply, (N_GAUSSIANS, WIDTH, HEIGHT)), deadline=600)]
    gsh = results[0]["gshard"]
    if gsh["overflow"] != [0, 0] or min(gsh["real_rows"]) >= gsh["strip_h"]:
        fail(f"strip step: overflow {gsh['overflow']}, rows {gsh['real_rows']} of "
             f"{gsh['strip_h']} a strip (pad rows expected)")
    cfg, ds, state, geom = _train_inputs(root, ply, dev)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in ds.batch(0).items()}
    ew, rw = loss_weights(1, cfg)
    step = make_train_step(ds.width, ds.height, cfg)
    _, m1 = step(state, geom, batch, ew, rw)
    grads = {k: v.cpu() for k, v in _named_grads(state, state.features.grad).items()}
    _, m2 = step(state, geom, batch, ew, rw)
    losses = [float(m1["loss"]), float(m2["loss"])]
    if not np.allclose(gsh["losses"], losses, rtol=2e-5, atol=0):
        fail(f"strip step losses {gsh['losses']} vs one process {losses} (rtol 2e-5)")
    worst = 0.0
    for k, want_g in grads.items():
        got_g = gsh["grads"][k]
        # per feature channel; per decoder tensor
        pairs = (zip(got_g[: want_g.shape[0]].T, want_g.T) if k == "features"
                 else [(got_g, want_g)])
        for c, (a, b) in enumerate(pairs):
            scale = float(b.abs().max())
            err = float((a - b).abs().max())
            worst = max(worst, err / max(scale, 1e-30))
            if err > GSHARD_GRAD_RTOL * scale:
                fail(f"strip step gradient {k}[{c}]: {err} against its largest {scale} "
                     f"(limit {GSHARD_GRAD_RTOL} of it)")
    f2 = _flip_tolerant_params({"features": gsh["features2"][: state.features.shape[0]]},
                               {"features": state.features.detach()},
                               {"features": cfg.feature_lr},
                               "strip step features after 2 steps vs one process", steps=2)
    coll = gsh["collectives"]
    report["gshard_train"] = dict(
        losses=gsh["losses"], one_process_losses=losses, worst_grad_column_rel=worst,
        features_after_2=f2, strip_h=gsh["strip_h"], real_rows=gsh["real_rows"],
        median_ms=float(np.median(gsh["step_ms"])), step_ms=gsh["step_ms"], collectives=coll)
    print(f"# phase 16 (b) strip step, 2 strips of {gsh['strip_h']} rows ({gsh['real_rows']} in "
          f"the image): loss {gsh['losses'][0]:.6f} vs {losses[0]:.6f}, worst gradient column "
          f"{worst:.2e} of its largest; median {report['gshard_train']['median_ms']:.2f} ms "
          f"({MULTI_LABEL}; {gpu})", flush=True)
    for k, v in coll.items():
        print(f"# phase 16 (b) {k}: {v['bytes'] / 1e6:.1f} MB in {v['ms']:.2f} ms "
              f"({MULTI_LABEL}; {gpu})", flush=True)
    rend = results[0]["gshard_render"]
    for label, r in rend.items():
        if r["overflow"] != 0:
            fail(f"strip render ({label}): overflow {r['overflow']}")
    if not results[0]["dp_render"]["bit_identical"]:
        fail("make_dp_render differs from sequential renders")
    report["gshard_render"] = {k: {kk: v for kk, v in r.items() if kk != "launches"}
                               for k, r in rend.items()}
    report["dp_render"] = dict(cameras=results[0]["dp_render"]["cameras"], bit_identical=True)
    print(f"# phase 16 (c) strip render at 1280x720 / 250k: "
          f"{ {k: round(r['ms'], 3) for k, r in rend.items()} } ms; (d) make_dp_render of "
          f"{report['dp_render']['cameras']} cameras bit for bit ({MULTI_LABEL}; {gpu})",
          flush=True)
    report["distributed_launches"] = {
        "dp_train (rank 0)": steps["launches"],
        "gshard_train (2 steps, both ranks)": _sum_launches(results, "gshard_launches"),
        "gshard_render K6 (both ranks)": _sum_launches(
            [r["gshard_render"]["K6"] for r in results], "launches"),
        "gshard_render K7, cull (both ranks)": _sum_launches(
            [r["gshard_render"]["K7, cull"] for r in results], "launches"),
        "dp_render (both ranks)": _sum_launches([r["dp_render"] for r in results], "launches"),
    }
    want_launch = {
        "gshard_train (2 steps, both ranks)": ("blend_forward_aligned", "blend_backward",
                                               "sorted_segment_sum", "dense_segment_sum",
                                               "expand_gid"),
        "gshard_render K6 (both ranks)": ("blend_forward", "expand_gid"),
        "gshard_render K7, cull (both ranks)": ("blend_forward", "expand_keys"),
        "dp_render (both ranks)": ("blend_forward", "expand_gid"),
    }
    for path, names in want_launch.items():
        for name in names:  # the CPU (a rehearsal) runs the plain versions
            if dev.type == "cuda" and report["distributed_launches"][path].get(name, 0) <= 0:
                fail(f"{name} was not launched in {path}")
    print(f"# phase 16 launches in the ranks: {report['distributed_launches']}", flush=True)
    return report


# --nccl: the NCCL path, one rank a card, on NCCL_RANKS cards

NCCL_RANKS = 4
NCCL_ITERS = 10
NCCL_LABEL = f"{NCCL_RANKS} ranks, one H100 each, over NCCL"


def nccl_rank(ctx, root: str, ply: str) -> dict:
    """One rank of the --nccl check: the 1-D strip step on NCCL_RANKS
    strips (camera 0; raw gradients after step 1, then timed steps) and
    the dp 2 x gs 2 step (camera dp)."""
    import torch.distributed as dist

    from gags_torch.gad.train import loss_weights
    from gags_torch.parallel import (gshard_state, make_dp_gshard_train_step,
                                     make_gshard_train_step, make_mesh, make_mesh2d,
                                     shard_gaussians)
    from gags_torch.parallel.collectives import all_gather_tensor

    dev, lead = ctx.device, ctx.rank == 0
    out = dict(device=str(dev), backend=dist.get_backend())
    cfg, ds, state, geom = _train_inputs(root, ply, dev)
    ew, rw = loss_weights(1, cfg)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in ds.batch(0).items()}
    mesh = make_mesh()
    geom_l, _ = shard_gaussians(geom, state.features, mesh)
    gs = gshard_state(state, mesh)
    step = make_gshard_train_step(mesh, ds.width, ds.height, cfg)
    gs, m = step(gs, geom_l, batch, ew, rw)
    grads = {k: v.detach().cpu() for k, v in _named_grads(
        gs, all_gather_tensor(gs.features.grad)).items()}
    ms = _synced_ms(lambda: step(gs, geom_l, batch, ew, rw), GSHARD_TIMED, dev)
    if lead:
        out["gshard"] = dict(loss=float(m["loss"]), overflow=int(m["overflow"]), grads=grads,
                             median_ms=float(np.median(ms)))
    del gs, geom_l, state, geom
    mesh2 = make_mesh2d(2, NCCL_RANKS // 2)
    cfg, ds, state, geom = _train_inputs(root, ply, dev)
    geom_l, _ = shard_gaussians(geom, state.features, mesh2, axis="gs")
    gs = gshard_state(state, mesh2, axis="gs")
    cam = {k: torch.as_tensor(v, device=dev) for k, v in ds.batch(mesh2.coords["dp"]).items()}
    gs, m = make_dp_gshard_train_step(mesh2, ds.width, ds.height, cfg)(gs, geom_l, cam, ew, rw)
    feats = all_gather_tensor(gs.features.detach(), mesh2.groups["gs"])
    if lead:
        out["dp_gshard"] = dict(loss=float(m["loss"]), overflow=int(m["overflow"]),
                                features=feats.cpu())
    return out


def nccl_main() -> int:
    """`python3 chip_smoke.py --nccl`, on a machine with NCCL_RANKS cards:
    phase 7's training fixture, then (a) cli.train_gad.run with
    devices=NCCL_RANKS over NCCL (the default on cuda) for NCCL_ITERS
    iterations, chkpnt1 against one process on card 0 that accumulates
    the same cameras' gradients and divides them by their count (phase
    16's tolerances; NCCL sums in its own order); (b) the 1-D strip step
    on NCCL_RANKS strips against the one-process step (losses rtol 2e-5,
    each gradient column within GSHARD_GRAD_RTOL of its largest); (c) the
    dp 2 x gs 2 step against the one-process two-camera step."""
    from gags_torch import _kernels
    from gags_torch.cli.train_gad import RunConfig, _bin_cache, run
    from gags_torch.gad.train import loss_weights, make_train_step
    from gags_torch.parallel import launch
    from gags_torch.splat import kernels

    if not torch.cuda.is_available() or torch.cuda.device_count() < NCCL_RANKS:
        fail(f"--nccl needs {NCCL_RANKS} CUDA cards")
    gpu = gpu_line()
    print(f"# cards: {torch.cuda.device_count()} x {gpu}; torch {torch.__version__}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _kernels.build(list(kernels.SOURCES))
    dev = torch.device("cuda", 0)
    report = dict(label=NCCL_LABEL)
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "scene")
        ply = write_train_fixture(root)
        # -- (a) train_gad --devices over NCCL -------------------------------
        model, rec = os.path.join(tmp, "model"), os.path.join(tmp, "steps.json")
        rc = RunConfig(source_path=root, model_path=model, ply_path=ply, resolution=2,
                       iterations=NCCL_ITERS, save_iterations=f"1,{NCCL_ITERS}",
                       test_iterations="", device="cuda", devices=NCCL_RANKS, deadline=600)
        t0 = time.perf_counter()
        run(rc, on_step=StepRecorder(rec, NCCL_ITERS, "cuda"))
        run_s = time.perf_counter() - t0
        with open(rec) as f:
            steps = json.load(f)
        cfg, ds, state, geom = _train_inputs(root, ply, dev)
        cache, _ = _bin_cache(geom, ds, cfg, dev)
        ew, rw = loss_weights(1, cfg)
        cams = ds.epoch_order(np.random.default_rng(rc.seed))[:NCCL_RANKS]
        loss1 = _one_process_step(cfg, ds, state, geom, cams, ew, rw, cache)
        if not np.isclose(steps["losses"][0], loss1, rtol=2e-5, atol=0):
            fail(f"NCCL DP iteration 1 loss {steps['losses'][0]} vs one process {loss1}")
        lr = dict(features=cfg.feature_lr, decoder=cfg.decoder_lr, scale_decoder=cfg.decoder_lr)
        check = _flip_tolerant_params(_checkpoint_params(os.path.join(model, "chkpnt1",
                                                                      "state.pt")),
                                      _state_params(state), lr,
                                      "NCCL DP trainer iteration 1 vs one process")
        steady = np.asarray(steps["step_ms"][2:])
        report["dp_train"] = dict(iterations=NCCL_ITERS, seconds=run_s,
                                  median_ms=float(np.median(steady)),
                                  p90_ms=float(np.percentile(steady, 90)), loss1=steps["losses"][0],
                                  one_process_loss1=loss1, launches_rank0=steps["launches"],
                                  iteration1_vs_one_process=check)
        print(f"# (a) DP trainer, {NCCL_ITERS} iterations of {NCCL_RANKS} cameras in {run_s:.1f} s "
              f"(set-up and spawn included): iteration median "
              f"{report['dp_train']['median_ms']:.2f} ms ({NCCL_LABEL}; {gpu})", flush=True)
        del state, geom, cache
        # -- (b), (c) the strip steps over NCCL --------------------------------
        res = [r.result for r in launch.spawn(nccl_rank, NCCL_RANKS, "nccl", "cuda",
                                              args=(root, ply), deadline=600)]
        if any(r["backend"] != "nccl" for r in res) or len({r["device"] for r in res}) != NCCL_RANKS:
            fail(f"ranks: {[(r['device'], r['backend']) for r in res]}")
        g = res[0]["gshard"]
        cfg, ds, state, geom = _train_inputs(root, ply, dev)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in ds.batch(0).items()}
        _, m = make_train_step(ds.width, ds.height, cfg)(state, geom, batch, ew, rw)
        worst = 0.0
        for k, want in _named_grads(state, state.features.grad).items():
            want, got = want.cpu(), g["grads"][k]
            pairs = zip(got[: want.shape[0]].T, want.T) if k == "features" else [(got, want)]
            for a, b in pairs:
                worst = max(worst, float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30))
        if (g["overflow"] or worst > GSHARD_GRAD_RTOL
                or not np.isclose(g["loss"], float(m["loss"]), rtol=2e-5, atol=0)):
            fail(f"NCCL strip step: loss {g['loss']} vs {float(m['loss'])}, overflow "
                 f"{g['overflow']}, worst gradient column {worst}")
        report["gshard_train"] = dict(loss=g["loss"], one_process_loss=float(m["loss"]),
                                      worst_grad_column_rel=worst, median_ms=g["median_ms"])
        print(f"# (b) strip step, {NCCL_RANKS} strips: worst gradient column {worst:.2e} of its "
              f"largest; median {g['median_ms']:.2f} ms ({NCCL_LABEL}; {gpu})", flush=True)
        del state, geom
        cfg, ds, state, geom = _train_inputs(root, ply, dev)
        _one_process_step(cfg, ds, state, geom, (0, 1), ew, rw)
        d = res[0]["dp_gshard"]
        if d["overflow"]:
            fail(f"NCCL dp x gs step: overflow {d['overflow']}")
        report["dp_gshard"] = dict(loss=d["loss"], features_after_1=_flip_tolerant_params(
            {"features": d["features"][: state.features.shape[0]]},
            {"features": state.features.detach()}, {"features": cfg.feature_lr},
            "NCCL dp 2 x gs 2 features vs one process"))
    print(f"# nccl report: {json.dumps(report)}")
    print(f"gpu: {gpu}")
    return 0


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


def k8_columns(got, want_col, want_geo, label: str, extra=()) -> dict:
    """K8's outputs against its plain version's at the CPU test's
    tolerance, column by column (the conic columns are thousands of times
    larger than mx, my and opacity): at most 0.1% of values outside 1e-5
    max|g| + 1e-4 rel (isolated threshold flips), mean error at most 1e-5
    max|g| and 1e-3 mean|g|. `extra`: more (name, got, want) columns."""
    if bool(got[1][:, 6:].any()):
        fail("K8 blend_backward_full writes geometry rows 6-7")
    out = {}
    for what, g, wnt in ([(f"colour {j}", got[0][:, j], want_col[:, j])
                          for j in range(want_col.shape[1])]
                         + [(name, got[1][:, j], want_geo[:, j]) for j, name in
                            enumerate(("mx", "my", "ca", "cb", "cc", "opacity"))]
                         + list(extra)):
        scale = float(wnt.abs().max())
        err = (g - wnt).abs()
        c = {"max_abs_err": float(err.max()), "mean_abs_err": float(err.mean()),
             "frac_outside": float((err > 1e-5 * scale + 1e-4 * wnt.abs()).float().mean()),
             "max_abs_grad": scale, "mean_abs_grad": float(wnt.abs().mean())}
        print(f"# K8 blend_backward_full {label}{what}: {c}", flush=True)
        if (not torch.isfinite(g).all() or scale == 0 or c["frac_outside"] > 1e-3
                or c["mean_abs_err"] > 1e-5 * scale
                or c["mean_abs_err"] > 1e-3 * c["mean_abs_grad"]):
            fail(f"K8 blend_backward_full {label}{what} disagrees with its plain version: {c}")
        out[label + what] = c
    return out


def rgb_phase(dev: torch.device, gpu: str, after) -> tuple:
    """Phases 10-13: RGB pretraining through cli.train_rgb.run at 1280x720,
    the step's times and profile, K8 against its plain version on the
    trained state with the loss's real cotangents, and the snapshot PLY
    rendered; then `after(scene dir, model dir)` (phase 14) while both
    exist. Returns K8's report entry, K3's at the RGB widths, K1's at the
    RGB width, K6's on the step's aligned binning and what after
    returned."""
    import dataclasses

    from gags_torch.cli.train_rgb import RunConfig, run
    from gags_torch.core.sh import sh_colors
    from gags_torch.rgb.train import RgbConfig, make_rgb_step
    from gags_torch.scene.dataset import camera_from_info, detect_and_load
    from gags_torch.scene.gaussian_data import GaussianScene
    from gags_torch.splat import kernels, tiles
    from gags_torch.splat.projection import project_gaussians
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
        imgs = [load_rgb(ci.image_path, c.width, c.height, dev).to(torch.float32) / 255.0
                for ci, c in zip(info.train_cameras, cams)]
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
            # K6 where it runs most: the step's aligned binning of camera 0,
            # every slot of the state (alive first, the parked ones an empty
            # tail), m_real slots at the step's budget
            pj = project_gaussians(*geo[:3], vm, K, w, h,
                                   opacities=geo[3] if cfg.raster.opacity_extents else None)
            _, _, off_rgb, _ = tiles.depth_ranks(pj.means2d, pj.radii_x, pj.depths,
                                                 cfg.raster.tile_w, cfg.raster.tile_h, tx, ty,
                                                 radii_y=pj.radii_y)
            mk_rgb = cfg.raster.instance_budget(geo[0].shape[0])
            mk_rgb = -(-mk_rgb // cfg.raster.chunk) * cfg.raster.chunk
            k6_rgb = k6_check(kernels, off_rgb, mk_rgb, "RGB aligned")
            k6_rgb["launches"] = launches["expand_gid"]
            del pj, off_rgb
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
        again = kernels.blend_backward_full(*a8)
        torch.cuda.synchronize()
        for part, other, what in zip(got, again, ("colour", "geometry")):
            if not torch.equal(part, other):  # one writer per row, a fixed order of addition
                fail(f"K8 {what}: two launches differ at {int((part != other).sum())} values")
        del again
        t0 = time.perf_counter()
        want_col, want_geo, walked, blended, near = kernels.blend_backward_full_plain(
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
        cmp8 = k8_columns(got, want_col, want_geo, "", [
            (f"tap {name}", tap.grad[:, j].double(), want_tap[:, j])
            for j, name in enumerate(("x", "y"))])
        # once more with a seeded, non-zero alpha cotangent, which the loss
        # does not give: walk B's g_alpha T_fin term
        g_alpha_r = torch.as_tensor(np.random.default_rng(8).standard_normal(
            tuple(g_alpha.shape), dtype=np.float32), device=dev)
        a8r = a8[:6] + (g_alpha_r,) + a8[7:]
        got_r = kernels.blend_backward_full(*a8r)
        want_r = kernels.blend_backward_full_plain(*a8r)
        cmp8.update(k8_columns(got_r, *want_r, "g_alpha ~ N(0, 1): "))
        del got_r, want_r, g_alpha_r
        nbytes = (geom_p.numel() + cols_p.numel() + b.inst_gid.numel() + 2 * b.tile_starts.numel()
                  + g_img.numel() + g_alpha.numel() + got[0].numel() + got[1].numel()) * 4
        # two walks; per blended pair: walk A 5 + 2C, walk B ~40 + 4C (u,
        # the prefix, the chain rule, C + 6 products and their sums)
        ops = blend_ops(near, blended, 45 + 6 * 3, walks=2)
        k8 = dict(
            name="blend_backward_full", id="K8", route="cuda",
            source="gags_torch/splat/csrc/blend_backward_full.cu",
            replaces="gags_tpu/splat/pallas_kernel.py:1253",
            launches=launches["blend_backward_full"],
            launches_per_step=launches["blend_backward_full"] / RGB_STEPS,
            check="ok", max_abs_err=max(c["max_abs_err"] for k, c in cmp8.items()
                                         if not k.startswith("tap")),
            ms=device_ms(lambda: kernels.blend_backward_full(*a8)),
            events_ms=cuda_ms(lambda: kernels.blend_backward_full(*a8), 10), plain_ms=plain_ms,
            bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3, ops_ms=ops / FP32_OPS_PER_S * 1e3,
            library_ms=None, pairs_walked=walked, pairs_blended=blended, pairs_near=near,
            instances=int(b.num_valid), slots=b.inst_gid.numel(), budget_factor=factor,
            check_resolution=f"{w}x{h}", by_output=cmp8, bit_identical=True,
            instances_per_tile=tile_stats(b.tile_counts),
            timing=DEVICE_TIMING, rgb_steps=steps,
            rgb_launches={k: v for k, v in launches.items() if v})
        with_bound(k8)
        print(f"# K8 blend_backward_full: ms {k8['ms']:.4f}, plain {plain_ms:.1f} ms, bound "
              f"{k8['bound_ms']:.4f} ms ({k8['bound_by']}), {walked} pairs walked, {near} near, "
              f"{blended} blended, {k8['instances']} instances ({gpu})", flush=True)
        # K1 at the RGB width, on the binning and colours K8 took
        bg = torch.zeros(3, device=dev)
        a1 = (geom_p, cols_p, b.inst_gid, b.tile_starts, b.tile_counts, bg, tx, ty, th, tw)
        out_k = kernels.blend_forward_aligned(*a1)
        if not torch.equal(out_k, kernels.blend_forward_aligned(*a1)):  # one writer per pixel
            fail("K1 RGB C=3: two launches differ")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_p, walked1, blended1, near1 = kernels.blend_forward_plain(*a1, return_pairs=True)
        torch.cuda.synchronize()
        k1_plain = (time.perf_counter() - t0) * 1e3
        cmp1 = flip_tolerant_compare(out_k, out_p, "K1 blend_forward_aligned RGB C=3")
        nbytes = (geom_p.numel() + cols_p.numel() + b.inst_gid.numel()
                  + 2 * b.tile_starts.numel() + bg.numel() + out_k.numel()) * 4
        k1_fn = lambda: kernels.blend_forward_aligned(*a1)  # noqa: E731
        k1_rgb = with_bound(dict(
            channels=3, launches=launches["blend_forward_aligned"],
            launches_per_step=launches["blend_forward_aligned"] / RGB_STEPS,
            ms=device_ms(k1_fn), events_ms=cuda_ms(k1_fn, 20), plain_ms=k1_plain,
            bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            ops_ms=blend_ops(near1, blended1, 4 + 2 * 3) / FP32_OPS_PER_S * 1e3,
            library_ms=None, pairs_walked=walked1, pairs_blended=blended1, pairs_near=near1,
            bit_identical=True,
            instances_per_tile=tile_stats(b.tile_counts), **cmp1))
        print(f"# K1 blend_forward_aligned RGB C=3: {k1_rgb} ({gpu})", flush=True)
        del out_k, out_p
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
        del scene, seed, state, batches, imgs
        torch.cuda.empty_cache()
        after_report = after(root, model)
    return k8, k3_rgb, k1_rgb, k6_rgb, after_report

# the GAS phase (stage 2, scripts/GAS.sh) on the RGB phase's scene and model
GAS_GAD_STEPS = 10
GAS_PROMPT_BATCH = 256      # the CLI's --points_per_batch
GAS_MANY_PROMPTS = 32       # build_point_grid(32): 1024 prompts, four batches of 256
GAS_CPU_PROMPTS = 16        # prompts of the card-vs-CPU decoder check
# max relative error of the card's f32 SAM vs the CPU's: above the true-f32
# reading (2.7e-6 on an H100) and below what TF32 matmuls give, which the
# phase measures as its control
GAS_REL_LIMIT = 2e-5
GAS_LOWERED = dict(pred_iou_thresh=-10.0, stability_score_thresh=-1.0, min_mask_region_area=4)
GAS_FILTER_LOWERED = dict(iou_thr=0.95, score_thr=-10.0, inner_thr=0.9)
GAS_LABELS = ("hello world", "a photo")


def write_bpe(path: str) -> str:
    """A small CLIP merge table (the real bpe_simple_vocab_16e6.txt.gz is
    the user's): "hello", "world" and "photo" merge fully."""
    merges = ["#version: 0.2", "h e", "he l", "hel l", "hell o</w>", "w o", "wo r", "wor l",
              "worl d</w>", "p h", "ph o", "pho t", "phot o</w>"]
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(merges) + "\n")
    return path


def random_checkpoint(model: torch.nn.Module, path: str, seed: int, dev) -> dict:
    """Seeded random weights for every key of `model`'s state dict (built on
    the meta device), written to `path` as a plain float32 state dict in the
    upstream layout: norms 1, biases and positions N(0, 0.02), embeddings
    and tokens N(0, 1), weight matrices N(0, 1 / fan_in), so activations
    stay O(1) through the full depth. Returns the CPU state dict."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    sd = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        leaf = k.rsplit(".", 1)[-1]
        norm = any(t in k for t in ("norm", "ln_", "neck.1", "neck.3", "upscaling.1",
                                    "downscaling.1", "downscaling.4"))
        if norm:
            t = (torch.ones(shape, device=dev) if leaf == "weight"
                 else torch.zeros(shape, device=dev))
        elif any(t in k for t in ("point_embeddings", "not_a_point", "no_mask", "iou_token",
                                  "mask_tokens", "gaussian_matrix", "class_embedding",
                                  "token_embedding")):
            t = torch.randn(shape, generator=gen, device=dev)
        elif len(shape) >= 2 and "pos" not in k and "rel_pos" not in k:
            fan_in = shape[0] if "upscaling" in k else int(np.prod(shape[1:]))
            if k in ("visual.proj", "text_projection"):
                fan_in = shape[0]
            t = torch.randn(shape, generator=gen, device=dev) / fan_in ** 0.5
        else:
            t = 0.02 * torch.randn(shape, generator=gen, device=dev)
        sd[k] = t.cpu()
    torch.save(sd, path)
    return sd


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.cpu() - want).abs().max() / want.abs().max())


# phase 14(f): the metrics CLI on stage A's renders (PSNR / SSIM rtol 1e-6 /
# atol 1e-6 as tests/test_torch_metrics.py; LPIPS rtol 1e-6 as
# tests/test_torch_lpips.py against the torch reference forward, no atol,
# so the check is relative at any LPIPS; a TF32 control must fail it)
METRIC_TOL = {"PSNR": (1e-6, 0.0), "SSIM": (0.0, 1e-6), "LPIPS": (1e-6, 0.0)}


def random_vgg_files(root: str, seed: int = 0) -> tuple:
    """Seeded random VGG16 `features` (He-normal weights, so activations
    stay O(1) through the 13 convolutions, as trained ones do) and LPIPS
    linear heads drawn from U(0, 1), the scale of the trained heads (LPIPS
    of distinct images is then O(0.1)), in torchvision's key layout."""
    from gags_torch.utils.lpips import LPIPS_CHANNELS, _vgg_features

    gen = torch.Generator().manual_seed(seed)
    feat = {}
    for k, v in _vgg_features().state_dict().items():
        if k.endswith("weight"):
            std = math.sqrt(2.0 / (v.shape[1] * v.shape[2] * v.shape[3]))
            feat[f"features.{k}"] = torch.randn(v.shape, generator=gen) * std
        else:
            feat[f"features.{k}"] = torch.randn(v.shape, generator=gen) * 0.01
    lin = {f"lin{i}.model.1.weight": torch.rand((1, c, 1, 1), generator=gen)
           for i, c in enumerate(LPIPS_CHANNELS["vgg"])}
    paths = (os.path.join(root, "vgg16_features.pth"), os.path.join(root, "lpips_vgg_lin.pth"))
    torch.save(feat, paths[0])
    torch.save(lin, paths[1])
    return paths


def metrics_phase(root: str, model: str, it: int, names, gpu: str) -> dict:
    """gags_torch.cli.metrics on the card over <model>/train/ours_<it>: the
    renders against the scene's ground-truth PNGs (copied as gt/), LPIPS
    from random VGG16 files, with cuDNN's TF32 switched on before the call
    (the CLI must turn it off); each view held to the same functions on CPU
    tensors."""
    import shutil

    from gags_torch.cli import metrics as metrics_cli
    from gags_torch.utils.image import read_rgb
    from gags_torch.utils.lpips import lpips_from_checkpoints
    from gags_torch.utils.metrics import psnr, ssim

    method = os.path.join(model, "train", f"ours_{it}")
    os.makedirs(os.path.join(method, "gt"), exist_ok=True)
    for n in names:
        shutil.copy(os.path.join(root, "images", n + ".png"),
                    os.path.join(method, "gt", n + ".png"))
    vgg, lin = random_vgg_files(os.path.dirname(model))
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = metrics_cli.run([model], split="train", vgg_ckpt=vgg, lpips_lin_ckpt=lin,
                              device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if torch.backends.cudnn.allow_tf32 is not True:
            fail("the metrics CLI did not restore cuDNN's TF32 setting")
    finally:
        torch.backends.cudnn.allow_tf32 = False
    results, per_view = out[model]
    pv = per_view[f"ours_{it}"]
    if sorted(pv["PSNR"]) != sorted(n + ".png" for n in names):
        fail(f"metrics: views {sorted(pv['PSNR'])}")
    cpu_lpips = lpips_from_checkpoints(vgg, lin, device="cpu")
    worst = {k: 0.0 for k in METRIC_TOL}
    t0 = time.perf_counter()
    with torch.no_grad():
        for n in names:
            r = read_rgb(os.path.join(method, "renders", n + ".png"), "cpu").to(torch.float32) / 255.0
            g = read_rgb(os.path.join(method, "gt", n + ".png"), "cpu").to(torch.float32) / 255.0
            want = {"PSNR": float(psnr(r, g)), "SSIM": float(ssim(r, g)),
                    "LPIPS": float(cpu_lpips(r, g))}
            for k, (rtol, atol) in METRIC_TOL.items():
                got = pv[k][n + ".png"]
                worst[k] = max(worst[k], abs(got - want[k]) / max(abs(want[k]), 1e-30))
                if not np.isfinite(got) or abs(got - want[k]) > atol + rtol * abs(want[k]):
                    fail(f"metrics {k} of {n}: card {got} vs CPU {want[k]} "
                         f"(rtol {rtol}, atol {atol})")
    cpu_s = time.perf_counter() - t0
    lpips_min = min(pv["LPIPS"].values())
    if lpips_min < 1e-3:  # near 0, a relative check holds the card to nothing
        fail(f"metrics: LPIPS {lpips_min}: the random heads are too weak to test LPIPS")
    tf32_err = lpips_tf32_control(vgg, lin, method, names[0], cpu_lpips)
    # where an image's time goes: the host's two PNG decodes, then LPIPS on the card
    t0 = time.perf_counter()
    pair = [read_rgb(os.path.join(method, sub, names[0] + ".png"), "cpu") for sub in ("renders", "gt")]
    decode_ms = (time.perf_counter() - t0) * 1e3
    card_lpips = lpips_from_checkpoints(vgg, lin, device="cuda")
    ra, ga = (x.to("cuda", torch.float32) / 255.0 for x in pair)
    with torch.no_grad():
        lpips_ms = cuda_ms(lambda: card_lpips(ra, ga), 3)
    r = dict(views=len(names), seconds=secs, seconds_per_image=secs / len(names),
             cpu_seconds_per_image=cpu_s / len(names), png_decode_ms=decode_ms,
             lpips_card_ms=lpips_ms, results=results[f"ours_{it}"], max_rel_err_vs_cpu=worst,
             lpips_tf32_rel_err=tf32_err)
    print(f"# 14f metrics CLI over {len(names)} views at 1280x720 (PSNR, SSIM, LPIPS VGG16): "
          f"{r['seconds_per_image']:.4f} s an image on the card (two PNG decodes {decode_ms:.1f} ms"
          f" on the host, LPIPS {lpips_ms:.2f} ms on the card; CPU "
          f"{r['cpu_seconds_per_image']:.2f} s), means {r['results']}, max relative error vs the CPU {worst}, "
          f"LPIPS with TF32 convolutions {tf32_err:.3e} off ({gpu})", flush=True)
    return r


def lpips_tf32_control(vgg: str, lin: str, method: str, name: str, cpu_lpips) -> float:
    """The LPIPS check's control: one view's LPIPS on the card with the
    TF32-off switch taken out and cuDNN's TF32 on must miss the CPU's by
    more than the check allows, or the check could not see a missing
    switch. Returns that relative error."""
    import contextlib

    from gags_torch.utils import lpips as lpips_mod
    from gags_torch.utils.image import read_rgb

    a, b = (read_rgb(os.path.join(method, sub, name + ".png"), "cpu").to(torch.float32) / 255.0
            for sub in ("renders", "gt"))
    with torch.no_grad():
        want = float(cpu_lpips(a, b))
        model = lpips_mod.lpips_from_checkpoints(vgg, lin, device="cuda")
        switch, prev = lpips_mod._no_tf32, torch.backends.cudnn.allow_tf32
        lpips_mod._no_tf32, torch.backends.cudnn.allow_tf32 = contextlib.nullcontext, True
        try:
            got = float(model(a.cuda(), b.cuda()))
        finally:
            lpips_mod._no_tf32, torch.backends.cudnn.allow_tf32 = switch, prev
    err = abs(got - want) / abs(want)
    if not err > METRIC_TOL["LPIPS"][0]:
        fail(f"metrics: LPIPS with TF32 convolutions is {err:.3e} off the CPU, within the "
             f"check's rtol {METRIC_TOL['LPIPS'][0]}: the check cannot see TF32")
    return err


def gas_phase(root: str, model: str, dev: torch.device, gpu: str) -> dict:
    """Phase 14: GAS (scripts/GAS.sh) on the RGB phase's scene and model,
    then GAD on its output and text embeddings for the server. Returns the
    report: stage-A launches, stage times, mask counts."""
    import dataclasses

    from gags_torch.cli import depth_sample, encode_text, gas, render as render_cli
    from gags_torch.cli.serve import load_server, make_handler
    from gags_torch.cli.train_gad import RunConfig, run as train_gad
    from gags_torch.gad.train import GadConfig
    from gags_torch.gas.depth_sampler import (min_depth_over_cameras, project_points,
                                              splat_depth_samples)
    from gags_torch.gas.generator import AutomaticMaskGenerator, GeneratorConfig
    from gags_torch.gas.prompts import build_all_layer_mindepth_point_grids, build_point_grid
    from gags_torch.models.clip import CLIP, CLIPConfig, load_openclip_checkpoint
    from gags_torch.models.sam import SAM, SAMConfig, preprocess_sam_image, resize_geometry
    from gags_torch.models.sam_weights import load_sam_checkpoint, load_sam_state_dict
    from gags_torch.scene.dataset import camera_from_info, detect_and_load
    from gags_torch.scene.gaussian_data import GaussianScene
    from gags_torch.splat import kernels

    report: dict = {}
    it = RGB_STEPS
    info = detect_and_load(root, foundation_model="none")
    names = [os.path.splitext(ci.name)[0] for ci in info.train_cameras]

    # -- 14a. stage A: RGB + expected depth through the render CLI ----------
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    r = render_cli.run(model, root, it, render_mode="RGB+ED", skip_test=True, device=dev)
    torch.cuda.synchronize()
    stage_a = {k: v for k, v in kernels.launch_counts.items() if v}
    print(f"# GAS stage A render: {r['train']['frames']} frames, "
          f"{r['train']['frames_per_s']:.2f} frames/s, launches {stage_a} ({gpu})", flush=True)
    for name in ("blend_forward", "expand_gid"):
        if stage_a.get(name, 0) < len(names):
            fail(f"GAS stage A: {name} launched {stage_a.get(name, 0)} times for {len(names)} frames")
    report["stage_a_launches"] = stage_a

    # -- 14f. image-quality metrics of stage A's renders ------------------------
    report["metrics"] = metrics_phase(root, model, it, names, gpu)

    # -- 14b. depth samples, the card's maps against the CPU's bit for bit --
    t0 = time.perf_counter()
    ds = depth_sample.run(root, model, it, device=dev)
    report["depth_sample_s"] = time.perf_counter() - t0
    ply = os.path.join(model, "point_cloud", f"iteration_{it}", "point_cloud.ply")
    pts = GaussianScene.from_ply(ply).means
    cams = [camera_from_info(ci, -1) for ci in info.train_cameras]
    dmaps = torch.as_tensor(np.stack([np.load(os.path.join(
        model, "train", f"ours_{it}", "depth", n + "_depth.npy")) for n in names]))
    vms, Ks = torch.stack([c.viewmat for c in cams]), torch.stack([c.K for c in cams])
    mind, vis, uv = min_depth_over_cameras(pts, vms, Ks, dmaps)
    uv_moved = 0
    for i, (n, c) in enumerate(zip(names, cams)):
        want = splat_depth_samples(mind, vis[:, i], uv[:, i], c.height, c.width).numpy()
        got = np.load(os.path.join(root, "depths_sample", n + "_depth_sample.npy"))
        if not np.array_equal(got, want):
            fail(f"depth samples of {n}: the card's map differs from the CPU's at "
                 f"{int((got != want).sum())} pixels")
        u_c, v_c, _, _ = project_points(pts.to(dev), vms[i].to(dev), Ks[i].to(dev),
                                        dmaps[i].to(dev), c.width, c.height)
        u, v, _, _ = project_points(pts, vms[i], Ks[i], dmaps[i], c.width, c.height)
        uv_moved += int(((u_c.cpu() != u) | (v_c.cpu() != v)).sum())
    print(f"# GAS depth samples: {ds['maps']} maps bit-identical to the CPU's, "
          f"{sum(ds['visible'])} visible (point, camera) pairs, {uv_moved} projected (u, v) "
          f"differ between card and CPU over {pts.shape[0]} points x {len(cams)} cameras, "
          f"{report['depth_sample_s']:.2f} s ({gpu})", flush=True)
    report["uv_differ"] = uv_moved

    # -- 14c. GAS with ViT-H SAM and ViT-B/16 CLIP --------------------------
    t0 = time.perf_counter()
    sam_path, clip_path = os.path.join(root, "sam_vit_h.pth"), os.path.join(root, "clip_b16.pt")
    sam_sd = random_checkpoint(SAM(SAMConfig.vit_h(), device="meta"), sam_path, 1, dev)
    random_checkpoint(CLIP(CLIPConfig.vit_b_16(), device="meta"), clip_path, 2, dev)
    print(f"# GAS checkpoints: random ViT-H SAM {os.path.getsize(sam_path) / 2**30:.2f} GiB, "
          f"ViT-B/16 CLIP {os.path.getsize(clip_path) / 2**30:.2f} GiB, written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    runs = {}
    for label, kw in (("f32", {}), ("bf16 batch 4", dict(bf16=True, encoder_batch=4)),
                      ("f32 lowered", dict(gen_cfg=GeneratorConfig(**GAS_LOWERED),
                                           filter_thresholds=GAS_FILTER_LOWERED))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = gas.run(root, model, it, sam_ckpt=sam_path, clip_ckpt=clip_path, device=dev, **kw)
        rep["wall_s"] = time.perf_counter() - t0
        rep["s_per_image"] = rep["seconds"] / len(rep["images"])
        kept = [sum(v.values()) for v in rep["images"].values()]
        print(f"# GAS {label}: {rep['written']} of {len(names)} images written, masks kept per "
              f"image {kept}, {rep['s_per_image']:.2f} s per image (encode {rep['encode_s']:.2f} s, "
              f"generate {rep['generate_s']:.2f} s, clip {rep['clip_s']:.2f} s in all; "
              f"{rep['wall_s']:.1f} s with loading) ({gpu})", flush=True)
        runs[label] = {k: rep[k] for k in ("written", "seconds", "s_per_image", "encode_s",
                                            "generate_s", "clip_s", "wall_s")}
        runs[label]["masks_per_image"] = kept
    report["runs"] = runs
    if runs["f32 lowered"]["written"] != len(names):
        fail(f"GAS with lowered thresholds wrote {runs['f32 lowered']['written']} of "
             f"{len(names)} images")
    for n in names:
        f = np.load(os.path.join(root, "language_features", n + "_f.npy"))
        s = np.load(os.path.join(root, "language_features", n + "_s.npy"))
        if (f.dtype != np.float16 or f.shape[1] != CLIPConfig.vit_b_16().embed_dim
                or s.shape != (4, cams[0].height, cams[0].width)
                or not np.isfinite(f).all() or f.shape[0] != int(s.max()) + 1):
            fail(f"language features of {n}: f {f.shape} {f.dtype}, s {s.shape} max {s.max()}")

    # stage times on one image, beside the card's name and power limit
    image = gas.load_image_1080p(info.train_cameras[0].image_path, dev)
    sam, _ = load_sam_checkpoint(sam_path, SAMConfig.vit_h(), device=dev)
    size = SAMConfig.vit_h().image_size
    pre_ms = cuda_ms(lambda: preprocess_sam_image(image, size, dev), 3, warmup=1)
    x1 = preprocess_sam_image(image, size, dev)[0]
    with torch.no_grad():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        emb = sam.encode_image(x1)
        torch.cuda.synchronize()
        enc_peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        enc_ms = cuda_ms(lambda: sam.encode_image(x1), 3, warmup=1)
        enc_prof = profile_request(lambda: sam.encode_image(x1),
                                   "SAM ViT-H encoder, one image, f32", top=12)
    depth = np.load(os.path.join(model, "train", f"ours_{it}", "depth", names[0] + "_depth.npy"))
    sample = np.load(os.path.join(root, "depths_sample", names[0] + "_depth_sample.npy"))
    # the CLI's grid (8 per side: 64 prompts, one partly filled batch), a
    # full batch of 256 prompts, and 1024 prompts: four batches, so the
    # decode of batch k+1 is queued before batch k is consumed
    grids = {"CLI grid": build_all_layer_mindepth_point_grids(8, 0, 1, 4, depth, sample,
                                                              np.random.default_rng(0))[0],
             "full batch": build_point_grid(16),
             "1024 prompts": build_point_grid(GAS_MANY_PROMPTS)}
    nh, nw = resize_geometry(*image.shape[:2], size)

    def prompts(grid):
        pts = torch.as_tensor(grid[:, None] * np.array([[nw, nh]]) / size,
                              dtype=torch.float32, device=dev)
        return pts, torch.ones(pts.shape[:2], dtype=torch.long, device=dev)

    dec_ms = {}
    with torch.no_grad():
        for key in ("CLI grid", "full batch"):
            pts_b, lbl_b = prompts(grids[key])
            dec_ms[f"{len(grids[key])} prompts"] = cuda_ms(
                lambda: sam.decode(emb, pts_b, lbl_b), 5)  # noqa: B023
    gens = {}
    for key, thr in (("CLI grid", "CLI"), ("1024 prompts", "CLI"), ("CLI grid", "lowered")):
        gen = AutomaticMaskGenerator(sam, GeneratorConfig(**(GAS_LOWERED if thr == "lowered"
                                                            else {})))
        grid, got = grids[key], {}

        def generate():
            got["levels"] = gen.generate(image, grid, embed=emb)  # noqa: B023

        label = f"{len(grid)} prompts, {thr} thresholds"
        prof = profile_request(generate, f"generate ({label}, batches of "
                                         f"{gen.cfg.points_per_batch})", top=8)
        gens[label] = dict(prof, batches=-(-len(grid) // gen.cfg.points_per_batch),
                           records=[len(v) for v in got["levels"]])
    from gags_torch.cli.gas import round_weights_bf16

    round_weights_bf16(sam)
    x4 = torch.cat([preprocess_sam_image(gas.load_image_1080p(ci.image_path, dev), size, dev)[0]
                    for ci in info.train_cameras[:4]])
    with torch.no_grad():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        sam.encode_image(x4)
        torch.cuda.synchronize()
        enc4_peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        enc4_ms = cuda_ms(lambda: sam.encode_image(x4), 3, warmup=1) / 4
    del sam, gen, emb, x1, x4
    clip, _ = load_openclip_checkpoint(clip_path, device=dev)
    side = CLIPConfig.vit_b_16().image_size
    crops = torch.rand((GAS_PROMPT_BATCH, 3, side, side), device=dev)
    with torch.no_grad():
        clip_ms = cuda_ms(lambda: clip.encode_image(crops), 5)
        clip_prof = profile_request(lambda: clip.encode_image(crops),
                                    f"CLIP ViT-B/16, {GAS_PROMPT_BATCH} crops", top=8)
    del clip, crops
    report["times"] = dict(
        preprocess_ms_per_image=pre_ms, encoder_ms_per_image_f32=enc_ms,
        encoder_peak_mib_f32=enc_peak,
        encoder_busy_ms_f32=enc_prof["busy_ms"], clip_busy_ms=clip_prof["busy_ms"],
        encoder_ms_per_image_bf16_batch4=enc4_ms, encoder_peak_mib_bf16_batch4=enc4_peak,
        decoder_ms_per_batch=dec_ms, generate=gens,
        clip_ms_per_batch_of_256_crops=clip_ms,
        gas_s_per_image={k: v["s_per_image"] for k, v in runs.items()})
    print(f"# GAS times: {report['times']} ({gpu})", flush=True)
    print(f"# GAS s per image at the CLI's thresholds covers the SAM encoder and one "
          f"{len(grids['CLI grid'])}-prompt decode with its upscale: no mask survives "
          f"filter_masks there, so box NMS, cleanup, crops and CLIP run only in the lowered "
          f"run", flush=True)

    # the card's f32 SAM against the CPU's: ViT-H widths cut to a windowed
    # and a global block, one 1024 image, one prompt batch; the card with
    # TF32 matmuls is the control the limit must catch
    cut = dataclasses.replace(SAMConfig.vit_h(), encoder_depth=2, global_attn_idx=(1,))
    g = SAMConfig.vit_h().global_attn_idx[0]
    sd2 = {k: v for k, v in sam_sd.items() if not k.startswith("image_encoder.blocks.")}
    for dst, src in ((0, 0), (1, g)):
        pre = f"image_encoder.blocks.{src}."
        sd2.update({f"image_encoder.blocks.{dst}." + k[len(pre):]: v
                    for k, v in sam_sd.items() if k.startswith(pre)})
    del sam_sd
    x = preprocess_sam_image(image, cut.image_size, "cpu")[0]
    pts_b, lbl_b = prompts(grids["CLI grid"][:GAS_CPU_PROMPTS])
    outs = {}
    with torch.no_grad():
        for key, d, tf32 in (("card", dev, False), ("card TF32", dev, True),
                             ("cpu", torch.device("cpu"), False)):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.backends.cudnn.allow_tf32 = tf32
            try:
                m = load_sam_state_dict(sd2, cut, device=d)
                e = m.encode_image(x.to(d))
                lo, io = m.decode(e, pts_b.to(d), lbl_b.to(d))
                outs[key] = (e.cpu(), lo.cpu(), io.cpu())
                del m
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.backends.cudnn.allow_tf32 = False
    errs = {key: {name: rel_err(a, b) for name, a, b in zip(
        ("embedding", "mask logits", "iou"), outs[key], outs["cpu"])}
        for key in ("card", "card TF32")}
    print(f"# GAS SAM card vs CPU (ViT-H widths, 2 blocks: windowed + global, one 1024 image, "
          f"{GAS_CPU_PROMPTS} prompts): max relative error, true f32 {errs['card']}, TF32 "
          f"control {errs['card TF32']}, limit {GAS_REL_LIMIT} ({gpu})", flush=True)
    if max(errs["card"].values()) > GAS_REL_LIMIT:
        fail(f"the card's SAM disagrees with the CPU's: {errs['card']}")
    if not max(errs["card TF32"].values()) > GAS_REL_LIMIT:
        fail(f"the card-vs-CPU limit {GAS_REL_LIMIT} does not catch TF32: {errs['card TF32']}")
    report["card_vs_cpu_rel_err"] = errs

    # -- 14d. GAD on the GAS output -------------------------------------------
    gad_dir = os.path.join(root, "gad")
    losses = []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    train_gad(RunConfig(source_path=root, model_path=gad_dir, ply_path=ply, resolution=2,
                        iterations=GAS_GAD_STEPS, save_iterations=str(GAS_GAD_STEPS),
                        test_iterations="", device=str(dev)),
              GadConfig(clip_dim=CLIPConfig.vit_b_16().embed_dim),
              on_step=lambda i, st, m: m is not None and losses.append(float(m["loss"])))
    torch.cuda.synchronize()
    gad_launches = {k: v for k, v in kernels.launch_counts.items() if v}
    if len(losses) != GAS_GAD_STEPS or not np.all(np.isfinite(losses)):
        fail(f"GAD on the GAS output: losses {losses}")
    print(f"# GAD on the GAS output: {GAS_GAD_STEPS} steps in {time.perf_counter() - t0:.1f} s, "
          f"loss {losses[0]:.5f} -> {losses[-1]:.5f}, launches {gad_launches} ({gpu})", flush=True)
    report["gad_launches"] = gad_launches

    # -- 14e. text embeddings into the server: one /relevancy reply --------
    bpe = write_bpe(os.path.join(root, "bpe.txt.gz"))
    npz = os.path.join(root, "embeds.npz")
    emb_t = encode_text.run(clip_path, list(GAS_LABELS), npz, bpe=bpe, device=dev)
    if emb_t["pos"].shape != (2, CLIPConfig.vit_b_16().embed_dim) or not np.allclose(np.linalg.norm(emb_t["neg"], axis=1), 1,
                                                         atol=1e-5):
        fail(f"encode_text: pos {emb_t['pos'].shape}")
    server = load_server(gad_dir, GAS_GAD_STEPS, text_embeds=npz, device=dev)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    c0 = cams[0]
    body = dict(viewmat=c0.viewmat.reshape(-1).tolist(), K=c0.K.reshape(-1).tolist(),
                width=c0.width, height=c0.height, label=GAS_LABELS[0])
    try:
        rq = urllib.request.Request(f"http://127.0.0.1:{httpd.server_address[1]}/relevancy",
                                    data=json.dumps(body).encode(), method="POST",
                                    headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(rq, timeout=300) as resp:
            status, payload = resp.status, json.loads(resp.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    if status != 200 or not 0 <= payload["relevancy_max"] <= 1:
        fail(f"/relevancy with encode_text's embeddings: {status} {payload.get('relevancy_max')}")
    print(f"# encode_text → /relevancy on the GAD model: status {status}, relevancy_max "
          f"{payload['relevancy_max']:.4f}, {payload['selected_px']} px selected", flush=True)
    return report


# phase 18 (after 14, in the RGB phase's temporary directory): the RGB
# scene's ground truths as JPEG files, read on the card through J1
JPEG_STEPS = 50
JPEG_GAS_CAMERAS = 2
JPEG_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                         "torch_jpeg")


def _read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _jpeg_scene(src: str, dst: str, names, encode) -> None:
    """A copy of the COLMAP scene at `src` holding only the images `names`
    (stems), each written as <stem>.jpg by `encode(stem)`, with its depth
    samples where `src` has them."""
    import shutil

    from gags_torch.scene import colmap as cm

    os.makedirs(os.path.join(dst, "sparse", "0"))
    os.makedirs(os.path.join(dst, "images"))
    for f in ("cameras.bin", "points3D.ply"):
        shutil.copy(os.path.join(src, "sparse", "0", f), os.path.join(dst, "sparse", "0", f))
    imgs = {}
    for k, im in cm.read_images_binary(os.path.join(src, "sparse", "0", "images.bin")).items():
        stem = os.path.splitext(im.name)[0]
        if stem in names:
            imgs[k] = im._replace(name=stem + ".jpg")
            with open(os.path.join(dst, "images", stem + ".jpg"), "wb") as f:
                f.write(encode(stem))
            sample = os.path.join(src, "depths_sample", stem + "_depth_sample.npy")
            if os.path.exists(sample):
                os.makedirs(os.path.join(dst, "depths_sample"), exist_ok=True)
                shutil.copy(sample, os.path.join(dst, "depths_sample"))
    cm.write_images_binary(os.path.join(dst, "sparse", "0", "images.bin"), imgs)


def jpeg_phase(root: str, model: str, dev: torch.device, gpu: str) -> dict:
    """Phase 18: (a) every committed JPEG fixture through J1 against PIL's
    stored pixels and the plain decode, bit-identical on a second launch;
    (b) the RGB scene's eight 1280x720 ground truths as JPEG (encode_jpeg),
    decoded on the card against the CPU's plain decode (host entropy, copy
    and kernel times), the first of them also at h1v2 and h4v1 sampling,
    then cli.train_rgb.run on that scene at -r 1 for
    JPEG_STEPS steps with the launch counts set to 0 just before and read
    just after (J1 once an image; K1, K6, K8 every step; the loss finite
    and falling); (c) the images at -r 2 through load_rgb's BICUBIC on the
    card against the CPU's; (d) cli.gas.run on JPEG_GAS_CAMERAS of the JPEG
    cameras with phase 14's random checkpoints and lowered thresholds,
    every camera written; (e) convert's LANCZOS pyramid of the JPEGs on the
    card, byte for byte the CPU's. Returns J1's kernels-line entry."""
    import shutil

    from gags_torch.cli import convert, gas
    from gags_torch.cli.train_rgb import RunConfig, run
    from gags_torch.gas.generator import GeneratorConfig
    from gags_torch.rgb.train import RgbConfig
    from gags_torch.scene.dataset import camera_from_info, detect_and_load
    from gags_torch.splat import kernels
    from gags_torch.utils import jpeg
    from gags_torch.utils.image import load_rgb, read_png, read_rgb, resize_uint8

    t_phase = time.perf_counter()
    tmp = os.path.dirname(root)
    # -- (a) the fixtures -----------------------------------------------------
    with np.load(os.path.join(JPEG_DATA, "pixels.npz")) as d:
        stored = {k: d[k] for k in d.files}
    fixtures = sorted(f for f in os.listdir(JPEG_DATA) if f.endswith(".jpg"))
    fx = []
    for n in fixtures:
        p = os.path.join(JPEG_DATA, n)
        jf = jpeg.parse_jpeg(_read_bytes(p), n)
        fx.append((torch.from_numpy(jpeg.entropy_decode_host(jf)).to(dev), jf.layout()))
        got, again = read_rgb(p, dev), read_rgb(p, dev)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail(f"J1 jpeg_decode: two launches differ on {n}")
        if not np.array_equal(got.cpu().numpy(), stored[n]):
            fail(f"J1 jpeg_decode: {n} differs from PIL's stored pixels")
        if not torch.equal(got.cpu(), read_rgb(p, "cpu")):
            fail(f"J1 jpeg_decode: {n} differs from the plain decode")
    fixture_ms = device_ms(lambda: [jpeg.jpeg_pixels(c, lay) for c, lay in fx]) / len(fx)
    print(f"# J1 jpeg_decode: {len(fixtures)} fixtures equal to PIL's pixels and the plain "
          f"decode, bit-identical on a second launch; {fixture_ms:.5f} ms device time a "
          f"fixture ({gpu})", flush=True)
    del fx

    # -- (b) the JPEG scene, decoded on the card and on the CPU -----------------
    info = detect_and_load(root, foundation_model="none")
    stems = [os.path.splitext(ci.name)[0] for ci in info.train_cameras]
    jroot = os.path.join(tmp, "scene_jpeg")
    _jpeg_scene(root, jroot, stems, lambda stem: jpeg.encode_jpeg(
        read_png(os.path.join(root, "images", stem + ".png"))))
    cpu_px, times = {}, {"parse_ms": [], "host_entropy_ms": [], "h2d_ms": [],
                         "cpu_plain_decode_s": []}
    coefs = {}
    for stem in stems:
        with open(os.path.join(jroot, "images", stem + ".jpg"), "rb") as f:
            data = f.read()
        t0 = time.perf_counter()
        jf = jpeg.parse_jpeg(data, stem)
        t1 = time.perf_counter()
        coef = jpeg.entropy_decode_host(jf)
        t2 = time.perf_counter()
        cd = torch.from_numpy(coef).to(dev)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        got = jpeg.jpeg_pixels(cd, jf.layout())
        t4 = time.perf_counter()
        cpu_px[stem] = jpeg.decode_jpeg(data, "cpu")
        times["cpu_plain_decode_s"].append(time.perf_counter() - t4)
        times["parse_ms"].append((t1 - t0) * 1e3)
        times["host_entropy_ms"].append((t2 - t1) * 1e3)
        times["h2d_ms"].append((t3 - t2) * 1e3)
        if got.shape != (HEIGHT, WIDTH, 3) or not torch.equal(got.cpu(), cpu_px[stem]):
            fail(f"J1 jpeg_decode: {stem}.jpg on the card differs from the CPU's plain decode")
        coefs[stem] = (cd, jf)
    # the first frame again at the two samplings Pillow cannot write
    px0 = read_png(os.path.join(root, "images", stems[0] + ".png"))
    for label, samp in (("h1v2", ((1, 2), (1, 1), (1, 1))), ("h4v1", ((4, 1), (1, 1), (1, 1)))):
        data = jpeg.encode_jpeg(px0, sampling=samp)
        if not torch.equal(jpeg.decode_jpeg(data, dev).cpu(), jpeg.decode_jpeg(data, "cpu")):
            fail(f"J1 jpeg_decode: {stems[0]} at {label} sampling differs card vs CPU")
    print(f"# J1 jpeg_decode: {len(stems)} {WIDTH}x{HEIGHT} 4:2:0 frames and {stems[0]} at "
          f"h1v2 and h4v1 sampling equal on the card to the CPU's plain decode", flush=True)
    cd0, jf0 = coefs[stems[0]]
    lay0 = jf0.layout()
    j1_fn = lambda: jpeg.jpeg_pixels(cd0, lay0)  # noqa: E731
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = jpeg.jpeg_pixels_plain(cd0, lay0)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    if not torch.equal(plain, j1_fn()):
        fail("J1 jpeg_decode differs from its plain version on the card")
    nbytes = cd0.numel() * 2 + HEIGHT * WIDTH * 3
    # integer operations: ~900 a block (dequantise, two 1-D passes of 8,
    # descale, range limit), ~40 a pixel (upsampling and colour)
    ops = jf0.blocks * 900 + HEIGHT * WIDTH * 40
    j1 = with_bound(dict(
        name="jpeg_decode", id="J1", route="cuda", source="gags_torch/utils/csrc/jpeg_decode.cu",
        replaces="none: no TPU kernel (the JAX package decodes with PIL on the host, "
                 "gags_tpu/cli/train_rgb.py:70)",
        check="exact", max_abs_err=0.0, ms=device_ms(j1_fn), events_ms=cuda_ms(j1_fn, 20),
        plain_ms=plain_ms, bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
        ops_ms=ops / FP32_OPS_PER_S * 1e3, library_ms=None,
        library="none: no PyTorch call decodes a JPEG (torchvision is absent)",
        timing="ms, fixture_ms: device time per call, both kernels (torch.profiler); "
               "events_ms: back-to-back calls between CUDA events; plain_ms and per_frame: "
               "host clock, the card synchronised",
        frame=f"{WIDTH}x{HEIGHT} 4:2:0 q75, {jf0.blocks} blocks",
        fixtures=len(fixtures), fixture_ms=fixture_ms,
        host_entropy_ms=float(np.median(times["host_entropy_ms"])),
        per_frame={k: float(np.median(v)) for k, v in times.items()}))
    print(f"# J1 jpeg_decode per {WIDTH}x{HEIGHT} frame (median of {len(stems)}): parse "
          f"{j1['per_frame']['parse_ms']:.3f} ms, host entropy "
          f"{j1['per_frame']['host_entropy_ms']:.3f} ms, H2D {j1['per_frame']['h2d_ms']:.3f} "
          f"ms, kernels {j1['ms']:.5f} ms device (events {j1['events_ms']:.5f}), bound "
          f"{j1['bound_ms']:.5f} ms ({j1['bound_by']}), plain on the card {plain_ms:.2f} ms, "
          f"CPU plain decode {j1['per_frame']['cpu_plain_decode_s']:.2f} s ({gpu})", flush=True)
    del coefs, plain

    # train through the entry point on the JPEG scene
    jmodel = os.path.join(tmp, "model_jpeg")
    cfg = RgbConfig(densify_from_iter=JPEG_STEPS, densify_until_iter=JPEG_STEPS)
    rc = RunConfig(source_path=jroot, model_path=jmodel, resolution=1, iterations=JPEG_STEPS,
                   save_iterations="", capacity_factor=4, sh_degree=3, device=str(dev))
    losses = []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    jpeg.reset_launch_counts()
    t0 = time.perf_counter()
    run(rc, cfg, on_step=lambda it, st, m: m is not None and losses.append(float(m["loss"])))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {**{k: v for k, v in kernels.launch_counts.items() if v}, **jpeg.launch_counts}
    print(f"# launches during RGB training on the JPEG scene: {launches}", flush=True)
    if launches["jpeg_decode"] < len(stems):
        fail(f"J1 jpeg_decode launched {launches['jpeg_decode']} times for {len(stems)} images")
    for name in ("blend_forward_aligned", "expand_gid", "blend_backward_full"):
        if launches.get(name, 0) < JPEG_STEPS:
            fail(f"{name} launched {launches.get(name, 0)} times in {JPEG_STEPS} RGB steps "
                 f"on the JPEG scene")
    losses = np.array(losses)
    if len(losses) != JPEG_STEPS or not np.all(np.isfinite(losses)):
        fail(f"RGB training on the JPEG scene: losses {losses}")
    first, last = losses[:10].mean(), losses[-10:].mean()
    if not last < first:
        fail(f"RGB loss on the JPEG scene did not fall: first 10 mean {first}, last 10 {last}")
    print(f"# RGB on the JPEG scene: {JPEG_STEPS} steps in {run_s:.1f} s (set-up included), "
          f"loss first-10 mean {first:.5f} -> last-10 mean {last:.5f} ({gpu})", flush=True)
    j1["launches"] = launches["jpeg_decode"]

    # -- (c) -r 2: BICUBIC on the card against the CPU's --------------------
    jinfo = detect_and_load(jroot, foundation_model="none")
    for ci in jinfo.train_cameras:
        cam = camera_from_info(ci, 2)
        got = load_rgb(ci.image_path, cam.width, cam.height, dev)
        want = resize_uint8(cpu_px[os.path.splitext(ci.name)[0]], (cam.height, cam.width),
                            "bicubic")
        if not torch.equal(got.cpu(), want):
            fail(f"load_rgb at -r 2 ({cam.width}x{cam.height}) of {ci.name}: card != CPU")
    print(f"# load_rgb at -r 2: {len(jinfo.train_cameras)} JPEG images resized with BICUBIC "
          f"on the card equal to the CPU's", flush=True)

    # -- (d) GAS on the JPEG cameras ------------------------------------------
    groot = os.path.join(tmp, "scene_jpeg_gas")
    _jpeg_scene(root, groot, stems[:JPEG_GAS_CAMERAS], lambda stem: _read_bytes(
        os.path.join(jroot, "images", stem + ".jpg")))
    jpeg.reset_launch_counts()
    t0 = time.perf_counter()
    rep = gas.run(groot, model, RGB_STEPS, sam_ckpt=os.path.join(root, "sam_vit_h.pth"),
                  clip_ckpt=os.path.join(root, "clip_b16.pt"), device=dev,
                  gen_cfg=GeneratorConfig(**GAS_LOWERED), filter_thresholds=GAS_FILTER_LOWERED)
    gas_s = time.perf_counter() - t0
    if rep["written"] != JPEG_GAS_CAMERAS:
        fail(f"GAS on the JPEG cameras wrote {rep['written']} of {JPEG_GAS_CAMERAS}")
    j1["gas_launches"] = jpeg.launch_counts["jpeg_decode"]
    print(f"# GAS on {JPEG_GAS_CAMERAS} JPEG cameras (lowered thresholds): every camera "
          f"written, masks kept {[sum(v.values()) for v in rep['images'].values()]}, "
          f"{gas_s:.1f} s with loading, J1 launches {j1['gas_launches']} ({gpu})", flush=True)

    # -- (e) convert's pyramid, card against CPU ------------------------------
    written = {}
    for where, d in ((dev, "convert_card"), (torch.device("cpu"), "convert_cpu")):
        work = os.path.join(tmp, d)
        shutil.copytree(os.path.join(jroot, "images"), os.path.join(work, "images"))
        jpeg.reset_launch_counts()
        t0 = time.perf_counter()
        convert._resize_pyramid(work, where)
        written[d] = (time.perf_counter() - t0, jpeg.launch_counts["jpeg_decode"], {
            (div, n): _read_bytes(os.path.join(work, f"images_{div}", n))
            for div in (2, 4, 8) for n in sorted(os.listdir(os.path.join(work, "images")))})
    card, cpu = written["convert_card"][2], written["convert_cpu"][2]
    if card != cpu:
        fail(f"convert's pyramid: {sum(card[k] != cpu[k] for k in cpu)} files differ card vs CPU")
    j1["convert_launches"] = written["convert_card"][1]
    print(f"# convert --resize: {len(card)} LANCZOS pyramid files of {len(stems)} JPEGs "
          f"byte for byte the CPU's, {written['convert_card'][0]:.1f} s on the card, "
          f"{written['convert_cpu'][0]:.1f} s on the CPU", flush=True)
    j1["phase_s"] = time.perf_counter() - t_phase
    print(f"# phase 18 (JPEG scenes) took {j1['phase_s']:.1f} s", flush=True)
    return j1


# phase 15: the two TPU probes' kernels (P1 vpu_chain, P2 slab_chain)
PROBE_OPS = 18  # operations an element and application in either chain, each mul, add, sub,
# min, neg, exp2, log1p, compare or select one, at the published float32 rate: the bound_ms
# column. The own-instruction bound (probe_issue_bound) counts the compiled instructions
# instead: it rates how well the compiled loop is scheduled, not the design.
ISSUE_LANES = 128  # thread-instructions a clock an SM: 4 schedulers, a warp instruction each
MUFU_LANES = 16  # MUFU (EX2, LG2, RCP) results a clock an SM
STEADY_REPS_FACTOR = 10  # P2 also at 10x its REPS, the launch amortised
_SASS_INST = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_SASS_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_SASS_BRA = re.compile(r"\bBRA\s+(?:`\()?(0x[0-9a-f]+|\.L_x_\d+)")


def _ulps(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest distance in units in the last place (float32 bit patterns)."""
    a, b = got.float().view(torch.int32).long(), want.float().view(torch.int32).long()
    return int((a - b).abs().max())


def sm_clock_mhz() -> tuple:
    """(current, maximum) SM clock of card 0 in MHz, as nvidia-smi reads them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    vals = out.stdout.strip().splitlines()[0].split(",")
    cur = float(vals[0])
    try:
        return cur, float(vals[1])
    except ValueError:  # no maximum reported: the current clock stands in
        return cur, cur


def _sass_functions(lib_path) -> dict:
    """{mangled name: [(address, opcode, text), ...]} from cuobjdump -sass,
    with each .L_x label's address."""
    from gags_torch import _kernels

    exe = os.path.join(os.path.dirname(_kernels.nvcc_path()), "cuobjdump")
    text = subprocess.run([exe, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    funcs, name, labels, pending = {}, None, {}, []
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            funcs[name], labels[name], pending = [], {}, []
            continue
        if name is None:
            continue
        m = _SASS_LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _SASS_INST.search(line)
        if m:
            addr, body = int(m.group(1), 16), m.group(2).strip()
            for lab in pending:
                labels[name][lab] = addr
            pending = []
            toks = body.split()
            pred = toks[0].startswith("@")
            op = toks[1] if pred else toks[0]
            funcs[name].append((addr, op, body, pred))
    out = {}
    for name, insts in funcs.items():
        resolved = []
        for addr, op, body, pred in insts:
            tgt = None
            b = _SASS_BRA.search(body) if op.startswith("BRA") else None
            if b:
                t = b.group(1)
                tgt = int(t, 16) if t.startswith("0x") else labels[name].get(t)
            always = not pred or body.startswith("@PT ")
            resolved.append((addr, op, tgt, always))
        out[name] = resolved
    return out


def _rep_loop(insts: list) -> dict:
    """The innermost loop holding MUFU instructions with the most of them
    (the rep loop): its instructions and MUFUs on the shortest and on the
    longest path from its head to its back branch (forward branches inside
    it are taken or not)."""
    loops = [(tgt, addr) for addr, op, tgt, _ in insts
             if op.startswith("BRA") and tgt is not None and tgt <= addr]

    def mufus(lo, hi):
        return sum(1 for a, op, _, _ in insts if lo <= a <= hi and op.startswith("MUFU"))

    inner = [(lo, hi) for lo, hi in loops if mufus(lo, hi)
             and not any((lo, hi) != (l2, h2) and lo <= l2 and h2 <= hi and mufus(l2, h2)
                         for l2, h2 in loops)]
    lo, hi = max(inner, key=lambda r: (mufus(*r), r[1] - r[0]))
    body = [i for i in insts if lo <= i[0] <= hi]
    index = {a: k for k, (a, _, _, _) in enumerate(body)}
    inf = float("inf")
    best = [(inf, 0, -inf, 0)] * (len(body) + 1)  # (min insts, its mufu, max insts, its mufu)
    best[0] = (0, 0, 0, 0)
    for k, (a, op, tgt, always) in enumerate(body):
        if best[k][0] == inf:
            continue
        mu = int(op.startswith("MUFU"))
        cur = (best[k][0] + 1, best[k][1] + mu, best[k][2] + 1, best[k][3] + mu)
        nexts = []
        if k == len(body) - 1:
            nexts = [len(body)]
        else:
            if not (op.startswith("BRA") and always) and op != "EXIT":
                nexts.append(k + 1)
            if op.startswith("BRA") and tgt is not None and tgt > a and tgt in index:
                nexts.append(index[tgt])
        for n in nexts:
            b = best[n]
            lo_ = cur[:2] if cur[0] < b[0] else b[:2]
            hi_ = cur[2:] if cur[2] > b[2] else b[2:]
            best[n] = (*lo_, *hi_)
    if any(op.startswith("CALL") for _, op, _, _ in body):
        fail(f"the rep loop at {hex(lo)} calls a subroutine: its instructions go uncounted")
    mn, mn_mufu, mx, mx_mufu = best[len(body)]
    return dict(loop=[hex(lo), hex(hi)], min_insts=mn, min_mufu=mn_mufu, max_insts=mx,
                max_mufu=mx_mufu,
                forward_branches=sum(1 for _, op, _, _ in body[:-1] if op.startswith("BRA")))


def probe_sass(source, lanes_of) -> dict:
    """Per kernel of `source`'s library: its rep loop (_rep_loop) and the
    instructions and MUFUs an element and application on the loop's
    shortest path, given lanes_of(mangled name) = (chains a thread carries
    in the loop, elements a chain)."""
    from gags_torch import _kernels

    out = {}
    for name, insts in _sass_functions(_kernels._lib_path(source)).items():
        if "_kernel" not in name:
            continue
        r = _rep_loop(insts)
        lanes, per = lanes_of(name)
        r.update(lanes=lanes, elems_per_chain=per,
                 insts_per_elem_app=r["min_insts"] / (lanes * per),
                 mufu_per_elem_app=r["min_mufu"] / (lanes * per))
        out[re.search(r"([a-z][a-z_]*_kernel)", name).group(1)
            + "".join(f"<{a}>" for a in re.findall(r"L[ib](\d+)E", name))] = r
    return out


def probe_issue_bound(elems: int, reps: int, sass: dict, sms: int, mhz: float) -> dict:
    """The kernel's own-instruction bound: the least time the chain's
    compiled instructions take on `sms` SMs at `mhz`, every instruction an
    issue slot (ISSUE_LANES a clock an SM), every MUFU a slot of that pipe
    (MUFU_LANES a clock an SM). Extra instructions raise it, so it rates
    the scheduling of the compiled loop, not the design."""
    issue = sass["insts_per_elem_app"] / ISSUE_LANES
    mufu = sass["mufu_per_elem_app"] / MUFU_LANES
    cycles = max(issue, mufu) * elems * reps / sms
    return dict(issue_bound_ms=cycles / (mhz * 1e6) * 1e3,
                issue_bound_by="issue" if issue >= mufu else "mufu",
                sass_insts_per_elem_app=sass["insts_per_elem_app"],
                sass_mufu_per_elem_app=sass["mufu_per_elem_app"])


def probe_check(fn, plain, what: str, exact: bool) -> dict:
    """One probe launch against its plain version (bit for bit, or within
    1 ulp where `exact` is False) and against a second launch
    (bit-identical); fails the smoke otherwise."""
    got, again, want = fn(), fn(), plain()
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        fail(f"{what}: two launches differ at {int((got != again).sum())} values")
    ulps = _ulps(got, want)
    if ulps > (0 if exact else 1) or not torch.isfinite(got.float()).all():
        fail(f"{what}: {ulps} ulps from its plain version")
    return dict(max_abs_err=float((got.float() - want.float()).abs().max()), ulps=ulps,
                bit_identical=True)


def probe_entry(fn, plain, x: torch.Tensor, reps: int, what: str, exact: bool,
                issue: dict) -> dict:
    """One probe shape, checked by probe_check, with the kernel's and the
    plain version's device time per call (torch.profiler; a run reading
    below the kernel's own-instruction bound is refused) and CUDA-events
    time, the published-peak bound (each input read once and each output
    written once at 3.35 TB/s, or PROBE_OPS operations an element and
    application at 67 TFLOP/s) and the own-instruction bound `issue`
    (probe_issue_bound)."""
    check = probe_check(fn, plain, what, exact)
    elems = x.numel()
    r = with_bound(dict(
        shape=list(x.shape), dtype=str(x.dtype).split(".")[-1], reps=reps,
        ms=device_ms(fn, floor_ms=issue["issue_bound_ms"]), events_ms=cuda_ms(fn, 50),
        plain_ms=device_ms(plain, iters=5), plain_events_ms=cuda_ms(plain, 5, warmup=1),
        bytes_ms=2 * elems * x.element_size() / HBM_BYTES_PER_S * 1e3,
        ops_ms=PROBE_OPS * elems * reps / FP32_OPS_PER_S * 1e3, **check, **issue))
    r["element_chains_per_s"] = elems * reps / (r["ms"] * 1e-3)
    r["of_issue_bound"] = r["issue_bound_ms"] / r["ms"]
    print(f"# {what}: {r}", flush=True)
    return r


def bf16_patterns(dev: torch.device) -> torch.Tensor:
    """Every bf16 bit pattern once, as a (512, 128) block."""
    bits = torch.arange(65536, dtype=torch.int32)
    return ((bits + 32768) % 65536 - 32768).to(torch.int16).view(torch.bfloat16).reshape(
        512, 128).to(dev)


def _pattern_classes(x: torch.Tensor, where: torch.Tensor) -> dict:
    """Where the x patterns at `where` lie: counts by class, the binary
    exponent range of the normal ones and a few patterns in hex."""
    xs = x.cpu().float()[where.cpu()]
    bits = x.cpu().view(torch.int16)[where.cpu()].int() & 0xFFFF
    sub = (xs != 0) & (xs.abs() < 2.0 ** -126)
    normal = torch.isfinite(xs) & (xs != 0) & ~sub
    exps = torch.frexp(xs[normal])[1] - 1 if normal.any() else torch.zeros(0)
    return dict(n=int(where.sum()), nan=int(torch.isnan(xs).sum()),
                inf=int(torch.isinf(xs).sum()), zero=int((xs == 0).sum()),
                subnormal=int(sub.sum()), normal=int(normal.sum()),
                negative=int((bits >= 0x8000).sum()),
                normal_exponents=[int(exps.min()), int(exps.max())] if normal.any() else None,
                examples=[f"0x{int(b):04x}" for b in bits[:6]])


def probe_patterns(dev: torch.device, sms: int) -> dict:
    """P1 (reps 1 and 2) and P2 (one slab of each launch geometry) on all
    65,536 bf16 patterns fed as x, compared with their plain versions as
    bits (NaNs included); the phase fails where any pattern differs."""
    from gags_torch.probes import slab_probe, vpu_probe

    x = bf16_patterns(dev)
    cases = {f"P1 reps={r}": (lambda r=r: vpu_probe.vpu_chain(x, r),
                              lambda r=r: vpu_probe.vpu_chain_plain(x, r)) for r in (1, 2)}
    by_geometry = {}
    for slab in slab_probe.SLABS + (1,):
        by_geometry.setdefault(slab_probe.launch_geometry(*x.shape, slab, True, sms), slab)
    for slab in by_geometry.values():
        cases[f"P2 slab={slab}"] = (lambda s=slab: slab_probe.slab_chain(x, s),
                                    lambda: slab_probe.slab_chain_plain(x))
    report = {}
    for k, (fn, plain) in cases.items():
        got, want = fn().view(torch.int16), plain().view(torch.int16)
        report[k] = _pattern_classes(x, got != want)
    print(f"# 65,536 bf16 patterns: differing patterns "
          f"{ {k: v['n'] for k, v in report.items()} }", flush=True)
    for k, v in report.items():
        if v["n"]:
            fail(f"{k} on the 65,536 bf16 patterns: {v['n']} differ from the plain version "
                 f"({v})")
    return report


def probes_phase(dev: torch.device, gpu: str, logs: dict) -> list:
    """Phase 15: the probes' entry points (vpu_probe.main, slab_probe.main,
    the counted path), then P1 at the TPU block (reps 1) and at the rate
    shape (RATE_SHAPE x RATE_REPS), both types, each checked and timed by
    probe_entry beside its published-peak and own-instruction bounds; P2
    at every slab, both types, checked by probe_check and timed once per
    launch geometry, and at slab None with STEADY_REPS_FACTOR x REPS; both
    on the 65,536 bf16 patterns (probe_patterns); registers and spills
    from the build logs. Returns the kernels-line entries."""
    from gags_torch import probes
    from gags_torch.probes import slab_probe, vpu_probe

    torch.cuda.synchronize()
    probes.reset_launch_counts()
    vpu_main, slab_main = (m.main(["--device", str(dev)]) for m in (vpu_probe, slab_probe))
    torch.cuda.synchronize()
    launches = dict(probes.launch_counts)
    print(f"# probes' entry points: launches {launches} ({gpu})", flush=True)
    for name, n in launches.items():
        if n <= 0:
            fail(f"{name} was not launched by its probe's entry point")
    regs = {stem: ptxas_summary(logs[stem]) for stem in ("vpu_chain", "slab_chain")}
    for stem, lines in regs.items():
        for line in lines:
            print(f"# {stem} build: {line}", flush=True)
    sass = {**probe_sass(probes.VPU_CHAIN_SRC, lambda n: (4, 2 if "bfloat" in n else 1)),
            **probe_sass(probes.SLAB_CHAIN_SRC,
                         lambda n: (int(re.search(r"Li(\d+)E", n).group(1)),
                                    2 if "Lb1E" in n else 1))}
    for k, v in sass.items():
        print(f"# SASS {k}: {v}", flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mhz_now, mhz = sm_clock_mhz()
    print(f"# SM clock {mhz_now:.0f} MHz now, {mhz:.0f} MHz at most (the own-instruction "
          f"bounds' clock); {sms} SMs ({gpu})", flush=True)
    patterns = probe_patterns(dev, sms)
    p1 = {}
    shapes = (((vpu_probe.R, vpu_probe.C), 1), (vpu_probe.RATE_SHAPE, vpu_probe.RATE_REPS))
    for shape, reps in shapes:
        for dtype in vpu_probe.DTYPES:
            x = vpu_probe.probe_input(shape, dtype, dev)
            name = str(dtype).split(".")[-1]
            label = f"{name} {shape[0]}x{shape[1]} reps={reps}"
            kern = sass["vpu_chain_bfloat_kernel" if name == "bfloat16"
                        else "vpu_chain_float_kernel"]
            p1[label] = probe_entry(lambda: vpu_probe.vpu_chain(x, reps),
                                    lambda: vpu_probe.vpu_chain_plain(x, reps), x, reps,
                                    f"P1 vpu_chain {label}", exact=dtype == torch.bfloat16,
                                    issue=probe_issue_bound(x.numel(), reps, kern, sms, mhz))

    timed = {}  # (launch geometry, reps) -> the label that timed it

    def p2_entry(x, slab, reps):
        """P2 at one slab and reps with its launch: checked, and timed
        through probe_entry at the first slab of each launch geometry."""
        bf16 = x.dtype == torch.bfloat16
        label = f"{str(x.dtype).split('.')[-1]} slab={slab}" + (
            f" reps={reps}" if reps != slab_probe.REPS else "")
        geo = slab_probe.launch_geometry(slab_probe.P, slab_probe.G, slab, bf16, sms)
        print(f"# P2 {label}: launch {geo._asdict()}", flush=True)
        if geo.blocks < min(sms, slab_probe.P):
            fail(f"P2 {label}: {geo.blocks} blocks on {sms} SMs")
        what = f"P2 slab_chain {label}"
        fn = lambda: slab_probe.slab_chain(x, slab, reps)  # noqa: E731
        # the plain version takes the whole block at once: every slab's output
        plain = lambda: slab_probe.slab_chain_plain(x, None, reps)  # noqa: E731
        if (geo, reps) in timed:
            r = {**probe_check(fn, plain, what, exact=True), "same_launch_as": timed[geo, reps]}
            print(f"# {what}: {r}", flush=True)
        else:
            timed[geo, reps] = label
            kern = sass[f"slab_chain_kernel<{int(bf16)}><{geo.lanes}>"]
            r = probe_entry(fn, plain, x, reps, what, exact=True,
                            issue=probe_issue_bound(x.numel(), reps, kern, sms, mhz))
        return label, {**r, "launch": geo._asdict()}

    p2, steady = {}, {}
    for dtype in vpu_probe.DTYPES:
        x = vpu_probe.probe_input((slab_probe.P, slab_probe.G), dtype, dev)
        p2.update(p2_entry(x, slab, slab_probe.REPS) for slab in slab_probe.SLABS + (1,))
        # the same launch carrying ten times the work: the rate once the
        # launch and the blocks' ramp are amortised
        steady.update([p2_entry(x, None, STEADY_REPS_FACTOR * slab_probe.REPS)])
    rate = {d: p1[f"{d} {vpu_probe.RATE_SHAPE[0]}x{vpu_probe.RATE_SHAPE[1]} "
                  f"reps={vpu_probe.RATE_REPS}"]["element_chains_per_s"]
            for d in ("float32", "bfloat16")}
    print(f"# P1 at the rate shape: bf16 / f32 element-chain rate "
          f"{rate['bfloat16'] / rate['float32']:.3f} ({gpu})", flush=True)
    keep = ("ms", "events_ms", "plain_ms", "plain_events_ms", "bound_ms", "bound_by",
            "issue_bound_ms", "issue_bound_by", "of_issue_bound", "sass_insts_per_elem_app",
            "sass_mufu_per_elem_app", "max_abs_err", "ulps", "element_chains_per_s",
            "same_launch_as")
    head1, head2 = p1[f"float32 {vpu_probe.R}x{vpu_probe.C} reps=1"], p2["float32 slab=None"]
    head_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "issue_bound_ms", "issue_bound_by",
                 "events_ms")
    timing = ("ms, plain_ms: device time per call (torch.profiler); events_ms, plain_events_ms: "
              "back-to-back calls between CUDA events; issue_bound_ms: the kernel's "
              "own-instruction bound, its compiled rep loop's SASS instructions at "
              f"{ISSUE_LANES} a clock an SM and MUFUs at {MUFU_LANES}, {sms} SMs at {mhz:.0f} "
              "MHz: how well that loop is scheduled, not how far the design is from the card "
              "(bound_ms rates the design)")
    patterns_line = {k: r["n"] for k, r in patterns.items()}
    return [
        {"name": "vpu_chain", "id": "P1", "route": "cuda",
         "source": "gags_torch/probes/csrc/vpu_chain.cu", "replaces": "scripts/vpu_probe.py:36",
         "launches": launches["vpu_chain"], "check": "bit for bit (bf16), <= 1 ulp (f32)",
         "max_abs_err": max(r["max_abs_err"] for r in p1.values()),
         **{k: head1[k] for k in head_keys},
         "library_ms": None, "timing": timing,
         "bf16_over_f32_rate": rate["bfloat16"] / rate["float32"], "main_s": vpu_main,
         "registers": regs["vpu_chain"], "bf16_patterns_differing": patterns_line,
         "sass": {k: v for k, v in sass.items() if k.startswith("vpu")},
         "by_shape": {k: {kk: v[kk] for kk in keep if kk in v} for k, v in p1.items()}},
        {"name": "slab_chain", "id": "P2", "route": "cuda",
         "source": "gags_torch/probes/csrc/slab_chain.cu", "replaces": "scripts/slab_probe.py:71",
         "launches": launches["slab_chain"], "check": "bit for bit",
         "max_abs_err": max(r["max_abs_err"] for r in p2.values()),
         **{k: head2[k] for k in head_keys},
         "library_ms": None, "timing": timing, "main_s": slab_main,
         "registers": regs["slab_chain"], "bf16_patterns_differing": patterns_line,
         "sass": {k: v for k, v in sass.items() if k.startswith("slab")},
         "by_slab": {k: {**{kk: v[kk] for kk in keep if kk in v}, "launch": v["launch"]}
                     for k, v in p2.items()},
         "steady": {k: {**{kk: v[kk] for kk in keep if kk in v}, "launch": v["launch"]}
                    for k, v in steady.items()}},
    ]


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA card")
    from gags_torch.cli.serve import SceneServer, encode_png, make_handler
    from gags_torch.utils.colormaps import apply_pca_colormap
    from gags_torch.models.decoders import FeatureDecoder
    from gags_torch.models.weights import scene_from_arrays
    from gags_torch.core.sh import sh_colors
    from gags_torch import _kernels, probes
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
    from gags_torch.utils import jpeg

    logs = _kernels.build(list(kernels.SOURCES) + list(probes.SOURCES)
                          + [jpeg.JPEG_DECODE_SRC])
    print(f"# {len(logs)} kernel libraries ready in {time.perf_counter() - t0:.1f} s")
    for log in logs.values():
        for line in ptxas_summary(log):
            print(f"#   {line}")
            # blend_forward.cu's launch bounds are a rule per colour type
            # (min_blocks) that holds only while ptxas spills nothing
            if line.startswith("blend_forward_kernel") and not line.endswith(
                    " 0 bytes spill stores, 0 bytes spill loads"):
                fail(f"blend_forward spills: {line}")

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
    k6 = k6_check(kernels, offsets, slots, "serve")
    # the launch floor beside K6's bound: an empty kernel (one thread reads
    # the clock once), timed the same way
    empty_launch_ms = device_ms(lambda: torch.cuda._sleep(0))
    print(f"# empty launch: {empty_launch_ms:.5f} ms device time ({gpu})", flush=True)

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
        if not torch.equal(out_k, kernels.blend_forward(*args)):  # one writer per pixel
            fail(f"K5 C={c}: two launches differ")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_p, walked, blended, near = kernels.blend_forward_plain(*args, return_pairs=True)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        cmp = flip_tolerant_compare(out_k, out_p, f"K5 blend_forward C={c} ({label})")
        nbytes = (geom_p.numel() + cols_p.numel() + binned.inst_gid.numel()
                  + 2 * binned.tile_starts.numel() + bg.numel() + out_k.numel()) * 4
        ops = blend_ops(near, blended, 4 + 2 * c)
        k5_fn = lambda: kernels.blend_forward(*args)  # noqa: E731
        k5[label] = dict(
            channels=c, ms=device_ms(k5_fn), events_ms=cuda_ms(k5_fn, 20),
            plain_ms=plain_ms, pairs_walked=walked, pairs_blended=blended, pairs_near=near,
            bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3, ops_ms=ops / FP32_OPS_PER_S * 1e3,
            bit_identical=True, **cmp,
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
    train_kernels, (options, query, warm, multi) = train_phase(
        dev, gpu, lambda root, model: (options_phase(root, model, dev, gpu, serve_k5),
                                       query_phase(root, model, dev, gpu),
                                       warm_phase(root, model, dev, gpu),
                                       multi_phase(root, model, dev, gpu)))
    del serve_k5, cols_f
    ws, surf_gad = warm["warm_start"], warm["surface"]["gad"]["launches"]
    for r in train_kernels:  # phase 9d's paths: warm start (tuner apart), surface scene
        r["warm_start_launches"] = ws["launches_loop"].get(r["name"], 0)
        r["tuner_launches"] = ws["launches_setup_and_tuner"].get(r["name"], 0)
        r["surface_gad_launches"] = surf_gad.get(r["name"], 0)

    # -- 10-13. RGB pretraining, K8; 14. GAS on its scene and model --------------
    k8, k3_rgb, k1_rgb, k6_rgb, (gas_report, j1) = rgb_phase(
        dev, gpu, lambda root, model: (gas_phase(root, model, dev, gpu),
                                       jpeg_phase(root, model, dev, gpu)))
    rgb_kernels = [k8]
    for r in k3_rgb.values():  # two launches a step: C = 3 and C = 8
        r["launches"] = k8["rgb_launches"]["sorted_segment_sum"] // 2
    k3 = next(r for r in train_kernels if r["id"] == "K3")
    k3["by_width"] = {"GAD C=16": {k: k3[k] for k in k3_rgb["RGB C=3"]}, **k3_rgb}
    k1 = next(r for r in train_kernels if r["id"] == "K1")
    k1["by_width"] = {"GAD C=16": {k: k1[k] for k in k1_rgb}, "RGB C=3": k1_rgb}

    # -- 15. the probes' kernels P1 and P2 -------------------------------------------
    probe_kernels = probes_phase(dev, gpu, logs)

    # -- 17. report --------------------------------------------------------------
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
            **{k: k6[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                  "events_ms", "timing")},
            "empty_launch_ms": empty_launch_ms,
            "gas_stage_a_launches": gas_report["stage_a_launches"].get("expand_gid", 0),
            "viewer_launches": warm["viewer"]["launches"]["expand_gid"],
            "warm_start_setup_launches": ws["launches_setup_and_tuner"].get("expand_gid", 0),
            "surface_gad_launches": surf_gad.get("expand_gid", 0),
            "by_shape": {"serve": k6, "RGB aligned": k6_rgb},
        },
        {
            "name": "blend_forward", "id": "K5", "route": "cuda",
            "source": "gags_torch/splat/csrc/blend_forward.cu",
            "replaces": "gags_tpu/splat/pallas_kernel.py:719",
            "launches": launches["blend_forward"], "check": "ok",
            "max_abs_err": max(v["max_abs_err"] for v in k5.values()),
            "ms": f16["ms"], "events_ms": f16["events_ms"], "plain_ms": f16["plain_ms"],
            "bound_ms": max(f16["bytes_ms"], f16["ops_ms"]),
            "bound_by": "bytes" if f16["bytes_ms"] >= f16["ops_ms"] else "operations",
            "library_ms": None, "timing": DEVICE_TIMING,
            "gas_stage_a_launches": gas_report["stage_a_launches"].get("blend_forward", 0),
            "viewer_launches": warm["viewer"]["launches"]["blend_forward"],
            "by_option": options["k5"],
            "by_scene": {k: v for k, v in warm["surface"].items() if k != "gad"},
            "by_channels": {
                str(v["channels"]): {
                    "ms": v["ms"], "events_ms": v["events_ms"], "plain_ms": v["plain_ms"],
                    "bound_ms": max(v["bytes_ms"], v["ops_ms"]),
                    "pairs_walked": v["pairs_walked"], "pairs_blended": v["pairs_blended"],
                    "pairs_near": v["pairs_near"],
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
        "gas_stage_a_launches": gas_report["stage_a_launches"].get("expand_keys", 0),
        "by_shape": k7,
        "render_cli": {k: {kk: r[kk] for kk in ("frames", "seconds", "frames_per_s",
                                                 "autotune", "launches")}
                       for k, r in render_runs.items()},
    })
    kernels_line["kernels"].extend(probe_kernels)
    kernels_line["kernels"].append(
        {**{k: j1[k] for k in keep}, **{k: v for k, v in j1.items() if k not in keep}})
    for r in kernels_line["kernels"]:  # phase 16: launches inside the ranks, by path
        r["distributed_launches"] = {path: counts.get(r["name"], 0)
                                     for path, counts in multi["distributed_launches"].items()}
    print(f"# GAS report: {json.dumps(gas_report)}")
    print(f"# multi-rank report ({MULTI_LABEL}): "
          f"{json.dumps({k: v for k, v in multi.items() if k != 'distributed_launches'})}")
    print(f"# query report: {json.dumps(query)}")
    print(f"# warm-start report: {json.dumps(warm)}")
    print(f"# device_ms profiled runs, by caller: "
          f"{json.dumps({k: dict(v) for k, v in PROFILE_TALLY.items()})}", flush=True)
    print(f"# smoke run time: {time.perf_counter() - t_start:.1f} s (builds included)")
    print(json.dumps(kernels_line))
    print(f"gpu: {gpu}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(nccl_main() if sys.argv[1:] == ["--nccl"] else main())
