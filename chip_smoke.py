#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (gags_torch) on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which fails the run:
  1. print the card's name and power limit (nvidia-smi); no CUDA → exit 1;
  2. build every kernel of the serving path from gags_torch/splat/csrc
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
  7. print {"kernels": [...]} with times, bounds and launch counts, then
     the card's name and power limit, then the final {"ok": true, ...}.
"""

from __future__ import annotations

import base64
import json
import re
import subprocess
import sys
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


def profile_request(fn, label: str, top: int = 8) -> None:
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


def main() -> int:
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
    cfg = RasterizeConfig()
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
                    scam.viewmat, scam.K, 160, 96, config=RasterizeConfig(tile_h=16, tile_w=16),
                    device=dev)
    p = project_gaussians(st["means"], st["quats"], st["scales"], scam.viewmat, scam.K, 160, 96)
    ref_img, ref_alpha = rasterize_reference(p.means2d, p.conics, p.depths, p.radii,
                                             st["opacities"] * p.compensations, st["features"],
                                             160, 96)
    flip_tolerant_compare(res.image, ref_img, "rasterize vs oracle (3000 Gaussians, 160x96)")
    flip_tolerant_compare(res.alpha, ref_alpha, "rasterize alpha vs oracle")

    # -- 7. report -------------------------------------------------------------
    f16 = k5["features"]
    kernels_line = {"kernels": [
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
    print(json.dumps(kernels_line))
    print(f"gpu: {gpu}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
