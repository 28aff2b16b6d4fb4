"""Open-vocabulary queries against the port's HTTP server: POST
/relevancy to `gags_torch.cli.serve`'s SceneServer, built by
`load_server(autotune=False)` from a model directory the set-up writes,
served by `ThreadingHTTPServer` on a free local port inside the run.

The load comes from a process of its own (benchmark/lib/loadgen.py):
open loop, Poisson arrivals at the traffic's fixed rate, every request
timed from its due time. Poses follow a smooth seeded orbit of novel
views at the configuration's serving size; each request names one of
the seeded labels. After the window a sample of the replies, drawn from
the seed, is recomputed by the plain reference.
"""

from __future__ import annotations

import base64
import json
import math
import multiprocessing as mp
import os
import threading
import time

import numpy as np
import torch

from benchmark.counts import ops, pairs
from benchmark.drivers.gad_train import decoder_weights, make_inputs as gad_inputs
from benchmark.lib import fixtures, harness, loadgen
from benchmark import reference
from benchmark.lib.trace import Profiled
from benchmark.reference import serve as ref_serve

ITERATION = 30000


def write_model(root: str, inp: dict, dec: dict, labels, pos, neg) -> tuple:
    r = inp["raw"]
    fixtures.write_gaussian_ply(
        os.path.join(root, "point_cloud", f"iteration_{ITERATION}", "point_cloud.ply"),
        r["means"], r["sh"], r["opacities_raw"], r["scales_raw"], r["quats"], r["features"])
    torch.save({"feature_decoder": {k: v.detach().cpu().contiguous() for k, v in dec.items()}},
               os.path.join(root, "decoders.pt"))
    text = os.path.join(root, "text_embeds.npz")
    np.savez(text, labels=np.array(labels), pos=pos, neg=neg)
    return root, text


def make_requests(cfg: dict, tr: dict, seed: int, n_labels: int, rate: float, seconds: float):
    """Due offsets (Poisson at `rate`) and request bodies over `seconds`."""
    rng = np.random.default_rng([seed, 3])
    offs, t = [], rng.exponential(1.0 / rate)
    while t < seconds:
        offs.append(float(t))
        t += rng.exponential(1.0 / rate)
    w, h = cfg["serve_width"], cfg["serve_height"]
    focal = w / (2 * math.tan(math.radians(cfg["fov_deg"]) / 2))
    K = [focal, 0.0, w / 2.0, 0.0, focal, h / 2.0, 0.0, 0.0, 1.0]
    phase = rng.uniform(0.0, 1.0)
    orbit = tr["orbit"]
    bodies = []
    for o in offs:
        s = phase + o / orbit["period_s"]
        eye = fixtures.orbit_eye(s, tuple(orbit["radius_xy"]), orbit["z"])
        target = (orbit["target_sway"] * math.sin(2 * math.pi * s * 0.5), 0.0, 6.0)
        vm = fixtures.look_at(eye, target).astype(np.float32)
        bodies.append(dict(viewmat=[float(x) for x in vm.reshape(-1)], K=K, width=w, height=h,
                           label=f"label{int(rng.integers(n_labels))}", thresh=tr["thresh"]))
    return offs, bodies


def text_embeds(seed: int, n_labels: int, n_neg: int, dim: int):
    rng = np.random.default_rng([seed, 4])
    v = rng.normal(size=(n_labels + n_neg, dim))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v = v.astype(np.float32)
    return [f"label{i}" for i in range(n_labels)], v[:n_labels], v[n_labels:]


class Spans:
    """Host time of SceneServer.relevancy and of the PNG encodes inside
    it, per request, from wrappers installed by the benchmark."""

    def __init__(self, server, serve_mod):
        self.handler, self.png = [], []
        self._local = threading.local()
        self._lock = threading.Lock()
        real_rel, real_png = server.relevancy, serve_mod.encode_png

        def png(img):
            t = time.perf_counter()
            try:
                return real_png(img)
            finally:
                self._local.png = getattr(self._local, "png", 0.0) + time.perf_counter() - t

        def relevancy(req):
            self._local.png = 0.0
            t = time.perf_counter()
            out = real_rel(req)
            dt = time.perf_counter() - t
            with self._lock:
                self.handler.append(dt)
                self.png.append(self._local.png)
            return out

        server.relevancy = relevancy
        serve_mod.encode_png = png


def _post(port: int, body: dict) -> dict:
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}/relevancy",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


def start_server(ctx, root: str, text: str):
    """SceneServer behind a ThreadingHTTPServer on a free local port."""
    from http.server import ThreadingHTTPServer

    import gags_torch.cli.serve as serve_mod

    server = serve_mod.load_server(root, ITERATION, text_embeds=text, device=str(ctx.device),
                                   autotune=False)
    if ctx.inject == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    elif ctx.inject == "altered":
        real = server.relevancy_map

        def shifted(cam, pos, neg):  # the answer moved by a pixel where it is made
            return torch.roll(real(cam, pos, neg), 1, dims=-1)

        server.relevancy_map = shifted
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve_mod.make_handler(server))
    httpd.daemon_threads = True
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    return server, httpd, th, serve_mod


def offered(port: int, offs, bodies, keep, drain_s: float):
    """Run the load generator process over the schedule; returns its
    records and the window's start (monotonic)."""
    mctx = mp.get_context("spawn")
    job_q, ready_q, out_q = mctx.Queue(), mctx.Queue(), mctx.Queue()
    proc = mctx.Process(target=loadgen.main, args=(job_q, ready_q, out_q), daemon=True)
    proc.start()
    try:
        ready_q.get(timeout=120)
        t0 = time.monotonic() + 0.25
        job_q.put(dict(url=f"http://127.0.0.1:{port}/relevancy",
                       bodies=[json.dumps(b).encode() for b in bodies], offsets=offs, t0=t0,
                       drain_s=drain_s, keep=set(keep)))
        recs = out_q.get(timeout=(offs[-1] if offs else 0) + drain_s + 120)
    finally:
        proc.join(timeout=30)
        if proc.is_alive():
            proc.kill()
            proc.join()
    return recs, t0


def run(ctx) -> dict:
    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    t_fix = time.perf_counter()
    inp = gad_inputs(cfg, ctx.seed, supervision=False)
    dec, _ = decoder_weights(cfg, ctx.seed, dev)
    labels, pos, neg = text_embeds(ctx.seed, tr["labels"], tr["negatives"], cfg["clip_dim"])
    root, text = write_model(os.path.join(ctx.tmp, "model"), inp, dec, labels, pos, neg)
    harness.detail(f"fixture: {cfg['num_gaussians']} Gaussians, decoders, {tr['labels']} labels "
                   f"written in {time.perf_counter() - t_fix:.3f} s")
    server, httpd, th, serve_mod = start_server(ctx, root, text)
    port = httpd.server_address[1]
    spans = Spans(server, serve_mod) if ctx.trace else None
    try:
        _, warm_bodies = make_requests(cfg, tr, ctx.seed + 1, tr["labels"], 50.0,
                                               tr["warmup_requests"])
        for b in warm_bodies[:tr["warmup_requests"]]:
            _post(port, b)
        if spans is not None:
            spans.handler.clear()
            spans.png.clear()
        offs, bodies = make_requests(cfg, tr, ctx.seed, tr["labels"], tr["rate_per_s"], ctx.seconds)
        rng = np.random.default_rng([ctx.seed, 5])
        keep = sorted(rng.choice(len(offs), size=min(tr["checked_requests"], len(offs)),
                                 replace=False).tolist())
        prof = Profiled(dev) if ctx.trace else None
        if prof is not None:
            prof.start()
        recs, t0 = offered(port, offs, bodies, keep, tr["drain_s"])
        window_s = prof.stop() if prof is not None else None
        setup_s = t0 - (time.monotonic() - (time.perf_counter() - ctx.t_start))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
    lat = [(r[3] - r[1]) if (r[3] is not None and r[5] is not None) else math.inf for r in recs]
    failed = sum(1 for x in lat if math.isinf(x))
    late = [r[2] - r[1] for r in recs if r[2] is not None]
    p95 = harness.percentile([x * 1e3 for x in lat], 95)
    harness.detail(f"window: {len(recs)} requests due over {ctx.seconds} s at "
                   f"{tr['rate_per_s']}/s; failed {failed}; latency ms p50 "
                   f"{harness.percentile([x * 1e3 for x in lat], 50):.3f} p95 {p95:.3f} max "
                   f"{max(lat) * 1e3 if lat else 0:.3f}; generator lateness ms p50 "
                   f"{harness.percentile([x * 1e3 for x in late], 50):.3f} max "
                   f"{max(late) * 1e3 if late else 0:.3f}; set-up {setup_s:.3f} s; "
                   f"memory peak {peak} B")
    del server, httpd
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    geo = _geometry(inp["raw"], dev)
    trace = None
    if ctx.trace:
        trace = _trace(ctx, prof, spans, geo, bodies, recs, window_s)
    with reference.float32():
        checks = _check(ctx, geo, dec, pos, neg, labels, bodies, recs, keep)
    return dict(e2e={"setup_s": setup_s, "relevancy_p95_ms": p95}, attempted=len(recs),
                failed=failed, checks=checks, trace=trace, memory_peak_bytes=peak)


def _geometry(raw, dev):
    t = {k: torch.as_tensor(raw[k], device=dev) for k in ("means", "quats", "scales_raw",
                                                          "opacities_raw", "features")}
    return dict(means=t["means"], quats=t["quats"], scales=torch.exp(t["scales_raw"]),
                opacities=torch.sigmoid(t["opacities_raw"]), features=t["features"])


def _cam(body, dev):
    vm = torch.as_tensor(np.asarray(body["viewmat"], np.float32).reshape(4, 4), device=dev)
    K = torch.as_tensor(np.asarray(body["K"], np.float32).reshape(3, 3), device=dev)
    return vm, K


def _trace(ctx, prof, spans, geo, bodies, recs, window_s) -> dict:
    summary = prof.summary()
    c = ctx.cell.config["feature_dim"]
    rng = np.random.default_rng([ctx.seed, 6])
    idx = rng.choice(len(bodies), size=min(4, len(bodies)), replace=False)
    bounds = []
    for i in idx:
        b = bodies[int(i)]
        vm, K = _cam(b, ctx.device)
        pc = pairs.count(geo["means"], geo["quats"], geo["scales"], geo["opacities"], vm, K,
                         b["width"], b["height"])
        bounds.append(ops.bound_s(ops.forward_blend_ops(pc["near"], pc["blended"], c),
                                  ops.forward_blend_bytes(pc["visible"], pc["instances"],
                                                          pc["tiles"], pc["pixels"], c)))
        harness.detail(f"pairs request {int(i)}: {pc}")
    served = sum(1 for r in recs if r[5] is not None)
    harness.detail(f"profiled {len(recs)} requests ({served} answered) in {window_s:.6f} s: "
                   f"{summary['records_kept']} kernel records kept of {summary['launch_calls']} "
                   f"launches; busy {summary['busy_s']:.6f} s (union {summary['union_s']:.6f} s); "
                   f"lost launches by host op {summary['lost_by_op']}")
    return dict(summary=summary, units=served, window_s=window_s,
                bounds_s={"blend_forward_kernel": sum(bounds) / len(bounds)},
                spans={"handler_s": spans.handler, "png_s": spans.png})


def _check(ctx, geo, dec, pos, neg, labels, bodies, recs, keep) -> list:
    lim = ctx.cell.traffic["limits"]
    dev = ctx.device
    t0 = time.perf_counter()
    pos_t = torch.as_tensor(pos, device=dev)
    neg_t = torch.as_tensor(neg, device=dev)
    unanswered = sum(1 for r in recs if r[5] is None)
    rel_gap = heat_off = mask_off = 0.0
    for i in keep:
        r = recs[i]
        if r[6] is None:
            rel_gap = heat_off = mask_off = math.inf
            continue
        b = bodies[i]
        vm, K = _cam(b, dev)
        k = labels.index(b["label"])
        want = ref_serve.reply(geo, geo["features"], dec, vm, K, b["width"], b["height"],
                               pos_t[k:k + 1], neg_t, b["thresh"])
        heat = fixtures.decode_png(base64.b64decode(r[6]["heatmap_png"]))
        mask = fixtures.decode_png(base64.b64decode(r[6]["mask_png"]))
        rel_gap = max(rel_gap, abs(r[5]["relevancy_max"] - want["relevancy_max"])
                      / max(abs(want["relevancy_max"]), 1e-30))
        heat_off = max(heat_off, float(np.mean(np.any(heat != want["heat"], axis=-1))))
        mask_off = max(mask_off, float(np.mean(np.any(mask != want["mask"], axis=-1))),
                       abs(r[5]["selected_px"] - want["selected_px"]) / mask.shape[0] / mask.shape[1])
    harness.detail(f"reference: {len(keep)} replies (requests {keep}) in "
                   f"{time.perf_counter() - t0:.3f} s")
    return [("unanswered", float(unanswered), 0.0),
            ("relevancy_max_gap", rel_gap, lim["relevancy_max_gap"]),
            ("heat_px_off", heat_off, lim["heat_px_off"]),
            ("mask_px_off", mask_off, lim["mask_px_off"])]

