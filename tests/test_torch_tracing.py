"""gags_torch.utils.tracing: off without a profiler (no profiler range,
no CUDA call, nothing recorded); under a CPU profiler the records' names,
parents, roots and threads, the buffer's cap, and stamps on the
profiler's clock; the spans of one binned GAD step through the CLI, one
RGB step and one /relevancy request, and their losses and replies bit for
bit with the profiler on and off. The `cuda` tests (a device span against
CUDA events, a GAD step's device spans against the step's) run on the
card: python -m pytest tests/test_torch_tracing.py -q --noconftest
"""

import json
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gags_torch.cli.serve import SceneServer, make_handler
from gags_torch.cli.train_gad import RunConfig, run
from gags_torch.models.decoders import FeatureDecoder
from gags_torch.rgb import train as trgb
from gags_torch.scene.gaussian_data import scene_from_arrays
from gags_torch.splat.rasterizer import RasterizeConfig
from gags_torch.utils import tracing
from gags_torch.utils.synthetic import make_camera, make_scene

from test_torch_train_cli import _cfg, build_fixture

GAD_STEP = {"gad.batch_wait": 1, "gad.render": 1, "gad.decoders": 2, "gad.losses": 2,
            "gad.backward": 1, "gad.adam": 1}
RGB_STEP = {"rgb.forward": 1, "rgb.backward": 1, "rgb.update": 1}
SERVE_REQUEST = {"serve.lock_wait": 1, "serve.locked": 1, "serve.encode": 1, "serve.write": 1}


@pytest.fixture(autouse=True)
def empty_buffer():
    tracing.clear()
    yield
    tracing.clear()


def _start(activities=(ProfilerActivity.CPU,)):
    prof = profile(activities=list(activities))
    prof.start()
    return prof


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s["name"], []).append(s)
    return out


def _under(spans, root):
    """{name: count} of the spans below `root` (itself left out)."""
    out = {}
    for s in spans:
        if s["root"] == root["id"] and s["id"] != root["id"]:
            out[s["name"]] = out.get(s["name"], 0) + 1
    return out


def test_off_records_nothing_and_touches_neither_profiler_nor_cuda(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("called with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "current_stream", refuse)
    first = tracing.span("a")
    for _ in range(3):
        with tracing.span("b", device=torch.device("cuda")) as sp:
            assert sp is first  # one shared no-op
    assert tracing.snapshot() == {"spans": [], "dropped": 0}


def test_names_parents_and_roots():
    prof = _start()
    try:
        with tracing.span("outer"):
            with tracing.span("mid"):
                with tracing.span("inner"):
                    pass
            with tracing.span("mid"):
                pass
        with tracing.span("second"):
            pass
    finally:
        prof.stop()
    with tracing.span("after"):  # the profiler has stopped: not recorded
        pass
    snap = tracing.snapshot()
    assert snap["dropped"] == 0
    names = [s["name"] for s in snap["spans"]]
    assert names == ["inner", "mid", "mid", "outer", "second"]  # the order they ended
    by = _by_name(snap["spans"])
    outer, second = by["outer"][0], by["second"][0]
    assert outer["parent"] is None and outer["root"] == outer["id"]
    assert all(m["parent"] == outer["id"] and m["root"] == outer["id"] for m in by["mid"])
    inner = by["inner"][0]
    assert inner["parent"] == by["mid"][0]["id"] and inner["root"] == outer["id"]
    assert second["parent"] is None and second["root"] == second["id"] != outer["id"]
    for s in snap["spans"]:
        assert s["start_ns"] <= s["end_ns"] and s["device_ms"] is None
        assert s["thread"] == threading.get_native_id()
    assert outer["start_ns"] <= by["mid"][0]["start_ns"]
    assert by["mid"][1]["end_ns"] <= outer["end_ns"]


def test_worker_threads_keep_their_own_stacks():
    """Spans of worker threads are recorded (the profiler records only the
    thread that started it); each thread's spans nest on its own stack."""
    go, done = threading.Event(), []

    def worker(k):
        go.wait(10)
        with tracing.span(f"work{k}"):
            with tracing.span("part"):
                time.sleep(0.002)
        done.append(threading.get_native_id())

    prof = _start()
    try:
        with tracing.span("main") as main:
            threads = [threading.Thread(target=worker, args=(k,)) for k in range(4)]
            for t in threads:
                t.start()
            go.set()
            for t in threads:
                t.join(10)
            assert not any(t.is_alive() for t in threads)
    finally:
        prof.stop()
    by = _by_name(tracing.snapshot()["spans"])
    assert len(by["part"]) == 4
    work = [w for k in range(4) for w in by[f"work{k}"]]
    assert len(work) == 4 and len({w["thread"] for w in work}) == 4
    works = {w["id"]: w for w in work}
    for w in work:  # a root on its thread, not a child of the main thread's span
        assert w["parent"] is None and w["root"] == w["id"] and w["thread"] in done
    for p in by["part"]:
        assert works[p["parent"]]["thread"] == p["thread"] and p["root"] == p["parent"]
    assert main.thread == threading.get_native_id() not in {w["thread"] for w in work}


def test_no_span_lost_under_contention():
    """More threads than cores opening nested spans with a short switch
    interval: every span is kept once, under its own thread's parent."""
    import os
    import sys

    n_threads, n_spans = 2 * (os.cpu_count() or 4), 300
    old = sys.getswitchinterval()
    prof = _start()
    try:
        sys.setswitchinterval(1e-6)

        def worker():
            for _ in range(n_spans):
                with tracing.span("outer"):
                    with tracing.span("inner"):
                        pass

        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        prof.stop()
    spans = tracing.snapshot()["spans"]
    assert len(spans) == 2 * n_threads * n_spans
    assert len({s["id"] for s in spans}) == len(spans)
    outer = {s["id"]: s for s in spans if s["name"] == "outer"}
    for s in spans:
        if s["name"] == "inner":
            assert outer[s["parent"]]["thread"] == s["thread"] and s["root"] == s["parent"]


def test_buffer_cap_counts_the_dropped(monkeypatch):
    monkeypatch.setattr(tracing, "CAPACITY", 3)
    prof = _start()
    try:
        with tracing.span("a"):
            for _ in range(4):
                with tracing.span("b"):
                    pass
    finally:
        prof.stop()
    snap = tracing.snapshot()
    assert [s["name"] for s in snap["spans"]] == ["b", "b", "a"]
    assert snap["dropped"] == 2
    tracing.clear()
    assert tracing.snapshot() == {"spans": [], "dropped": 0}


class _Stream:
    """A stand-in CUDA stream: events recorded on it complete once
    `done` reaches their tick, a millisecond apart."""
    device_index = 0

    def __init__(self):
        self.tick, self.done = 0.0, -1.0


class _Event:
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _Event.made += 1
        self.t = None

    def record(self, stream):
        self.stream, self.t = stream, stream.tick
        stream.tick += 1.0

    def query(self):
        return self.t <= self.stream.done

    def synchronize(self):
        self.stream.done = max(self.stream.done, self.t)

    def elapsed_time(self, end):
        return end.t - self.t


def test_device_spans_reuse_their_events(monkeypatch):
    """Device spans take event pairs from a free list: while the device
    lags, new pairs; once their end events have completed, the pairs of
    read spans, each span's time read before its pair is reused; after
    `clear()` a new window creates none."""
    stream = _Stream()
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: stream)
    monkeypatch.setattr(tracing, "_free", {})
    monkeypatch.setattr(tracing, "_unread", type(tracing._unread)())
    monkeypatch.setattr(_Event, "made", 0)
    cuda = torch.device("cuda")

    def window(n):
        for _ in range(n):
            with tracing.span("dev", device=cuda):
                pass

    prof = _start()
    try:
        window(3)  # nothing has completed: three new pairs
        assert _Event.made == 6
        stream.done = stream.tick  # the device catches up
        window(3)
        assert _Event.made == 6
    finally:
        prof.stop()
    spans = tracing.snapshot()["spans"]
    assert [s["device_ms"] for s in spans] == [1.0] * 6
    tracing.clear()
    prof = _start()
    try:
        window(3)
    finally:
        prof.stop()
    assert _Event.made == 6
    assert [s["device_ms"] for s in tracing.snapshot()["spans"]] == [1.0] * 3
    tracing.clear()


def test_stamps_lie_on_the_profilers_clock():
    """A main-thread span's start and end lie within 100 µs of its
    profiler range's event, read as the profile's trace_start_ns plus the
    event's offset; the range is a CPU op, not a user annotation (which
    would add a device-side record on the card)."""
    with profile(activities=[ProfilerActivity.CPU]) as warm:  # first ranges cost more
        with tracing.span("warm"):
            pass
    del warm
    tracing.clear()
    prof = _start()
    try:
        for _ in range(3):
            with tracing.span("stamped"):
                torch.ones(1000).sum()
    finally:
        prof.stop()
    t0 = prof.profiler.kineto_results.trace_start_ns()
    events = sorted((e for e in prof.events() if e.name == "stamped"),
                    key=lambda e: e.time_range.start)
    spans = tracing.snapshot()["spans"]
    assert len(events) == len(spans) == 3
    assert not any(e.is_user_annotation for e in events)
    for e, s in zip(events, spans):
        assert abs(t0 + e.time_range.start * 1000 - s["start_ns"]) < 100_000
        assert abs(t0 + e.time_range.end * 1000 - s["end_ns"]) < 100_000


def _gad_run(root, model, traced_iteration=None, device="cpu", iterations=4):
    """The CLI on the tiny fixture; with `traced_iteration` a CPU profiler
    runs over that iteration alone (stopped once the loader thread has
    also loaded a batch in it), and on the card a pair of timing events
    brackets its step on the stream. Returns each step's loss and
    {"prof": the profile, "events": the pair}."""
    losses, box = [], {}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])

    def on_step(it, state, m):
        if m is not None:
            losses.append(m["loss"].item())
            if it == traced_iteration:
                if device == "cuda":
                    box["events"][1].record()
                deadline = time.time() + 10
                while time.time() < deadline and not any(
                        s["name"] == "gad.batch_load" for s in tracing.snapshot()["spans"]):
                    time.sleep(0.01)
                box["prof"].stop()
        if traced_iteration is not None and it == traced_iteration - 1:
            box["prof"] = _start(acts)
            if device == "cuda":
                box["events"] = (torch.cuda.Event(enable_timing=True),
                                 torch.cuda.Event(enable_timing=True))
                box["events"][0].record()

    rc = RunConfig(source_path=root, model_path=model, ply_path=root + "/pretrained.ply",
                   resolution=1, iterations=iterations, save_iterations="",
                   test_iterations="", device=device)
    run(rc, _cfg(), on_step=on_step)
    return losses, box


def test_gad_step_spans_and_bit_identical_losses(tmp_path):
    root = str(tmp_path / "scene")
    build_fixture(root)
    plain, _ = _gad_run(root, str(tmp_path / "m0"))
    traced, _ = _gad_run(root, str(tmp_path / "m1"), traced_iteration=3)
    assert traced == plain  # bit for bit
    spans = tracing.snapshot()["spans"]
    by = _by_name(spans)
    assert len(by["gad.step"]) == 1
    step = by["gad.step"][0]
    assert step["parent"] is None and step["thread"] == threading.get_native_id()
    assert _under(spans, step) == GAD_STEP
    wait = by["gad.batch_wait"][0]
    assert wait["parent"] == step["id"] and wait["thread"] == step["thread"]
    assert by["gad.batch_load"]
    for load in by["gad.batch_load"]:  # the loader thread's roots
        assert load["parent"] is None and load["root"] == load["id"]
        assert load["thread"] != step["thread"]
    for name in GAD_STEP:
        for s in by[name]:
            assert step["start_ns"] <= s["start_ns"] <= s["end_ns"] <= step["end_ns"]
            assert s["device_ms"] is None  # no device events on the CPU
    assert set(by) == set(GAD_STEP) | {"gad.step", "gad.batch_load"}


def _rgb_parts():
    raw = make_scene(40, seed=2)
    scene = scene_from_arrays(raw["means"], raw["quats"], np.log(raw["scales"]),
                              np.log(raw["opacities"] / (1 - raw["opacities"])), raw["sh"])
    cfg = trgb.RgbConfig(capacity_factor=2, raster=RasterizeConfig(
        tile_h=8, tile_w=16, chunk=8, budget_factor=8, geometry_grads=True))
    cam = make_camera(32, 16)
    img = torch.as_tensor(np.random.default_rng(5).uniform(size=(16, 32, 3)), dtype=torch.float32)
    return scene, cfg, dict(viewmat=cam.viewmat, K=cam.K, image=img)


def test_rgb_step_spans_and_bit_identical_state():
    scene, cfg, batch = _rgb_parts()
    step = trgb.make_rgb_step(cfg, 32, 16, spatial_scale=1.0)
    out = []
    for traced in (False, True):
        state = trgb.create_rgb_state(scene, cfg, device="cpu")
        state, _ = step(state, batch, 1e-4, 3)  # untraced, then one step each way
        prof = _start() if traced else None
        state, m = step(state, batch, 1e-4, 3)
        if prof is not None:
            prof.stop()
        out.append((m["loss"].clone(), {k: v.clone() for k, v in state.params.items()},
                    state.grad_accum.clone(), state.opt["means"]["nu"].clone()))
    (l0, p0, g0, n0), (l1, p1, g1, n1) = out
    assert torch.equal(l0, l1) and torch.equal(g0, g1) and torch.equal(n0, n1)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    spans = tracing.snapshot()["spans"]
    by = _by_name(spans)
    assert len(by["rgb.step"]) == 1 and set(by) == set(RGB_STEP) | {"rgb.step"}
    root = by["rgb.step"][0]
    assert _under(spans, root) == RGB_STEP
    assert all(s["parent"] == root["id"] for s in spans if s is not root)
    phases = sorted((s for s in spans if s is not root), key=lambda s: s["start_ns"])
    assert [s["name"] for s in phases] == ["rgb.forward", "rgb.backward", "rgb.update"]
    assert sum(s["end_ns"] - s["start_ns"] for s in phases) <= root["end_ns"] - root["start_ns"]


def _server():
    raw = make_scene(60, seed=0, feature_dim=16)
    scene = scene_from_arrays(raw["means"], raw["quats"], np.log(raw["scales"]),
                              np.log(raw["opacities"] / (1 - raw["opacities"])), raw["sh"],
                              semantic_features=raw["features"])
    dec = FeatureDecoder(in_dim=16, generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(7)
    text = (["thing"], rng.normal(size=(1, 512)).astype(np.float32),
            rng.normal(size=(3, 512)).astype(np.float32))
    return SceneServer(scene, dec, text_embeds=text, device="cpu",
                       raster=RasterizeConfig(tile_h=8, tile_w=16, chunk=8, aligned=False))


def test_relevancy_request_spans_and_bit_identical_replies():
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(_server()))
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    cam = make_camera(32, 16)
    body = json.dumps(dict(viewmat=cam.viewmat.reshape(-1).tolist(), K=cam.K.reshape(-1).tolist(),
                           width=32, height=16, label="thing")).encode()

    def post():
        req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_address[1]}/relevancy",
                                     data=body, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()

    try:
        prof = _start()  # the server's first request: none other is in flight
        try:
            traced = post()
        finally:
            prof.stop()
        plain = post()
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=10)
    assert plain[0] == 200 and traced == plain  # the reply's bytes
    spans = _wait_for("serve.request", 1)
    by = _by_name(spans)
    assert len(by["serve.request"]) == 1 and set(by) == set(SERVE_REQUEST) | {"serve.request"}
    root = by["serve.request"][0]
    assert root["thread"] != threading.get_native_id()  # a handler thread
    assert _under(spans, root) == SERVE_REQUEST
    order = sorted((s for s in spans if s is not root), key=lambda s: s["start_ns"])
    assert [s["name"] for s in order] == ["serve.lock_wait", "serve.locked", "serve.encode",
                                          "serve.write"]
    assert all(s["parent"] == root["id"] and s["thread"] == root["thread"] for s in order)


def test_in_flight_counts_requests_inside_the_handler():
    """Two requests, the second sent while the first waits for the device
    lock: the second's `serve.request` opens inside the first's and the
    first's inside none, so the requests open at each one's start (what
    `in_flight.serve` counts) read 0 and 1."""
    srv = _server()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(srv))
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    cam = make_camera(32, 16)
    body = json.dumps(dict(viewmat=cam.viewmat.reshape(-1).tolist(), K=cam.K.reshape(-1).tolist(),
                           width=32, height=16, label="thing")).encode()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/relevancy"
    codes = []

    def post():
        req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            codes.append(r.status)

    prof = _start()
    try:
        srv.lock.acquire()
        try:
            first = threading.Thread(target=post)
            first.start()
            deadline = time.time() + 10
            while time.time() < deadline and not _waiting(1):
                time.sleep(0.005)
            second = threading.Thread(target=post)
            second.start()
            while time.time() < deadline and not _waiting(2):
                time.sleep(0.005)
        finally:
            srv.lock.release()
        first.join(30)
        second.join(30)
        assert not first.is_alive() and not second.is_alive()
    finally:
        prof.stop()
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=10)
    assert codes == [200, 200]
    by = _by_name(_wait_for("serve.request", 2))
    reqs = sorted(by["serve.request"], key=lambda s: s["start_ns"])
    assert [sum(o is not r and o["start_ns"] <= r["start_ns"] < o["end_ns"] for o in reqs)
            for r in reqs] == [0, 1]
    waits = by["serve.lock_wait"]
    assert max(w["end_ns"] - w["start_ns"] for w in waits) > 0


def _wait_for(name, n):
    """The records once `n` of `name` have ended: a client can read its
    reply before the handler's span has closed."""
    deadline = time.time() + 10
    while True:
        spans = tracing.snapshot()["spans"]
        if sum(s["name"] == name for s in spans) >= n or time.time() > deadline:
            return spans
        time.sleep(0.005)


def _waiting(n):
    """Whether `n` requests have opened their lock wait (spans still open
    are not in the buffer: count the admitted ones)."""
    return tracing._taken >= 2 * n


# ---------------------------------------------------------------- the card


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (device spans time CUDA events)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_device_span_reads_its_events(cuda):
    torch.cuda._sleep(1000)  # warm
    torch.cuda.synchronize()
    prof = _start((ProfilerActivity.CPU, ProfilerActivity.CUDA))
    try:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with tracing.span("sleep", device=cuda):
            a.record()
            torch.cuda._sleep(50_000_000)  # tens of ms at the card's clock
            b.record()
        torch.cuda.synchronize()
    finally:
        prof.stop()
    want = a.elapsed_time(b)
    (s,) = tracing.snapshot()["spans"]
    assert want > 5.0
    assert abs(s["device_ms"] - want) <= 0.05 * want, (s["device_ms"], want)


@pytest.mark.cuda
def test_gad_step_device_spans_fit_in_the_step(cuda, tmp_path):
    root = str(tmp_path / "scene")
    build_fixture(root)
    _, box = _gad_run(root, str(tmp_path / "m"), traced_iteration=3, device="cuda")
    prof, (a, b) = box["prof"], box["events"]
    spans = tracing.snapshot()["spans"]
    from torch.autograd import DeviceType

    device_names = {e.name for e in prof.events() if e.device_type == DeviceType.CUDA}
    assert device_names and not device_names & {s["name"] for s in spans}
    (step,) = _by_name(spans)["gad.step"]
    parts = [s for s in spans if s["root"] == step["id"] and s["name"] != "gad.batch_wait"
             and s["id"] != step["id"]]
    assert {s["name"] for s in parts} == set(GAD_STEP) - {"gad.batch_wait"}
    assert all(s["device_ms"] is not None and s["device_ms"] >= 0 for s in parts)
    assert step["device_ms"] is None  # the root is not timed on the device
    b.synchronize()
    assert sum(s["device_ms"] for s in parts) <= a.elapsed_time(b)
