"""The per-layer metrics read from the program's own spans
(benchmark/lib/spans.py, gags_torch.utils.tracing): each tiny cell run
traced on the CPU with the new metrics added to a copy of the test spec
reads a number for every host metric and nothing for the device ones;
the readers' arithmetic (per-step sums, medians, p95, means) on a
hand-made snapshot."""

import json
import shutil
import sys

import pytest

from benchmark.lib import harness, spans
from benchmark.tests.test_bench_harness import ROOT, _last, _run

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = [m for m in SPEC["per_layer"] if m["source"] == "program_span"
       and m["name"] not in ("handler_ms.serve", "png_ms.serve")]
TINY = {"gad-train": "gad-tiny-train", "rgb-train": "rgb-tiny-train",
        "gad-relevancy": "gad-tiny-relevancy"}


def test_fifteen_new_metrics_each_with_a_reader():
    assert len(NEW) == 15
    for m in NEW:
        assert m["better"] == "lower" and len(m["workloads"]) == 1
        assert callable(harness.metric_reader(m["name"]))


@pytest.mark.parametrize("cell", sorted(TINY))
def test_tiny_cell_traced_reads_the_span_metrics(tmp_path, cell):
    data = tmp_path / "data"
    shutil.copytree(ROOT / "benchmark" / "tests" / "data", data)
    spec = json.loads((data / "spec.json").read_text())
    mine = [dict(m, workloads=[TINY[cell]]) for m in NEW if m["workloads"] == [cell]]
    spec["per_layer"] += mine
    (data / "spec.json").write_text(json.dumps(spec))
    out = _last(_run(TINY[cell], spec=data / "spec.json", trace=1, seed=2**31 + 5))
    assert out["correct"] is True, out["checks"]
    for m in mine:
        if m["name"].split(".")[0].endswith("_dev_ms"):
            assert m["name"] not in out["metrics"]  # no CUDA events on the CPU
        else:
            v = out["metrics"][m["name"]]
            assert v["unit"] == m["unit"] and v["value"] >= 0, m["name"]


def _span(sid, name, root, start_ms, end_ms, device_ms=None):
    return dict(name=name, id=sid, parent=None if sid == root else root, root=root, thread=1,
                start_ns=int(start_ms * 1e6), end_ns=int(end_ms * 1e6), device_ms=device_ms)


@pytest.fixture()
def snap(monkeypatch):
    recs = [
        _span(1, "gad.step", 1, 0, 50, device_ms=45.0),
        _span(2, "gad.batch_wait", 1, 0, 1),
        _span(3, "gad.decoders", 1, 2, 4, device_ms=3.0),
        _span(4, "gad.decoders", 1, 5, 9, device_ms=5.0),
        _span(5, "gad.step", 5, 60, 100, device_ms=40.0),
        _span(6, "gad.batch_wait", 5, 60, 64),
        _span(7, "gad.decoders", 5, 65, 66, device_ms=2.0),
        _span(8, "gad.batch_load", 8, 10, 13),
        _span(9, "gad.batch_load", 9, 70, 71),
        _span(10, "gad.batch_load", 10, 80, 90),
        _span(11, "serve.request", 11, 0, 100),
        _span(12, "serve.encode", 11, 60, 80),
        _span(13, "serve.write", 11, 80, 90),
        _span(14, "serve.request", 14, 50, 250),
        _span(15, "serve.encode", 14, 150, 160),
        _span(16, "serve.write", 14, 160, 170),
        _span(17, "serve.request", 17, 60, 360),
        _span(18, "serve.encode", 17, 250, 290),
        _span(19, "serve.write", 17, 290, 295),
        _span(20, "rgb.step", 20, 0, 20),
    ]
    monkeypatch.setattr(spans, "_spans", lambda: recs)
    return recs


def _read(name):
    return harness.metric_reader(name)({})


def test_readers_arithmetic_on_a_hand_made_snapshot(snap):
    assert _read("loader_wait_ms.gad_train") == pytest.approx((1 + 4) / 2)
    assert _read("loader_host_ms.gad_train") == pytest.approx(3.0)  # median of 3, 1, 10
    assert _read("decoders_dev_ms.gad_train") == pytest.approx((3 + 5 + 2) / 2)
    assert _read("render_dev_ms.gad_train") is None  # no record of it
    assert _read("request_p95_ms.serve") == pytest.approx(290.0)  # 100, 200, 300
    assert _read("in_flight.serve") == pytest.approx(1.0)  # 0, 1, 2 open at the starts
    assert _read("reply_host_ms.serve") == pytest.approx(30.0)  # median of 30, 20, 45
    assert _read("forward_host_ms.rgb_train") is None
    assert _read("lock_wait_p95_ms.serve") is None


def test_device_metric_reads_nothing_where_a_record_has_no_events(snap):
    snap[2]["device_ms"] = None
    assert _read("decoders_dev_ms.gad_train") is None


def test_a_program_without_the_tracing_module_reads_nothing(monkeypatch):
    import gags_torch.utils

    monkeypatch.delattr(gags_torch.utils, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "gags_torch.utils.tracing", None)
    for m in NEW:
        assert _read(m["name"]) is None
