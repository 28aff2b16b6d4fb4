"""The harness on the CPU, through test-only tiny configurations that
BENCHMARK.json does not list (benchmark/tests/data): the shape of the
last line, the refusal without a card, plug-ins found by name, a new
configuration, mix and metric added as files alone, and the output
check failing on each fault a cell can have."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ENV = {**os.environ, "OMP_NUM_THREADS": "2", "MKL_NUM_THREADS": "2"}
ROOT = Path(__file__).resolve().parents[2]
SPEC = ROOT / "benchmark" / "tests" / "data" / "spec.json"
CELLS = ("gad-tiny-train", "rgb-tiny-train", "gad-tiny-relevancy")


def _run(workload, *extra, seed=12345, root=ROOT, spec=SPEC, seconds=1, trace=0):
    cmd = [sys.executable, str(root / "benchmark" / "run.py"), "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace),
           "--spec", str(spec), "--device", "cpu", *extra]
    return subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=root, env=ENV)


def _last(proc):
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("workload", CELLS)
def test_last_line_shape_and_correct(workload):
    out = _last(_run(workload, seed=2**31 + 11))
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert "setup_s" in out["metrics"] and len(out["metrics"]) == 2
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]


def test_traced_line_carries_per_layer_metrics_and_breakdown():
    out = _last(_run("gad-tiny-relevancy", seed=99, trace=1))
    assert out["correct"] is True
    assert {"handler_ms.serve", "png_ms.serve"} <= set(out["metrics"])
    assert "busy_s" in out["device"] and out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(out["breakdown"]["idle_gaps"]) <= 10


def test_no_card_exits_nonzero_without_a_result():
    cmd = [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload", "gad-tiny-train",
           "--seed", "1", "--seconds", "1", "--trace", "0", "--spec", str(SPEC)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=ROOT, env=ENV)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())


def test_unknown_workload_and_missing_plugin_refused():
    assert _run("no-such-cell").returncode != 0


@pytest.mark.parametrize("workload,fault", [
    ("gad-tiny-train", "half_batch"), ("gad-tiny-train", "unchanged"),
    ("rgb-tiny-train", "half_batch"), ("rgb-tiny-train", "unchanged"),
    ("gad-tiny-relevancy", "altered"),
])
def test_fault_makes_correct_false(workload, fault):
    out = _last(_run(workload, "--inject", fault, seed=424242))
    assert out["correct"] is False, out["checks"]


def test_new_config_mix_and_metric_are_files_alone(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix and a
    per-layer metric by new files and new spec entries only."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "gags_torch").symlink_to(ROOT / "gags_torch")
    data = root / "benchmark" / "tests" / "data"
    cfg = json.loads((data / "configs" / "gad-tiny.json").read_text())
    cfg["num_gaussians"] = 2500
    (data / "configs" / "gad-tiny-b.json").write_text(json.dumps(cfg))
    mix = json.loads((data / "traffic" / "gad_loop_tiny.json").read_text())
    mix["warmup_steps"] = 4
    (data / "traffic" / "gad_loop_tiny_b.json").write_text(json.dumps(mix))
    (root / "benchmark" / "metrics" / "extra.steps.py").write_text(
        "def read(trace):\n    return float(trace['units'])\n")
    spec = json.loads((data / "spec.json").read_text())
    spec["configs"].append({"name": "gad-tiny-b", "source": "test", "file":
                            "configs/gad-tiny-b.json", "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "gad-tiny-b-train", "config": "gad-tiny-b",
                              "traffic": "gad_loop_tiny_b", "chips": 1, "why": "test"})
    spec["end_to_end"][1]["workloads"].append("gad-tiny-b-train")
    spec["per_layer"].append({"name": "extra.steps", "unit": "steps", "better": "higher",
                              "source": "device_trace", "layer": "GAD step",
                              "moves": "gad_step_ms", "workloads": ["gad-tiny-b-train"]})
    (data / "spec.json").write_text(json.dumps(spec))
    out = _last(_run("gad-tiny-b-train", root=root, spec=data / "spec.json", trace=1, seed=8))
    assert out["metrics"]["extra.steps"]["value"] == 2.0
    assert out["correct"] is True


def test_checkout_without_the_program_exits_nonzero(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's
    files gives no result."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for device in ("cuda", "cpu"):
        cmd = [sys.executable, "benchmark/run.py", "--workload", "gad-train", "--seed", "3",
               "--seconds", "1", "--trace", "0", "--device", device]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=tmp_path,
                              env=ENV)
        assert proc.returncode != 0
        assert not any(line.startswith("{") for line in proc.stdout.splitlines())
