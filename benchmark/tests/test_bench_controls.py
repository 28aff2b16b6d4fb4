"""On the card: each cell's lower-precision control (GAD and serving: the
program with TF32 switched on, as their configuration states float32
without it; RGB, which has no matrix product: bfloat16 colour rows)
comes out not correct, and the same run without it correct, at the test-only
tiny sizes of benchmark/tests/data (the cell-size readings are in
PERF.md, taken with benchmark/tools/readings.py). Skips without a card.

  python -m pytest benchmark/tests/test_bench_controls.py -q -m cuda
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ENV = {**os.environ, "OMP_NUM_THREADS": "2", "MKL_NUM_THREADS": "2"}
ROOT = Path(__file__).resolve().parents[2]
SPEC = ROOT / "benchmark" / "tests" / "data" / "spec.json"


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA device")


def _run(workload, *extra):
    cmd = [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload", workload,
           "--seed", "2147483659", "--seconds", "1", "--trace", "0", "--spec", str(SPEC), *extra]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900, cwd=ROOT, env=ENV)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("workload,control", [
    ("gad-tiny-train", "tf32"), ("rgb-tiny-train", "bf16_colors"),
    ("gad-tiny-relevancy", "tf32")])
def test_control_fails_and_sound_run_passes(card, workload, control):
    assert _run(workload)["correct"] is True
    out = _run(workload, "--inject", control)
    assert out["correct"] is False, out["checks"]
