"""The benchmark's frame: the spec, the plug-ins found by name, the device
check, the result line and the check that no JAX module was loaded.

Everything that belongs to one configuration, traffic mix or per-layer
metric lives in files of its own, found by the names BENCHMARK.json
gives: `configs/<config>.json` (the file the spec names), `traffic/
<mix>.json` (parameters, with `driver` naming `drivers/<driver>.py`) and
`metrics/<metric>.py` (a `read(trace)` returning a number or None).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gags_tpu")


class BenchError(RuntimeError):
    """A run that cannot give a result (no card, a missing plug-in)."""


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, spec_path: Optional[Path] = None) -> Cell:
    """The cell named `workload`, with its configuration and traffic mix
    read from their files, and the metrics it reports."""
    spec_path = Path(spec_path or ROOT / "BENCHMARK.json")
    spec = _load_json(spec_path)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise BenchError(f"no workload {workload!r} in {spec_path}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    cfg_entry = configs[w["config"]]
    config = _load_json(spec_path.parent / cfg_entry["file"])
    local = spec_path.parent / "traffic" / f"{w['traffic']}.json"
    traffic = _load_json(local if local.is_file() else BENCH_DIR / "traffic" / f"{w['traffic']}.json")

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]

    e2e = [m for m in spec["end_to_end"] if mine(m)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if mine(m) and m["moves"] in names]
    return Cell(workload, int(w["chips"]), w["config"], config, w["traffic"], traffic, e2e,
                per_layer)


def _module(path: Path, name: str):
    if not path.is_file():
        raise BenchError(f"missing plug-in {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    return _module(BENCH_DIR / "drivers" / f"{name}.py", f"benchmark_driver_{name}")


def metric_reader(name: str) -> Callable[[dict], Optional[float]]:
    safe = name.replace(".", "_").replace("-", "_")
    return _module(BENCH_DIR / "metrics" / f"{name}.py", f"benchmark_metric_{safe}").read


def require_cuda(chips: int):
    import torch

    if not torch.cuda.is_available():
        raise BenchError("no CUDA device: this benchmark measures the port on an NVIDIA GPU")
    if torch.cuda.device_count() < chips:
        raise BenchError(f"the cell needs {chips} CUDA devices, {torch.cuda.device_count()} seen")


def gpu_line() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is a JAX package or the JAX
    package this port was made from."""
    return sorted({m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN})


def detail(msg: str) -> None:
    print(f"# {msg}", flush=True)


def host_sample() -> dict:
    """What the host did to this process so far: its CPU seconds, the
    times the kernel took the CPU from it, Python's full collections, and
    the machine's steal and total CPU ticks (a virtual machine's
    neighbours show as steal) with its load average."""
    import gc
    import os
    import resource
    import time

    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = dict(t=time.perf_counter(), cpu=ru.ru_utime + ru.ru_stime, nivcsw=ru.ru_nivcsw,
               gen2=gc.get_stats()[2]["collections"], load=os.getloadavg()[0])
    try:
        with open("/proc/stat") as f:
            ticks = [int(x) for x in f.readline().split()[1:]]
        out.update(steal=ticks[7] if len(ticks) > 7 else 0, ticks=sum(ticks[:8]))
    except (OSError, ValueError):
        pass
    return out


def host_detail(a: dict, b: dict) -> None:
    """One line on how the host treated the window between two samples."""
    wall = max(b["t"] - a["t"], 1e-9)
    msg = (f"host: process CPU {100.0 * (b['cpu'] - a['cpu']) / wall:.1f}% of the window; "
           f"involuntary switches {b['nivcsw'] - a['nivcsw']}; full collections "
           f"{b['gen2'] - a['gen2']}; load {a['load']:.2f} -> {b['load']:.2f}")
    if "steal" in a and "steal" in b and b["ticks"] > a["ticks"]:
        msg += f"; steal {100.0 * (b['steal'] - a['steal']) / (b['ticks'] - a['ticks']):.2f}%"
    detail(msg)


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation; inf counts as
    the largest value."""
    vs = sorted(values)
    if not vs:
        return math.inf
    pos = (len(vs) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    if math.isinf(vs[hi]):
        return math.inf
    return vs[lo] + (vs[hi] - vs[lo]) * (pos - lo)


def result_line(correct: bool, attempted: int, failed: int, metrics: Dict[str, tuple],
                device: dict, checks: List[tuple], breakdown: Optional[dict] = None) -> str:
    """The last line of a run. `metrics` {name: (value, unit)}, `checks`
    [(name, value, limit)], last in the line."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": {k: {"value": v, "unit": u} for k, (v, u) in metrics.items()},
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {n: {"value": v if v is not None and math.isfinite(v) else None,
                         "limit": lim} for n, v, lim in checks}
    return json.dumps(out)


def print_checks(checks: List[tuple]) -> None:
    for n, v, lim in checks:
        ok = v is not None and v <= lim
        print(f"check {n}: {v!r} (limit {lim!r}) {'ok' if ok else 'FAILED'}",
              file=sys.stderr, flush=True)


def judge(checks: List[tuple]) -> bool:
    """Every number at or under its limit; a missing or non-finite number
    fails."""
    return all(v is not None and math.isfinite(v) and v <= lim for _, v, lim in checks)
