"""The benchmark of gags_torch, the PyTorch and CUDA port of GAGS.

  python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json on the CUDA device it finds: set-up
(inputs made from the seed, the entry point's own loading, warm-up),
one measured window, the output check against the plain reference, and
one JSON result line, the last line of standard output. `--trace 0`
reports the cell's end-to-end metrics, `--trace 1` its per-layer ones
from a profiled sub-window. Without a CUDA device it exits non-zero and
prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
# torch's TensorBoard writer, which the trainers open when it imports,
# pulls in TensorFlow, and TensorFlow JAX: keep TensorFlow out
sys.modules.setdefault("tensorflow", None)

from benchmark.lib import harness  # noqa: E402


@dataclasses.dataclass
class RunContext:
    cell: harness.Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    tmp: str
    t_start: float
    inject: str = ""


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # for the benchmark's own tests and its control readings only
    p.add_argument("--spec", default=None, help=argparse.SUPPRESS)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"), help=argparse.SUPPRESS)
    p.add_argument("--inject", default="",
                   choices=("", "tf32", "bf16_colors", "half_batch", "unchanged", "altered"),
                   help=argparse.SUPPRESS)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    try:
        cell = harness.load_cell(args.workload, args.spec)
        if args.device == "cuda":
            harness.require_cuda(cell.chips)
        import torch

        if "torch_threads" in cell.traffic:
            torch.set_num_threads(int(cell.traffic["torch_threads"]))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device("cuda:0" if args.device == "cuda" else "cpu")
        drv = harness.driver(cell.traffic["driver"])
        readers = {m["name"]: harness.metric_reader(m["name"]) for m in cell.per_layer}
    except (harness.BenchError, ImportError, KeyError, OSError) as exc:
        print(f"benchmark: {type(exc).__name__}: {exc}", file=sys.stderr)
        return 2
    tmp = tempfile.mkdtemp(prefix="gags-bench-")
    try:
        if dev.type == "cuda":
            harness.detail(f"card: {harness.gpu_line()}; torch {torch.__version__}, "
                           f"CUDA {torch.version.cuda}")
        ctx = RunContext(cell, args.seed, args.seconds, bool(args.trace), dev, tmp, T_START,
                         args.inject)
        res = drv.run(ctx)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: JAX modules loaded in the measuring process: {bad}", file=sys.stderr)
        return 3
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics, breakdown, device = {}, None, {
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": 1, "memory_peak_bytes": int(res["memory_peak_bytes"])}
    if args.trace:
        tr = res["trace"]
        for name, read in readers.items():
            v = read(tr)
            if v is not None:
                metrics[name] = (v, units[name])
        device["busy_s"] = tr["summary"]["busy_s"]
        device["window_s"] = tr["summary"]["window_s"]
        breakdown = {"device_ops": tr["summary"]["device_ops"],
                     "idle_gaps": tr["summary"]["idle_gaps"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = (res["e2e"][m["name"]], m["unit"])
    checks = res["checks"]
    correct = harness.judge(checks)
    harness.print_checks(checks)
    print(harness.result_line(correct, res["attempted"], res["failed"], metrics, device, checks,
                              breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
