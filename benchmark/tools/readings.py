"""Readings for the output check's limits and the bounds, on the card.

  python3 benchmark/tools/readings.py --workload <cell> --seeds 11,12,13 \
      --seconds 10 [--trace 0|1] [--inject tf32|half_batch|unchanged|altered] [--out file.jsonl]

Runs the cell once per seed, each run a process of its own, one after
the other, and prints for each its seed, exit code, wall time, metrics
and the numbers the check compared; with --out it appends each result
line, with its seed, to a JSON-lines file (for spread.py). --inject
plants the lower-precision control or a fault; the benchmark's own runs
never do.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--inject", default="")
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    bad = 0
    for seed in a.seeds.split(","):
        cmd = [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload", a.workload,
               "--seed", seed, "--seconds", str(a.seconds), "--trace", str(a.trace)]
        if a.inject:
            cmd += ["--inject", a.inject]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT)
        wall = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        for line in lines[:-1]:
            if line.startswith("#"):
                print(f"  {seed} {line}")
        res = None
        if proc.returncode == 0 and lines:
            res = json.loads(lines[-1])
        if res is None:
            bad += 1
            print(f"seed {seed}: rc {proc.returncode} in {wall:.1f} s; stderr tail:\n"
                  f"{proc.stderr[-2000:]}", flush=True)
            continue
        short = {k: v["value"] for k, v in res["metrics"].items()}
        checks = {k: v["value"] for k, v in res["checks"].items()}
        print(f"seed {seed}: rc 0 in {wall:.1f} s; correct {res['correct']}; attempted "
              f"{res['attempted']} failed {res['failed']}; metrics {short}; checks {checks}; "
              f"device {res['device']}", flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(json.dumps({"seed": int(seed), "inject": a.inject, "wall_s": wall,
                                    **res}) + "\n")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
