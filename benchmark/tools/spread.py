"""Quartile spreads of a cell's runs, as the bounds are set from them.

  python3 benchmark/tools/spread.py runs.jsonl [--sets 2]

Reads the result lines readings.py wrote, splits them into `--sets`
consecutive sets, and prints for each metric each set's median and
spread (the distance between the first and third quartiles of
statistics.quantiles(values, n=4), as a share of the median), the wider
spread, five times it, and the driver's tightness reading (the mean of
the sets' spreads, each set without its run farthest from the median).
"""

import argparse
import json
import statistics


def spread(values):
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("path")
    p.add_argument("--sets", type=int, default=2)
    a = p.parse_args(argv)
    rows = [json.loads(x) for x in open(a.path) if x.strip()]
    size = len(rows) // a.sets
    sets = [rows[i * size:(i + 1) * size] for i in range(a.sets)]
    for name in sorted({k for r in rows for k in r["metrics"]}):
        per = []
        for s in sets:
            vals = [r["metrics"][name]["value"] for r in s if name in r["metrics"]]
            med = statistics.median(vals)
            trimmed = sorted(vals, key=lambda v: abs(v - med))[:-1]
            per.append((med, spread(vals), spread(trimmed) if len(trimmed) >= 2 else 0.0, vals))
        wide = max(x[1] for x in per)
        print(f"{name}: medians {[round(x[0], 6) for x in per]} spreads "
              f"{[round(x[1], 6) for x in per]} wider {wide:.6f} x5 {5 * wide:.6f} tight-read "
              f"{statistics.mean(x[2] for x in per):.6f} medians gap "
              f"{abs(per[-1][0] - per[0][0]) / per[0][0]:.6f}")
        for x in per:
            print(f"   {x[3]}")


if __name__ == "__main__":
    main()
