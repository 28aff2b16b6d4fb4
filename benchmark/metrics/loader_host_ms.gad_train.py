"""Median host ms the GAD loader thread spends on one batch: `gad.batch_load`,
the pinned copies to the device on the side stream in `gad/data.py`
(benchmark/lib/spans.py)."""

from benchmark.lib import spans


def read(trace):
    return spans.median(spans.values_ms("gad.batch_load"))
