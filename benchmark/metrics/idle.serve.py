"""The device's idle share of the profiled window in gad-relevancy, 1 - busy /
window (benchmark/lib/trace.py)."""

from benchmark.lib.trace import idle_pct


def read(trace):
    return idle_pct(trace)
