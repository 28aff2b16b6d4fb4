"""The program's own spans (`gags_torch.utils.tracing`) in a traced run,
read by the per-layer readers after the profiled window: the program
records them while the drivers' profiler runs and at no other time.

A step is a root span (`gad.step`, `rgb.step`, `serve.request`); a
per-step figure is the sum of a name's records under each root, averaged
over the roots recorded. Host times come from the spans' stamps, stream
times from their CUDA events (`device_ms`: the stream's elapsed time
between a span's two events, its kernels and any gap in which the device
waited for the host; a run on the CPU has none). A program without the tracing module, or a window without
the spans asked for, reads None.
"""

from __future__ import annotations

import statistics

from benchmark.lib.harness import percentile


def _spans():
    try:
        from gags_torch.utils import tracing
    except ImportError:  # a program from before the spans
        return []
    return tracing.snapshot()["spans"]


def _ms(s: dict, device: bool):
    return s["device_ms"] if device else (s["end_ns"] - s["start_ns"]) * 1e-6


def per_root_ms(names, root: str, device: bool = False):
    """The records of `names` under each root span named `root`, summed
    per root and averaged over the roots; None where no such record was
    kept or one has no time."""
    spans = _spans()
    roots = {s["id"] for s in spans if s["name"] == root}
    vals = [_ms(s, device) for s in spans if s["name"] in names and s["root"] in roots]
    if not vals or any(v is None for v in vals):
        return None
    return sum(vals) / len(roots)


def per_root_values_ms(names, root: str) -> list:
    """Host ms of the records of `names` summed per root span named
    `root`, one value a root that has any."""
    spans = _spans()
    roots = {s["id"] for s in spans if s["name"] == root}
    out: dict = {}
    for s in spans:
        if s["name"] in names and s["root"] in roots:
            out[s["root"]] = out.get(s["root"], 0.0) + _ms(s, False)
    return list(out.values())


def values_ms(name: str) -> list:
    """Host ms of each record of `name`."""
    spans = _spans()
    return [_ms(s, False) for s in spans if s["name"] == name]


def median(vals):
    return statistics.median(vals) if vals else None


def p95(vals):
    return percentile(vals, 95) if vals else None


def open_at_start_mean(name: str):
    """The mean over the records of `name` of how many other records of
    `name` were open when one started (began before it, ended after)."""
    recs = [(s["start_ns"], s["end_ns"], s["id"]) for s in _spans() if s["name"] == name]
    vals = [sum(1 for a, b, j in recs if j != i and a <= t < b) for t, _, i in recs]
    return statistics.fmean(vals) if vals else None
