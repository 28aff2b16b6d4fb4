"""Median over the profiled requests of the host ms `SceneServer.lock` is
held: `serve.locked` (render, decode, relevancy, mask, both images'
8-bit pixels, readbacks; `cli/serve.py`; benchmark/lib/spans.py)."""

from benchmark.lib import spans


def read(trace):
    return spans.median(spans.values_ms("serve.locked"))
