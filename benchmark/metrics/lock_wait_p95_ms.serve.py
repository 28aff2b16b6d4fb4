"""95th percentile over the profiled requests of the host ms spent
acquiring `SceneServer.lock`: `serve.lock_wait` (`cli/serve.py`;
benchmark/lib/spans.py)."""

from benchmark.lib import spans


def read(trace):
    return spans.p95(spans.values_ms("serve.lock_wait"))
