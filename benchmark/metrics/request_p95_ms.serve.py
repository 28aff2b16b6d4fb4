"""95th percentile over the profiled requests of the host ms in the
server's handler: `serve.request`, `do_POST` from the body's read to the
reply written (`cli/serve.py`; benchmark/lib/spans.py)."""

from benchmark.lib import spans


def read(trace):
    return spans.p95(spans.values_ms("serve.request"))
