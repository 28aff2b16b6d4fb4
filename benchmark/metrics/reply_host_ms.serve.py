"""Median over the profiled requests of the host ms that make and send
the reply: `serve.encode` (both PNGs, base64) plus `serve.write`
(JSON, the socket write) under each `serve.request` (`cli/serve.py`;
benchmark/lib/spans.py)."""

from benchmark.lib import spans


def read(trace):
    return spans.median(spans.per_root_values_ms({"serve.encode", "serve.write"},
                                                 "serve.request"))
