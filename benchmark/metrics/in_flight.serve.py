"""Mean over the profiled requests of the requests already inside the
handler's `do_POST` when one came: the other `serve.request` spans
(`cli/serve.py`) open at each one's start (benchmark/lib/spans.py)."""

from benchmark.lib import spans


def read(trace):
    return spans.open_at_start_mean("serve.request")
