"""Host ms a GAD step waits for its batch: `gad.batch_wait` (the
consumer's get in `gad/data.prefetch_to_device`) under each `gad.step`,
averaged over the profiled steps (benchmark/lib/spans.py)."""

from benchmark.lib import spans


def read(trace):
    return spans.per_root_ms({"gad.batch_wait"}, "gad.step")
