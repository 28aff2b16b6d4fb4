"""Stream ms a GAD step spends between the two CUDA events of `gad.backward`
(`total.backward()` in `gad/train._apply`): the device's work there and any
gap in which it waited for the host, summed under each `gad.step` and
averaged over the profiled steps (benchmark/lib/spans.py); nothing on the
CPU."""

from benchmark.lib import spans


def read(trace):
    return spans.per_root_ms({"gad.backward"}, "gad.step", device=True)
