"""K8 blend_backward_full: the least time its work can take on these
inputs (its operations or bytes, benchmark/counts/ops.py, on the pair
counts of the traced steps' cameras over the state at the profiled
window's start) over its mean device time a kept record."""

from benchmark.lib.trace import roofline_pct

SYMBOL = "blend_backward_full_kernel"


def read(trace):
    return roofline_pct(trace, SYMBOL)
