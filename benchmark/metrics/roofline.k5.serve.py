"""K5 blend_forward: the least time its work can take on these inputs
(its operations or bytes, benchmark/counts/ops.py, on the pair counts of
the cameras of four requests drawn from the seed) over its mean device
time a kept record."""

from benchmark.lib.trace import roofline_pct

SYMBOL = "blend_forward_kernel"


def read(trace):
    return roofline_pct(trace, SYMBOL)
