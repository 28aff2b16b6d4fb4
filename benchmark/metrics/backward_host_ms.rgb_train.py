"""Host ms an RGB step spends in `rgb.backward` (`loss.backward()`) in
`rgb/train.make_rgb_step`, under each `rgb.step`, averaged over the profiled
steps (benchmark/lib/spans.py)."""

from benchmark.lib import spans


def read(trace):
    return spans.per_root_ms({"rgb.backward"}, "rgb.step")
