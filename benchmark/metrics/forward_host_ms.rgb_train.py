"""Host ms an RGB step spends in `rgb.forward` (SH colours, rasterize, L1 +
SSIM) in `rgb/train.make_rgb_step`, under each `rgb.step`, averaged over the
profiled steps (benchmark/lib/spans.py)."""

from benchmark.lib import spans


def read(trace):
    return spans.per_root_ms({"rgb.forward"}, "rgb.step")
