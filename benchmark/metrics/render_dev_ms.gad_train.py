"""Stream ms a GAD step spends between the two CUDA events of `gad.render` (the
rasterizer's forward in `gad/train.camera_loss`): the device's work there
and any gap in which it waited for the host, summed under each `gad.step`
and averaged over the profiled steps (benchmark/lib/spans.py); nothing on
the CPU."""

from benchmark.lib import spans


def read(trace):
    return spans.per_root_ms({"gad.render"}, "gad.step", device=True)
