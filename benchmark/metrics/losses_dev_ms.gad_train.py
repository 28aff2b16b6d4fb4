"""Stream ms a GAD step spends between the two CUDA events of `gad.losses`
(mixed segmentation, supervision L1, region losses (K4) and entropy in
`gad/train._supervision_losses`): the device's work there and any gap in
which it waited for the host, summed under each `gad.step` and averaged over
the profiled steps (benchmark/lib/spans.py); nothing on the CPU."""

from benchmark.lib import spans


def read(trace):
    return spans.per_root_ms({"gad.losses"}, "gad.step", device=True)
