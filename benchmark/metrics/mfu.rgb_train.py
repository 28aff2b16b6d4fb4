"""The RGB step's counted operations (K1's forward blend and K8's
backward by the blends' rule on the profiled steps' own pair counts, and
SSIM's separable filtering forward and backward; benchmark/counts/
ops.py) over the mean time of the steps a traced run times just before
it profiles, as a share of the float32 peak."""

from benchmark.counts.ops import PEAK_F32_FLOPS


def read(trace):
    if not trace.get("step_s") or not trace.get("flops_per_unit"):
        return None
    return 100.0 * trace["flops_per_unit"] / trace["step_s"] / PEAK_F32_FLOPS
