"""Kernel launches the host makes per RGB step: the CUDA launch API calls
on the CPU side of the profiled steps (complete even where the device
record of a launch is lost), over the steps."""


def read(trace):
    n = trace["summary"]["launch_calls"]
    if not n or not trace.get("units"):
        return None
    return n / trace["units"]
