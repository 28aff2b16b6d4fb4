"""Median host time of SceneServer.relevancy per request (the render,
decode, relevancy, the device-to-host copies, turbo and both PNGs,
behind the server's device lock), from a wrapper the benchmark puts
around the method."""

import statistics


def read(trace):
    v = trace.get("spans", {}).get("handler_s")
    return statistics.median(v) * 1e3 if v else None
