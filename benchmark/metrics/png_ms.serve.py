"""Median over requests of the host time in the server's PNG encoder
(utils/image.encode_png, the heat map and the mask of one reply), from
a wrapper the benchmark puts around it as cli/serve.py calls it."""

import statistics


def read(trace):
    v = trace.get("spans", {}).get("png_s")
    return statistics.median(v) * 1e3 if v else None
