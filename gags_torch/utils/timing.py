"""Device timing (port of gags_tpu.utils.timing).

On a CUDA device a call is timed with two CUDA events around k calls
enqueued back to back, after a warm-up that ends in a synchronise: the
events are stamped by the device itself, so neither the host's enqueue
time nor a readback enters the figure (the JAX package's readback
subtraction and slope method exist for a high-latency remote TPU backend
and have no counterpart here). On the CPU the host clock times the same k
calls. `fn` returns a tensor or a tuple / list / dict of them; the first
call's output decides the device.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import torch


def _on_cuda(out: Any) -> bool:
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return any(_on_cuda(x) for x in out)
    return False


def device_time_drain(fn: Callable, *args, k: int = 30, warmup: int = 2) -> float:
    """Steady-state seconds per call of ``fn(*args)``: enqueue k calls
    between two CUDA events (the host clock on the CPU)."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    if not _on_cuda(out):
        t0 = time.perf_counter()
        for _ in range(k):
            fn(*args)
        return max((time.perf_counter() - t0) / k, 1e-9)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(k):
        fn(*args)
    end.record()
    end.synchronize()
    return max(start.elapsed_time(end) / 1e3 / k, 1e-9)


def device_time(fn: Callable, *args, k: int = 25, warmup: int = 2) -> float:
    """Seconds per call of ``fn(*args)`` over k calls: `device_time_drain`
    with the JAX package's default count (CUDA events need no slope)."""
    return device_time_drain(fn, *args, k=k, warmup=warmup)
