"""Is bf16 elementwise work twice as fast as f32? The H100 port of the TPU
probe scripts/vpu_probe.py.

`vpu_chain` runs the probe's 18-op elementwise chain (mul, add, min,
exp2) as one CUDA kernel pass (csrc/vpu_chain.cu), `vpu_chain_plain` as
eager PyTorch ops; both round once per op, so they agree bit for bit on
the card. At the TPU's (512, 256) block the pass moves 1 MiB and its time
is the launch floor, so `reps` applies the chain that many times in
registers: at RATE_SHAPE and RATE_REPS the pass is bound by arithmetic
and its time gives each type's elementwise rate.

  python -m gags_torch.probes.vpu_probe [--device cuda]
"""

from __future__ import annotations

import argparse
import ctypes

import torch

from gags_torch import _kernels, resolve_device
from gags_torch.probes import VPU_CHAIN_SRC, launch_counts
from gags_torch.splat.kernels import _aligned16, _dispatch, _ptr, _stream
from gags_torch.utils.timing import device_time_drain

R, C = 512, 256  # the TPU probe's block
RATE_SHAPE = (8192, 512)  # the shape the TPU probe's docstring names
RATE_REPS = 64
DTYPES = (torch.float32, torch.bfloat16)


def vpu_chain_plain(x: torch.Tensor, reps: int = 1) -> torch.Tensor:
    """The chain as eager torch ops, `reps` times; constants in x's dtype."""
    def k(v):
        return torch.tensor(v, dtype=x.dtype, device=x.device)

    one, half, m = k(1.0), k(0.5), k(-0.01)
    for _ in range(reps):
        a = x * half + one
        b = a * a - x
        c = torch.minimum(b, one)
        e = torch.exp2(-c)
        f = e * half - b
        g = e * f + a
        h = g * e + f
        i = h + b * c
        j = torch.exp2(i * m)
        x = j + c
    return x


def vpu_chain(x: torch.Tensor, reps: int = 1) -> torch.Tensor:
    """The chain over float32 or bfloat16 `x` of any shape, `reps` times:
    the plain version on the CPU, the CUDA kernel on the card."""
    if not _dispatch(x):
        return vpu_chain_plain(x, reps)
    if x.dtype not in DTYPES:
        raise TypeError(f"vpu_chain: float32 or bfloat16, got {x.dtype}")
    if reps < 1:
        raise ValueError("vpu_chain: reps >= 1")
    x = _aligned16(x.contiguous())
    out = torch.empty_like(x)
    lib = _kernels.load(VPU_CHAIN_SRC)
    fn = lib.gags_vpu_chain
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(_ptr(x), _ptr(out), x.numel(), reps, int(x.dtype == torch.bfloat16), _stream(x))
    _kernels.check(lib, err, "vpu_chain")
    launch_counts["vpu_chain"] += 1
    return out


def probe_input(shape, dtype, device, seed: int = 0) -> torch.Tensor:
    """U[0, 1) float32 from a seeded generator, cast to `dtype`."""
    gen = torch.Generator().manual_seed(seed)
    return torch.rand(shape, generator=gen).to(dtype).to(device)


def main(argv=None) -> dict:
    """Time the kernel at the TPU block (reps 1) and at RATE_SHAPE x
    RATE_REPS in both types; print µs a call and Gelem/s (element-chains
    a second), as the TPU probe prints them. Returns {label: seconds}."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    out = {}
    for shape, reps in (((R, C), 1), (RATE_SHAPE, RATE_REPS)):
        for dtype in DTYPES:
            x = probe_input(shape, dtype, dev)
            dt = device_time_drain(vpu_chain, x, reps, k=50, warmup=3)
            els = x.numel() * reps
            label = f"{str(dtype).split('.')[-1]} {shape[0]}x{shape[1]} reps={reps}"
            out[label] = dt
            print(f"{label}: {dt * 1e6:8.2f} us/call ({els / dt / 1e9:6.1f} Gelem/s)",
                  flush=True)
    return out


if __name__ == "__main__":
    main()
