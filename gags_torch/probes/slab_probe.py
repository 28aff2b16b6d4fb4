"""Does a chain in row slabs beat the whole block? The H100 port of the TPU
probe scripts/slab_probe.py.

`slab_chain` runs the blend alpha chain (exp2, min, log1p, two selects)
REPS times as one CUDA kernel (csrc/slab_chain.cu). The TPU's grid-less
call ran on its whole core, so on the card every slab spreads the block
over all SMs (`launch_geometry`); the slab keeps the meaning the TPU probe
gave it, the rows carried through all REPS applications before the next
rows are loaded, here at most the rows of one thread block's pass
(None: no limit). At the TPU block (1024, 128) on 132 SMs a block owns
one row, so every slab launches the same grid. `slab_chain_plain` runs
the same chain as eager PyTorch ops, ~18 launches an application, one
slab after another. Every slab gives the same output, bit for bit.

  python -m gags_torch.probes.slab_probe [--device cuda]
"""

from __future__ import annotations

import argparse
import ctypes
from typing import NamedTuple, Optional

import torch

from gags_torch import _kernels, resolve_device
from gags_torch.probes import SLAB_CHAIN_SRC, launch_counts
from gags_torch.probes.vpu_probe import DTYPES, probe_input
from gags_torch.splat.kernels import _dispatch, _ptr, _stream
from gags_torch.utils.timing import device_time_drain

P, G = 1024, 128  # the TPU probe's block
REPS = 24  # chain applications a call
SLABS = (None, 256, 64, 32, 8)
H100_SMS = 132
BLOCKS_PER_SM = 8  # blocks a SM at most, so that the SMs' shares differ by one block
MAX_THREADS = 1024
MIN_ELEMS = 2  # elements a thread holds at least: two float32 chains or one bf16x2 pair
MAX_LANES = 4  # chains a thread carries interleaved


class Geometry(NamedTuple):
    blocks: int
    threads: int
    band_rows: int  # rows a block owns
    pass_rows: int  # rows a block carries through the REPS applications at once
    lanes: int  # chains a thread carries interleaved
    elems_per_chain: int  # 1 (float32) or 2 (a bf16x2 pair)

    @property
    def elems_per_thread(self) -> int:
        """Elements a thread holds at once (its register working set)."""
        return self.lanes * self.elems_per_chain


def launch_geometry(rows: int, cols: int, slab: Optional[int], bf16: bool,
                    sms: int = H100_SMS) -> Geometry:
    """P2's launch on a card of `sms` SMs. A block owns a band of whole
    rows and takes at least a warp of threads of MIN_ELEMS elements, so
    at most `possible` = min(rows, ceil(rows * cols / (32 * MIN_ELEMS)))
    blocks can have work; the bands are cut for min(possible,
    BLOCKS_PER_SM * sms) blocks or more, so every SM has a block whenever
    `possible` allows it. A block carries min(slab, band) rows at a time;
    its threads hold that pass's chains, MIN_ELEMS elements a thread, up
    to MAX_LANES chains interleaved a thread when it has more than
    MAX_THREADS."""
    per = 2 if bf16 else 1
    possible = min(rows, -(-rows * cols // (32 * MIN_ELEMS)))
    band = max(1, rows // min(possible, BLOCKS_PER_SM * sms))
    pass_rows = band if slab is None else max(1, min(slab, band))
    chains = -(-pass_rows * cols // per)
    lanes = MIN_ELEMS // per
    while chains > MAX_THREADS * lanes and lanes < MAX_LANES:
        lanes *= 2
    threads = min(MAX_THREADS, 32 * -(-chains // (32 * lanes)))
    return Geometry(-(-rows // band), threads, band, pass_rows, lanes, per)


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def chain_plain(x: torch.Tensor, lt: torch.Tensor) -> torch.Tensor:
    """One application: compares and log1p on the float32 extension, as
    the TPU probe runs them; every other op in x's dtype."""
    def k(v, dtype=x.dtype):
        return torch.tensor(v, dtype=dtype, device=x.device)

    zero = k(0.0)
    s2 = x * k(0.5) + k(1.0)
    alpha = torch.minimum(k(0.999), torch.exp2(-s2))
    live = alpha.float() >= k(1.0 / 255.0, torch.float32)
    alpha = torch.where(live, alpha, zero)
    l1m = torch.log1p(-alpha.float()).to(x.dtype)
    cum = l1m + lt
    include = cum.float() >= k(-8.0, torch.float32)
    w = torch.where(include, alpha * torch.exp2(cum - l1m), zero)
    return w + s2 * k(1e-3)


def slab_chain_plain(x: torch.Tensor, slab: Optional[int] = None,
                     reps: int = REPS) -> torch.Tensor:
    """(rows, cols) → the chain applied `reps` times, slab by slab."""
    rows = x.shape[0]
    step = slab or rows
    out = torch.empty_like(x)
    for r0 in range(0, rows, step):
        acc = x[r0:r0 + step]
        lt = torch.zeros((acc.shape[0], 1), dtype=x.dtype, device=x.device)
        for _ in range(reps):
            acc = chain_plain(acc, lt)
        out[r0:r0 + step] = acc
    return out


def slab_chain(x: torch.Tensor, slab: Optional[int] = None, reps: int = REPS) -> torch.Tensor:
    """The chain over a (rows, cols) float32 or bfloat16 block, `reps`
    times, at most `slab` rows carried at once: the plain version on the
    CPU, the CUDA kernel on the card (launched as `launch_geometry`
    says)."""
    if not _dispatch(x):
        return slab_chain_plain(x, slab, reps)
    if x.dtype not in DTYPES or x.dim() != 2:
        raise TypeError(f"slab_chain: a 2-d float32 or bfloat16 block, got {x.dtype} "
                        f"{tuple(x.shape)}")
    if reps < 1 or (slab is not None and slab < 1):
        raise ValueError("slab_chain: reps >= 1 and slab >= 1 (or None)")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _kernels.load(SLAB_CHAIN_SRC)
    fn = lib.gags_slab_chain
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rows, cols = x.shape
    bf16 = x.dtype == torch.bfloat16
    g = launch_geometry(rows, cols, slab, bf16, _sm_count(x.device))
    err = fn(_ptr(x), _ptr(out), rows, cols, g.blocks, g.threads, g.band_rows, g.pass_rows,
             g.lanes, reps, int(bf16), _stream(x))
    _kernels.check(lib, err, "slab_chain")
    launch_counts["slab_chain"] += 1
    return out


def main(argv=None) -> dict:
    """Time the kernel at the TPU block for every slab in both types;
    print µs a call and ps a pair-chain, as the TPU probe prints them.
    Returns {label: seconds}."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    out = {}
    for dtype in DTYPES:
        x = probe_input((P, G), dtype, dev)
        for slab in SLABS:
            dt = device_time_drain(slab_chain, x, slab, REPS, k=50, warmup=3)
            name = str(dtype).split(".")[-1]
            out[f"{name} slab={slab}"] = dt
            print(f"{name:9s} slab={str(slab):5s}: {dt * 1e6:8.2f} us/call "
                  f"({dt / (P * G * REPS) * 1e12:6.2f} ps/pair-chain)", flush=True)
    return out


if __name__ == "__main__":
    main()
