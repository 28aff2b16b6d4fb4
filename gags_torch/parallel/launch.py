"""Run a function on several ranks, one process each, and collect results.

`spawn(fn, nprocs, backend, device)` starts `nprocs` processes with the
spawn method; each joins one torch.distributed process group through a
file rendezvous in a fresh temporary directory (no fixed port, so several
groups can run side by side), calls `fn(ctx, *args)` and writes what it
returns, with its kernel launch counts, beside the rendezvous file. The
caller waits with a deadline: when it passes, or when a rank fails, the
other ranks are killed and `spawn` raises, so a hung collective fails its
caller instead of hanging it. Results come back on the CPU.

The backend is the caller's choice and nothing replaces it:

  gloo, device "cpu"   every rank on the CPU;
  nccl, device "cuda"  rank r on card r, one rank per card (raises when
                       there are fewer cards than ranks);
  gloo, device "cuda"  ranks share the cards, rank r on card
                       r % device_count; CUDA tensors go through gloo
                       (collectives.py). Printed, since it is no speed-up.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from gags_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class RankContext:
    rank: int
    world_size: int
    device: torch.device


def check_backend(nprocs: int, backend: str, device) -> torch.device:
    """The device the ranks run on, after refusing what cannot run:
    NCCL with fewer cards than ranks or off the card, gloo on a device
    that is neither the CPU nor CUDA."""
    dev = torch.device(device)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"the nccl backend needs device 'cuda', got {dev}")
        cards = torch.cuda.device_count()
        if cards < nprocs:
            raise RuntimeError(
                f"{nprocs} ranks over nccl need one card each, but only {cards} CUDA "
                "devices are visible; ranks that share a card need backend 'gloo'")
    elif backend != "gloo":
        raise ValueError(f"unsupported backend {backend!r} (gloo or nccl)")
    return resolve_device(dev)


def _rank_device(dev: torch.device, rank: int) -> torch.device:
    if dev.type == "cpu":
        return dev
    return torch.device("cuda", rank % torch.cuda.device_count())


def _entry(rank: int, fn, nprocs: int, backend: str, device: str, workdir: str,
           args: tuple) -> None:
    out = os.path.join(workdir, f"rank{rank}.pt")
    try:
        # one intra-op thread a rank: the ranks of several groups may share
        # the host's cores (a test run's workers each start a group)
        torch.set_num_threads(1)
        dev = _rank_device(torch.device(device), rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"file://{workdir}/rendezvous",
                                world_size=nprocs, rank=rank)
        try:
            result = fn(RankContext(rank, nprocs, dev), *args)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        finally:
            dist.destroy_process_group()
        from gags_torch.splat import kernels

        blob = dict(ok=True, result=result, launch_counts=dict(kernels.launch_counts))
    except BaseException:
        blob = dict(ok=False, error=traceback.format_exc())
    torch.save(blob, out + ".tmp")
    os.replace(out + ".tmp", out)
    if not blob["ok"]:
        raise SystemExit(1)


@dataclasses.dataclass
class RankResult:
    result: Any
    launch_counts: dict


def spawn(fn: Callable, nprocs: int, backend: str, device="cuda", args: Sequence = (),
          deadline: Optional[float] = 600.0) -> list[RankResult]:
    """Run `fn(ctx, *args)` on `nprocs` ranks; returns each rank's result
    and kernel launch counts, in rank order. `fn` and `args` are pickled
    (fn by its import path). Raises when a rank fails, naming it with its
    traceback, or when `deadline` seconds pass (None: no limit, for a
    training run); either way no rank is left running."""
    dev = check_backend(nprocs, backend, device)
    if dev.type == "cuda":
        from gags_torch import _kernels
        from gags_torch.splat import kernels

        _kernels.build(list(kernels.SOURCES))  # once here, not once a rank
        if backend == "gloo":
            print(f"spawn: {nprocs} ranks share {torch.cuda.device_count()} card(s) over "
                  "gloo (CUDA tensors through gloo; no speed-up figure)", flush=True)
    workdir = tempfile.mkdtemp(prefix="gags_torch_ranks_")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(r, fn, nprocs, backend, str(dev), workdir,
                                              tuple(args)), daemon=True)
             for r in range(nprocs)]
    started = []
    try:
        for p in procs:
            p.start()
            started.append(p)
        t_end = None if deadline is None else time.monotonic() + deadline
        while any(p.exitcode is None for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            if t_end is not None and time.monotonic() > t_end:
                raise TimeoutError(
                    f"spawn: ranks {[r for r, p in enumerate(procs) if p.exitcode is None]} "
                    f"of {nprocs} still running after {deadline:.0f} s; killed")
            time.sleep(0.02)
        errors = []
        for r, p in enumerate(procs):
            if p.exitcode not in (None, 0):
                path = os.path.join(workdir, f"rank{r}.pt")
                msg = (torch.load(path, weights_only=False)["error"] if os.path.exists(path)
                       else f"exit code {p.exitcode}")
                errors.append(f"rank {r}:\n{msg}")
        if errors:
            raise RuntimeError("spawn: a rank failed\n" + "\n".join(errors))
        out = []
        for r in range(nprocs):
            blob = torch.load(os.path.join(workdir, f"rank{r}.pt"), map_location="cpu",
                              weights_only=False)
            out.append(RankResult(blob["result"], blob["launch_counts"]))
        return out
    finally:
        for p in started:
            if p.is_alive():
                p.kill()
        for p in started:
            p.join(timeout=30)
        shutil.rmtree(workdir, ignore_errors=True)
