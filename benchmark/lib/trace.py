"""A profiled sub-window: torch.profiler over CPU and CUDA, reduced to the
numbers the per-layer readers take.

The profiler on the H100 can lose device records, more as a process
ages. Busy time is therefore the union of the kept records' intervals
plus, for every kernel launch the host made whose device record is
missing, the mean kept kernel record of launches from the same host
operation (a lost launch's kernel has no name; the operation that made
it does). Lost launches are listed by that operation. Busy time is not
cut at the window: where it comes out longer, the estimate is wrong and
the idle share reads nothing. Kernel means are taken per kept record,
so a lost record does not bias a kernel's mean.
"""

from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict

import torch

LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
               "cudaLaunchCooperativeKernel")
QUIET = LAUNCH_APIS + ("Activity Buffer Request",)


class Profiled:
    """Start, stop and summarise one profiled sub-window."""

    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        self.prof = profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> float:
        self._sync()
        self.window_s = time.perf_counter() - self.t0
        self.prof.stop()
        return self.window_s

    def summary(self) -> dict:
        """kernels {name: [records kept, device seconds]}, device ops
        (kernels, copies, sets) likewise, the union of device intervals,
        launch API calls, and the device's idle time by the host operation
        under way (the top 10 of each)."""
        from torch.autograd import DeviceType

        dev_iv, cpu_ev = [], []
        kernels = defaultdict(lambda: [0, 0.0])
        ops = defaultdict(lambda: [0, 0.0])
        launches = {}  # id of a host op event -> [the event, launch API calls under it]
        t_base = None
        for e in self.prof.events():
            s, t = e.time_range.start, e.time_range.end
            t_base = s if t_base is None else min(t_base, s)
            if e.device_type == DeviceType.CUDA:
                dur = max(t - s, 0) * 1e-6
                ops[e.name][0] += 1
                ops[e.name][1] += dur
                low = e.name.lower()
                if not (low.startswith("memcpy") or low.startswith("memset")):
                    kernels[e.name][0] += 1
                    kernels[e.name][1] += dur
                dev_iv.append((s, t))
            else:
                if e.name in LAUNCH_APIS:
                    launches.setdefault(id(e.cpu_parent), [e.cpu_parent, 0])[1] += 1
                cpu_ev.append((s, t, e.name))
        t_base = t_base or 0
        window_us = self.window_s * 1e6
        union, gaps = 0.0, []
        cur = 0.0
        for s, t in sorted((s - t_base, t - t_base) for s, t in dev_iv):
            if s > cur:
                gaps.append((cur, s))
            if t > cur:
                union += t - max(s, cur)
                cur = t
        if window_us > cur:
            gaps.append((cur, window_us))
        kept = sum(v[0] for v in kernels.values())
        kernel_s = sum(v[1] for v in kernels.values())
        # the profiler hangs each kept kernel record on the host op whose
        # launch made it (FunctionEvent.kernels): an op's launches less its
        # records are the records lost
        by_op = defaultdict(lambda: [0, 0, 0.0])  # host op: lost, kept, kept seconds
        for op, n in launches.values():
            ks = [k.duration * 1e-6 for k in getattr(op, "kernels", ())
                  if not k.name.lower().startswith(("memcpy", "memset"))]
            v = by_op[op.name if op is not None else "(none)"]
            v[0] += max(n - len(ks), 0)
            v[1] += len(ks)
            v[2] += sum(ks)
        n_launch = sum(n for _, n in launches.values())
        if sum(v[0] for v in by_op.values()) != max(n_launch - kept, 0):
            # records not hung where their launches are: the lost ones cannot
            # be told apart, so each counts at the mean kept kernel record
            by_op = defaultdict(lambda: [0, 0, 0.0])
            by_op["(unlinked)"][0] = max(n_launch - kept, 0)
        lost = {op: v[0] for op, v in by_op.items() if v[0]}
        fill = sum(n * (by_op[op][2] / by_op[op][1] if by_op[op][1] else
                        (kernel_s / kept if kept else 0.0)) for op, n in lost.items())
        busy = union * 1e-6 + fill
        # each idle span is put down to the host operation that began
        # last before it ended: what the host was doing while the card ran dry
        named = sorted((s - t_base, n) for s, t, n in cpu_ev if n not in QUIET)
        starts = [x[0] for x in named]
        by_host = defaultdict(float)
        for g0, g1 in gaps:
            i = bisect.bisect_right(starts, g1) - 1
            by_host[named[i][1] if i >= 0 else "(no host op)"] += (g1 - g0) * 1e-6
        return dict(
            window_s=self.window_s, busy_s=busy, union_s=union * 1e-6,
            lost_by_op=sorted(([k, v] for k, v in lost.items()), key=lambda x: -x[1])[:10],
            kernels={k: list(v) for k, v in kernels.items()},
            device_ops=sorted(([k, v[1]] for k, v in ops.items()), key=lambda x: -x[1])[:10],
            idle_gaps=sorted(([k, v] for k, v in by_host.items()), key=lambda x: -x[1])[:10],
            records_kept=kept, launch_calls=n_launch)


def kernel_mean_s(summary: dict, symbol: str):
    """Mean device seconds per kept record of the kernels named `symbol`
    (any template arguments and signature, as "void name<...>(...)");
    None where no record was kept."""
    pat = re.compile(r"(?:^|[\s:])" + re.escape(symbol) + r"(?:[<(]|$)")
    n, s = 0, 0.0
    for name, (cnt, sec) in summary["kernels"].items():
        if pat.search(name):
            n += cnt
            s += sec
    return s / n if n else None


def idle_pct(trace: dict):
    """The device's idle share of the profiled window, in %; None where
    busy time is not above 0 or comes out longer than the window."""
    s = trace["summary"]
    if not 0 < s["busy_s"] <= s["window_s"]:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def roofline_pct(trace: dict, symbol: str):
    """The kernels named `symbol`: the least time their work can take on
    the traced inputs (trace["bounds_s"]) over their mean kept record, in
    %; None where either is missing."""
    mean = kernel_mean_s(trace["summary"], symbol)
    bound = trace.get("bounds_s", {}).get(symbol)
    if not mean or not bound:
        return None
    return 100.0 * bound / mean
