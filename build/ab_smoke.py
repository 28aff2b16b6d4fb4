"""Time kernels built from another tree's sources against this checkout's,
on chip_smoke.py's own phases and data.

    git archive <commit> | tar -x -C build/parent     # e.g. the parent
    python3 build/ab_smoke.py build/parent sorted_segment_sum dense_segment_sum

The first argument is another tree of this repo, each further one the
stem of a source under gags_torch/splat/csrc/. chip_smoke.main() runs as
it always does. Wherever it times a call by device time
(chip_smoke.device_ms) and that call loads one of the named sources, the
call is timed again in turns (checkout, other, other, checkout), the
wrappers pointed at the other tree's source for the other's turns, and
the two versions' outputs are compared. Prints one "# A/B ..." line per
such call, just before the smoke's own line for it, and after the smoke's
last line one {"ab": [...]} line. Exits 1 unless the smoke passed, some
call was compared and every comparison agreed.
"""

from __future__ import annotations

import contextlib
import inspect
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from gags_torch import _kernels  # noqa: E402
from gags_torch.splat import kernels  # noqa: E402

AGREE_RTOL = 1e-4  # of the checkout's largest output value


def _tensors(out) -> list[torch.Tensor]:
    return [out] if torch.is_tensor(out) else [t for t in out if torch.is_tensor(t)]


def main() -> int:
    if len(sys.argv) < 3:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is False: this needs a CUDA card")
    other, stems = Path(sys.argv[1]).resolve(), set(sys.argv[2:])
    ours = {name: getattr(kernels, name) for name in dir(kernels)
            if name.endswith("_SRC") and getattr(kernels, name).stem in stems}
    if {p.stem for p in ours.values()} != stems:
        raise SystemExit(f"no source in gags_torch/splat/csrc for {sorted(stems)}")
    theirs = {name: other / p.relative_to(ROOT) for name, p in ours.items()}
    for log in _kernels.build(list(theirs.values())).values():
        for line in chip_smoke.ptxas_summary(log):
            print(f"#   {other.name}: {line}", flush=True)

    loaded: set[str] = set()
    load = _kernels.load

    def recording_load(source):
        loaded.add(Path(source).stem)
        return load(source)

    _kernels.load = recording_load

    @contextlib.contextmanager
    def other_sources():
        for name, p in theirs.items():
            setattr(kernels, name, p)
        try:
            yield
        finally:
            for name, p in ours.items():
                setattr(kernels, name, p)

    results = []
    timed = chip_smoke.device_ms

    def device_ms_ab(fn, iters: int = 20) -> float:
        loaded.clear()
        ms = timed(fn, iters)
        hit = sorted(loaded & stems)
        if not hit:
            return ms
        caller = inspect.currentframe().f_back
        where = {k: v for k, v in caller.f_locals.items()
                 if type(v) in (int, str) and len(str(v)) < 40}
        with other_sources():
            out_other = _tensors(fn())
        out_ours = _tensors(fn())
        diff = max(float((a.double() - b.double()).abs().max()) for a, b in zip(out_other, out_ours))
        scale = max(float(b.double().abs().max()) for b in out_ours)
        turns = {"checkout": [], "other": []}
        for k in ("checkout", "other", "other", "checkout"):
            with other_sources() if k == "other" else contextlib.nullcontext():
                turns[k].append(timed(fn, iters))
        r = dict(sources=hit, caller=f"{caller.f_code.co_name}:{caller.f_lineno}", locals=where,
                 checkout_ms=sum(turns["checkout"]) / 2, other_ms=sum(turns["other"]) / 2,
                 turns=turns, max_abs_diff=diff, max_abs=scale,
                 agree=diff <= AGREE_RTOL * scale)
        print(f"# A/B {r}", flush=True)
        results.append(r)
        return ms

    chip_smoke.device_ms = device_ms_ab
    rc = chip_smoke.main()
    print(json.dumps({"ab": results, "other": str(other), "gpu": chip_smoke.gpu_line()}))
    return rc if results and all(r["agree"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
