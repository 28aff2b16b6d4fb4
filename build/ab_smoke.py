"""Time kernels built from other trees' sources against this checkout's,
on chip_smoke.py's own phases and data.

    git archive <commit> | tar -x -C build/parent     # e.g. the parent
    python3 build/ab_smoke.py build/parent blend_backward_full blend_backward
    python3 build/ab_smoke.py build/parent,build/alt blend_backward   # several trees

The first argument is one or more other trees of this repo, separated by
commas, each further one the stem of a source under
gags_torch/splat/csrc/. chip_smoke.main() runs as it always does.
Wherever it times a call by device time (chip_smoke.device_ms) and that
call loads one of the named sources, the call is timed again in turns
(checkout, the trees in order, the trees in reverse order, checkout),
with a tree's wrappers (its gags_torch/splat/kernels.py, loaded as a
module of its own, driving its own csrc sources) in place of the
checkout's for that tree's turns, and each tree's outputs are compared
with the checkout's. So a kernel whose C interface changed is timed
against its parent all the same. Prints one "# A/B ..." line per such
call, just before the smoke's own line for it (`identical`: a tree's
outputs equal the checkout's bit for bit), and after the smoke's last
line one {"ab": [...]} line. Exits 1 unless the smoke passed, some
call was compared and every comparison agreed.
"""

from __future__ import annotations

import contextlib
import importlib.util
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


def _wrappers(tree: Path, name: str):
    """tree's gags_torch/splat/kernels.py as a module of its own: its CSRC
    is tree's csrc; it builds through this checkout's _kernels."""
    spec = importlib.util.spec_from_file_location(
        name, tree / "gags_torch" / "splat" / "kernels.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    if len(sys.argv) < 3:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is False: this needs a CUDA card")
    trees = [Path(t).resolve() for t in sys.argv[1].split(",")]
    stems = set(sys.argv[2:])
    ours = [name for name in dir(kernels)
            if name.endswith("_SRC") and getattr(kernels, name).stem in stems]
    if {getattr(kernels, name).stem for name in ours} != stems:
        raise SystemExit(f"no source in gags_torch/splat/csrc for {sorted(stems)}")
    # per tree, the functions both wrapper modules define (the callers look
    # them up in the module at call time): (the checkout's, the tree's)
    swaps = {}
    for i, tree in enumerate(trees):
        theirs = _wrappers(tree, f"ab_other_kernels_{i}")
        swaps[tree.name] = {name: (getattr(kernels, name), f) for name, f in vars(theirs).items()
                            if callable(f) and getattr(f, "__module__", None) == theirs.__name__
                            and callable(getattr(kernels, name, None))}
        for log in _kernels.build([getattr(theirs, name) for name in ours]).values():
            for line in chip_smoke.ptxas_summary(log):
                print(f"#   {tree.name}: {line}", flush=True)

    loaded: set[str] = set()
    load = _kernels.load

    def recording_load(source):
        loaded.add(Path(source).stem)
        return load(source)

    _kernels.load = recording_load

    @contextlib.contextmanager
    def using(tree):
        for name, (_, f) in swaps[tree].items():
            setattr(kernels, name, f)
        try:
            yield
        finally:
            for name, (f, _) in swaps[tree].items():
                setattr(kernels, name, f)

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
        out_ours = _tensors(fn())
        scale = max(float(b.double().abs().max()) for b in out_ours)
        diff = {}
        for tree in swaps:
            with using(tree):
                out = _tensors(fn())
            diff[tree] = max(float((a.double() - b.double()).abs().max())
                             for a, b in zip(out, out_ours))
        turns = {"checkout": []}
        for tree in ["checkout", *swaps, *reversed(swaps), "checkout"]:
            with using(tree) if tree != "checkout" else contextlib.nullcontext():
                turns.setdefault(tree, []).append(timed(fn, iters))
        mean = {k: sum(v) / len(v) for k, v in turns.items()}
        r = dict(sources=hit, caller=f"{caller.f_code.co_name}:{caller.f_lineno}", locals=where,
                 checkout_ms=mean["checkout"], other_ms={t: mean[t] for t in swaps},
                 turns=turns, max_abs_diff=diff, max_abs=scale,
                 identical={t: d == 0 for t, d in diff.items()},
                 agree=all(d <= AGREE_RTOL * scale for d in diff.values()))
        print(f"# A/B {r}", flush=True)
        results.append(r)
        return ms

    chip_smoke.device_ms = device_ms_ab
    rc = chip_smoke.main()
    print(json.dumps({"ab": results, "other": [str(t) for t in trees],
                      "gpu": chip_smoke.gpu_line()}))
    return rc if results and all(r["agree"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
