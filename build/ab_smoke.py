"""Time kernels built from other trees' sources against this checkout's,
on chip_smoke.py's own phases and data.

    git archive <commit> | tar -x -C build/parent     # e.g. the parent
    python3 build/ab_smoke.py build/parent blend_backward_full blend_backward
    python3 build/ab_smoke.py build/parent,build/alt blend_backward   # several trees
    python3 build/ab_smoke.py build/parent vpu_chain slab_chain       # the probes

The first argument is one or more other trees of this repo, separated by
commas, each further one the stem of a source under
gags_torch/splat/csrc/ or gags_torch/probes/csrc/. chip_smoke.main() runs
as it always does. Wherever it times a call by device time
(chip_smoke.device_ms) and that call loads one of the named sources, the
call is timed again in turns (checkout, the trees in order, the trees in
reverse order, checkout), with a tree's wrappers in place of the
checkout's for that tree's turns, and each tree's outputs are compared
with the checkout's. A tree's wrappers are its gags_torch/splat/kernels.py
and its gags_torch/probes/{vpu_probe,slab_probe}.py (with its
gags_torch/probes/__init__.py), loaded as modules of their own that drive
the tree's own csrc sources, so a kernel whose C interface changed is
timed against its parent all the same. Prints one "# A/B ..." line per
such call, just before the smoke's own line for it (`identical`: a
tree's outputs equal the checkout's bit for bit), and after the smoke's
last line one {"ab": [...]} line. Exits 1 unless the smoke passed, some
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
from gags_torch import _kernels, probes  # noqa: E402
from gags_torch.probes import slab_probe, vpu_probe  # noqa: E402
from gags_torch.splat import kernels  # noqa: E402

AGREE_RTOL = 1e-4  # of the checkout's largest output value
# the checkout's wrapper modules, by their file in a tree
WRAPPERS = {"gags_torch/splat/kernels.py": kernels,
            "gags_torch/probes/vpu_probe.py": vpu_probe,
            "gags_torch/probes/slab_probe.py": slab_probe}


def _tensors(out) -> list[torch.Tensor]:
    return [out] if torch.is_tensor(out) else [t for t in out if torch.is_tensor(t)]


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def _wrappers(tree: Path, tag: str) -> dict:
    """tree's wrapper modules, {file in WRAPPERS: module}, each a module of
    its own whose sources are tree's csrc; they build through this
    checkout's _kernels. The probe wrappers import their package and each
    other by name, so those names point at tree's modules while they load."""
    out = {"gags_torch/splat/kernels.py": _module(tree / "gags_torch/splat/kernels.py",
                                                  f"ab_{tag}_kernels")}
    names = ("gags_torch.probes", "gags_torch.probes.vpu_probe", "gags_torch.probes.slab_probe")
    saved = {n: sys.modules[n] for n in names}
    try:
        sys.modules[names[0]] = _module(tree / "gags_torch/probes/__init__.py",
                                        f"ab_{tag}_probes")
        for n, f in zip(names[1:], ("vpu_probe.py", "slab_probe.py")):
            sys.modules[n] = out[f"gags_torch/probes/{f}"] = _module(
                tree / "gags_torch/probes" / f, f"ab_{tag}_{f[:-3]}")
    finally:
        sys.modules.update(saved)
    return out


def _sources(mod) -> dict:
    """{stem: path} of the csrc sources a wrapper module names as *_SRC."""
    return {getattr(mod, n).stem: getattr(mod, n) for n in dir(mod) if n.endswith("_SRC")}


def install(trees: list[Path], stems: set[str]) -> list:
    """Route chip_smoke.device_ms through the A/B turns for calls that load
    one of `stems`; returns the list the results are appended to."""
    ours = {p.stem for p in (*kernels.SOURCES, *probes.SOURCES)}
    if not stems <= ours:
        raise SystemExit(f"no source in gags_torch/splat/csrc or gags_torch/probes/csrc for "
                         f"{sorted(stems - ours)}")
    # per tree, the functions both wrapper modules define (the callers look
    # them up in the module at call time): (module, name, the checkout's, the tree's)
    swaps = {}
    for i, tree in enumerate(trees):
        theirs = _wrappers(tree, str(i))
        swaps[tree.name] = [
            (WRAPPERS[f], name, getattr(WRAPPERS[f], name), fn)
            for f, mod in theirs.items() for name, fn in vars(mod).items()
            if callable(fn) and getattr(fn, "__module__", None) == mod.__name__
            and callable(getattr(WRAPPERS[f], name, None))]
        srcs = {}
        for mod in theirs.values():
            srcs.update(_sources(mod))
        for log in _kernels.build([srcs[s] for s in sorted(stems)]).values():
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
        for mod, name, _, f in swaps[tree]:
            setattr(mod, name, f)
        try:
            yield
        finally:
            for mod, name, f, _ in swaps[tree]:
                setattr(mod, name, f)

    results = []
    timed = chip_smoke.device_ms

    def device_ms_ab(fn, iters: int = 20, floor_ms: float = 0.0) -> float:
        loaded.clear()
        ms = timed(fn, iters, floor_ms)
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
                # the floor is the checkout's kernel's: another tree's may be lower
                turns.setdefault(tree, []).append(
                    timed(fn, iters, floor_ms if tree == "checkout" else 0.0))
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
    return results


def main() -> int:
    if len(sys.argv) < 3:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is False: this needs a CUDA card")
    trees = [Path(t).resolve() for t in sys.argv[1].split(",")]
    results = install(trees, set(sys.argv[2:]))
    rc = chip_smoke.main()
    print(json.dumps({"ab": results, "other": [str(t) for t in trees],
                      "gpu": chip_smoke.gpu_line()}))
    return rc if results and all(r["agree"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
