"""On-device choice of the inference RasterizeConfig (port of
gags_tpu.splat.autotune).

Render once with each candidate variant, hold it to the base config's
image (1e-5 of the image's scale for exact variants, 5e-2 for the bf16
blend), time the survivors with CUDA events (utils.timing) and keep the
fastest, per (width, height, N, C) for the life of the process and in a
persisted store that later processes reuse (`load_persisted`).

Variants, those of the JAX package that mean something here:
`{}` and `{"fused_keys": True}` (K7 builds the binning's keys: an exact
variant), and with `allow_bf16` the same two with `blend_bf16`. The JAX
package's `chunk: 256` legs are dropped: in the port `chunk` is only the
instance list's tail padding, so they would time the same kernels twice.
`image_chw` and `soa_geom` are TPU layouts the port does not have.

A candidate whose kernel fails to build or launch raises: only a parity
rejection skips a candidate.

The store is `.gags_torch_tune_cache.json` at the root of the checkout,
in the JAX package's format ({key: asdict(config)}). A key carries the
render shape, the backend ("cuda") and a fingerprint of the port's splat
sources, gags_torch/splat/*.py and csrc/*.cu / *.cuh, so a changed kernel
never reuses an old winner.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import sys
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from gags_torch import resolve_device
from gags_torch.splat.rasterizer import RasterizeConfig, rasterize
from gags_torch.utils.timing import device_time_drain

SPLAT_DIR = Path(__file__).resolve().parent
PERSIST_PATH = SPLAT_DIR.parent.parent / ".gags_torch_tune_cache.json"
BACKEND = "cuda"

_CACHE: dict = {}

EXACT_VARIANTS: Sequence[dict] = (
    {},
    {"fused_keys": True},
)
# the bf16 blend trades ~1e-2 relative image error for half the colour
# bytes: only offered when the caller opts in (feature rendering and
# relevancy, not RGB evaluation)
BF16_VARIANTS: Sequence[dict] = tuple({**v, "blend_bf16": True} for v in EXACT_VARIANTS)


def _splat_fingerprint() -> str:
    h = hashlib.sha256()
    files = sorted(SPLAT_DIR.glob("*.py")) + sorted(
        p for p in (SPLAT_DIR / "csrc").iterdir() if p.suffix in (".cu", ".cuh"))
    for path in files:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _persist_key(width, height, n, c) -> str:
    return f"{width}x{height}_n{n}_c{c}_{BACKEND}_{_splat_fingerprint()}"


def _read_store() -> dict:
    try:
        with open(PERSIST_PATH) as f:
            return json.load(f)
    except FileNotFoundError:
        return {}
    except json.JSONDecodeError as exc:
        print(f"# tune cache {PERSIST_PATH} unreadable, ignored: {exc}", file=sys.stderr)
        return {}


def load_persisted(width, height, n, c, *, allow_bf16=False) -> Optional[RasterizeConfig]:
    """The persisted winner for this shape, or None.

    The stored winner may carry lossy flags (blend_bf16, fast_color_rows);
    callers that need exact output pass allow_bf16=False (the default) and
    get them stripped. A budget factor below 3 was verified overflow-free
    only on the scene it was tuned on, while the key is shape-only: it is
    raised to 3 for reuse, as in JAX.
    """
    rec = _read_store().get(_persist_key(width, height, n, c))
    if rec is None:
        return None
    fields = {f.name for f in dataclasses.fields(RasterizeConfig)}
    cfg = RasterizeConfig(**{k: v for k, v in rec.items() if k in fields})
    if not allow_bf16 and (cfg.blend_bf16 or cfg.fast_color_rows):
        cfg = dataclasses.replace(cfg, blend_bf16=False, fast_color_rows=False)
    if cfg.budget_factor < 3.0:
        cfg = dataclasses.replace(cfg, budget_factor=3.0)
    return cfg


def persist(width, height, n, c, cfg: RasterizeConfig) -> None:
    store = _read_store()
    store[_persist_key(width, height, n, c)] = dataclasses.asdict(cfg)
    try:
        with open(PERSIST_PATH, "w") as f:
            json.dump(store, f, indent=1)
    except OSError as exc:  # the store is a cache: a render goes on without it
        print(f"# tune cache write failed: {exc!r}", file=sys.stderr)


def _label(ov: dict) -> str:
    return ",".join(k for k in sorted(ov)) or "base"


def autotune_config(means, quats, scales, opacities, colors, viewmat, K, width: int,
                    height: int, *, base: Optional[RasterizeConfig] = None,
                    allow_bf16: bool = False, k: int = 8, cache: bool = True,
                    force: bool = False, verbose: bool = False,
                    timings: Optional[dict] = None, device="cuda") -> RasterizeConfig:
    """The fastest parity-guarded RasterizeConfig for this scene on `device`.

    The budget factor of the base first grows until the frame has no
    overflow (up to 8). Each variant renders once and is rejected when its
    max image error against the base exceeds its contract; the survivors
    are timed over `k` calls. On the CPU a time means nothing, so the base
    is returned unless `force`. `timings`, a dict, receives each timed
    variant's ms under its label ("base", "fused_keys", ...) and the
    winner's label under "winner".
    """
    dev = resolve_device(device)
    if base is None:
        # fast_color_rows is a precision trade: on in the base only for a
        # caller that opted into lossy variants
        base = RasterizeConfig(aligned=False, fast_color_rows=allow_bf16, budget_factor=3)
    n = int(means.shape[0])
    c = int(colors.shape[1])
    key = (width, height, n, c, allow_bf16, base, dev.type)
    if cache and key in _CACHE:
        return _CACHE[key]
    if dev.type == "cpu" and not force:
        return base
    if cache and not force:
        persisted = load_persisted(width, height, n, c, allow_bf16=allow_bf16)
        if persisted is not None:
            if verbose:
                print("# autotune: persisted winner reused", flush=True)
            _CACHE[key] = persisted
            return persisted

    bg = torch.zeros((c,), dtype=torch.float32, device=dev)

    def run(cfg):
        return rasterize(means, quats, scales, opacities, colors, viewmat, K, width, height,
                         background=bg, config=cfg, device=dev)

    res = run(base)
    while int(res.overflow) > 0 and base.budget_factor < 8:
        base = dataclasses.replace(base, budget_factor=base.budget_factor + 1)
        res = run(base)
    ref_img = res.image
    scale = float(ref_img.abs().max()) + 1e-8

    def timed(cfg):
        return device_time_drain(lambda: run(cfg).image, k=k, warmup=2)

    times = {"base": timed(base) * 1e3}
    best_cfg, best_t = base, times["base"]
    variants = list(EXACT_VARIANTS) + (list(BF16_VARIANTS) if allow_bf16 else [])
    for ov in variants:
        if not ov:
            continue
        cand = dataclasses.replace(base, **ov)
        tol = 5e-2 if ov.get("blend_bf16") else 1e-5
        rel = float((run(cand).image - ref_img).abs().max()) / scale
        if not (np.isfinite(rel) and rel <= tol):
            if verbose:
                print(f"# autotune: {_label(ov)} parity {rel:.3e} > {tol:g}: rejected",
                      flush=True)
            continue
        t = timed(cand) * 1e3
        times[_label(ov)] = t
        if verbose:
            print(f"# autotune: {_label(ov)} {t:.3f} ms (best {best_t:.3f})", flush=True)
        if t < best_t:
            best_cfg, best_t = cand, t
    if timings is not None:
        timings.update(times)
        timings["winner"] = next(lbl for lbl, t in times.items() if t == best_t)
    if cache:
        _CACHE[key] = best_cfg
        if dev.type != "cpu":
            persist(width, height, n, c, best_cfg)
    return best_cfg
