"""gags_torch.splat.autotune on the CPU (force=True: the mechanics of
tests/test_autotune.py's cases), its persisted store, and utils.timing."""

import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch

from gags_torch.splat import autotune
from gags_torch.splat.autotune import autotune_config, load_persisted, persist
from gags_torch.splat.rasterizer import RasterizeConfig, rasterize
from gags_torch.utils.timing import device_time, device_time_drain

W, H, F = 64, 32, 40.0


def _scene(n, seed=0, cdim=16):
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n),
                      rng.uniform(3, 9, n)], 1).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(rng.normal(-1.8, 0.4, (n, 3))).astype(np.float32)
    op = rng.uniform(0.2, 0.95, n).astype(np.float32)
    col = rng.uniform(0, 1, (n, cdim)).astype(np.float32)
    vm = np.eye(4, dtype=np.float32)
    K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]], np.float32)
    return tuple(torch.as_tensor(a) for a in (means, quats, scales, op, col, vm, K))


def _render(sc, cfg):
    return rasterize(*sc, W, H, background=torch.zeros(sc[4].shape[1]), config=cfg,
                     device="cpu")


def test_autotune_picks_parity_guarded_config():
    sc = _scene(120, 3)
    base = RasterizeConfig(tile_h=8, tile_w=16, chunk=8, budget_factor=1, aligned=False,
                           fast_color_rows=True)
    timings = {}
    cfg = autotune_config(*sc, W, H, base=base, force=True, cache=False, k=2,
                          timings=timings, device="cpu")
    assert isinstance(cfg, RasterizeConfig) and not cfg.aligned
    assert cfg.budget_factor > 1  # grown until the frame has no overflow
    assert set(timings) == {"base", "fused_keys", "winner"}
    assert timings["winner"] in ("base", "fused_keys") and timings["base"] > 0
    # the winner renders overflow-free and equals the (budget-grown) base
    # bit for bit: every exact variant is exact
    res = _render(sc, cfg)
    assert int(res.overflow) == 0
    ref = _render(sc, dataclasses.replace(cfg, fused_keys=False))
    assert torch.equal(res.image, ref.image)


def test_autotune_cpu_returns_base_without_force():
    sc = _scene(60, 1)
    base = RasterizeConfig(tile_h=8, tile_w=16, chunk=8, aligned=False)
    assert autotune_config(*sc, W, H, base=base, cache=False, device="cpu") == base


def test_autotune_bf16_variants_within_contract():
    sc = _scene(150, 4)
    base = RasterizeConfig(tile_h=8, tile_w=16, chunk=8, budget_factor=6, aligned=False,
                           fast_color_rows=True)
    timings = {}
    cfg = autotune_config(*sc, W, H, base=base, allow_bf16=True, force=True, cache=False,
                          k=1, timings=timings, device="cpu")
    assert {"blend_bf16", "blend_bf16,fused_keys"} <= set(timings)
    ref = _render(sc, base).image
    assert float((_render(sc, cfg).image - ref).abs().max()) <= 5e-2 * float(ref.abs().max())


def test_autotune_candidate_failure_raises(monkeypatch):
    """Only a parity rejection skips a candidate; a failing kernel raises."""
    sc = _scene(60, 2)
    real = autotune.rasterize

    def broken(*a, config, **kw):
        if config.fused_keys:
            raise RuntimeError("gags_torch: expand_keys launch failed")
        return real(*a, config=config, **kw)

    monkeypatch.setattr(autotune, "rasterize", broken)
    base = RasterizeConfig(tile_h=8, tile_w=16, chunk=8, budget_factor=6, aligned=False)
    with pytest.raises(RuntimeError, match="expand_keys"):
        autotune_config(*sc, W, H, base=base, force=True, cache=False, k=1, device="cpu")


def test_autotune_rejects_a_variant_that_breaks_parity(monkeypatch, capsys):
    sc = _scene(60, 2)
    real = autotune.rasterize

    def off(*a, config, **kw):
        res = real(*a, config=config, **kw)
        return res._replace(image=res.image + 1.0) if config.fused_keys else res

    monkeypatch.setattr(autotune, "rasterize", off)
    base = RasterizeConfig(tile_h=8, tile_w=16, chunk=8, budget_factor=6, aligned=False)
    timings = {}
    cfg = autotune_config(*sc, W, H, base=base, force=True, cache=False, k=1, verbose=True,
                          timings=timings, device="cpu")
    assert cfg == base and set(timings) == {"base", "winner"}
    assert "fused_keys parity" in capsys.readouterr().out


def test_persisted_store_round_trip(tmp_path, monkeypatch):
    store = tmp_path / "tune.json"
    monkeypatch.setattr(autotune, "PERSIST_PATH", store)
    assert load_persisted(1280, 720, 1000, 16) is None
    won = RasterizeConfig(aligned=False, fused_keys=True, blend_bf16=True,
                          fast_color_rows=True, budget_factor=2)
    persist(1280, 720, 1000, 16, won)
    (key, rec), = json.loads(store.read_text()).items()
    assert key.startswith("1280x720_n1000_c16_cuda_") and rec == dataclasses.asdict(won)
    exact = load_persisted(1280, 720, 1000, 16)
    assert exact == dataclasses.replace(won, blend_bf16=False, fast_color_rows=False,
                                        budget_factor=3.0)
    lossy = load_persisted(1280, 720, 1000, 16, allow_bf16=True)
    assert lossy.blend_bf16 and lossy.fast_color_rows and lossy.fused_keys
    assert load_persisted(1920, 1080, 1000, 16) is None
    # JAX-only fields of a record are dropped
    rec["mxu_sigma"] = True
    store.write_text(json.dumps({key: rec}))
    assert load_persisted(1280, 720, 1000, 16) == exact
    store.write_text("{not json")
    assert load_persisted(1280, 720, 1000, 16) is None


def test_fingerprint_covers_python_and_cuda_sources(tmp_path, monkeypatch):
    """A kernel source change invalidates the stored winners."""
    copy = tmp_path / "splat"
    shutil.copytree(autotune.SPLAT_DIR, copy, ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(autotune, "SPLAT_DIR", copy)
    fp0 = autotune._splat_fingerprint()
    cu = copy / "csrc" / "expand_keys.cu"
    cu.write_text(cu.read_text() + "\n// edited\n")
    fp1 = autotune._splat_fingerprint()
    hdr = copy / "csrc" / "blend_common.cuh"
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    fp2 = autotune._splat_fingerprint()
    py = copy / "tiles.py"
    py.write_text(py.read_text() + "\n# edited\n")
    assert len({fp0, fp1, fp2, autotune._splat_fingerprint()}) == 4


def test_timing_on_cpu_uses_the_host_clock():
    x = torch.ones(1000)
    calls = []

    def fn(t):
        calls.append(1)
        return t * 2

    assert device_time_drain(fn, x, k=3, warmup=2) > 0
    assert len(calls) == 5
    assert device_time(fn, x, k=4, warmup=1) > 0
    assert len(calls) == 10
