"""The inference options of gags_torch's rasterizer (fast_color_rows,
blend_bf16, block_exit, fused_keys, tile_cull) and rasterize_exit_stats,
against gags_tpu (Pallas in interpret mode) or its oracle, with the cases
of tests/test_pallas_rasterizer.py. The port runs its plain kernel
versions on the CPU."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gags_tpu.splat.projection import project_gaussians as jproj
from gags_tpu.splat.rasterizer import RasterizeConfig as JConfig
from gags_tpu.splat.rasterizer import rasterize as jrasterize
from gags_tpu.splat.rasterizer import rasterize_exit_stats as jexit_stats
from gags_tpu.splat.reference import rasterize_reference
from gags_torch.splat import kernels
from gags_torch.splat.rasterizer import RasterizeConfig, rasterize, rasterize_exit_stats

W, H, F = 64, 32, 40.0
BASE = dict(tile_h=8, tile_w=16, chunk=8, aligned=False)


def _scene(n, seed=0, cdim=3, width=W, height=H):
    """tests/test_pallas_rasterizer.py's _scene, as numpy arrays."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n),
                      rng.uniform(3, 9, n)], 1).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(rng.normal(-1.8, 0.4, size=(n, 3))).astype(np.float32)
    op = rng.uniform(0.2, 0.95, n).astype(np.float32)
    col = rng.uniform(0, 1, (n, cdim)).astype(np.float32)
    vm = np.eye(4, dtype=np.float32)
    K = np.array([[F, 0, width / 2], [0, F, height / 2], [0, 0, 1]], np.float32)
    return means, quats, scales, op, col, vm, K


def _port(sc, width=W, height=H, **cfg):
    return rasterize(*(torch.as_tensor(a) for a in sc), width, height,
                     config=RasterizeConfig(**{**BASE, **cfg}), device="cpu")


def _jax(sc, width=W, height=H, **cfg):
    return jrasterize(*(jnp.asarray(a) for a in sc), width, height,
                      config=JConfig(**{**BASE, "interpret": True, **cfg}))


def _oracle(sc, width=W, height=H):
    means, quats, scales, op, col, vm, K = (jnp.asarray(a) for a in sc)
    p = jproj(means, quats, scales, vm, K, width, height)
    img, alpha = rasterize_reference(p.means2d, p.conics, p.depths, p.radii, op, col,
                                     width, height)
    return np.asarray(img), np.asarray(alpha)


@pytest.mark.parametrize("n,cdim,seed", [(200, 3, 1), (120, 16, 2), (170, 8, 6)])
def test_fast_color_rows_matches_jax(n, cdim, seed):
    """bf16 colour rows against JAX's elementwise-sigma fast kernel with the
    same rows, at the unaligned forward's tolerance."""
    sc = _scene(n, seed, cdim)
    got = _port(sc, budget_factor=6, fast_color_rows=True)
    want = _jax(sc, budget_factor=6, fast_color_rows=True, mxu_sigma=False)
    np.testing.assert_allclose(got.image.numpy(), np.asarray(want.image), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(want.alpha), atol=2e-5)
    # and the rows really are bf16: the f32 image differs
    f32 = _port(sc, budget_factor=6)
    assert not torch.equal(f32.image, got.image)


@pytest.mark.parametrize("case", ["close_to_f32", "saturated_rgb"])
def test_blend_bf16_within_contract(case):
    """test_blend_bf16_close_to_f32 and test_blend_bf16_saturated_rgb: image
    max error <= 5e-2 and mean <= 5e-3 of the oracle's scale, alpha atol
    0.03 (the port keeps T in f32: tighter than the TPU's bf16 scan)."""
    if case == "close_to_f32":
        sc, bf = _scene(150, 3, 16), 6
    else:
        sc, bf = _scene(400, 7, 3), 8
        sc = sc[:3] + (np.minimum(sc[3] * 4.0, 0.98),) + sc[4:]
    ref, ref_alpha = _oracle(sc)
    res = _port(sc, budget_factor=bf, blend_bf16=True)
    img = res.image.numpy()
    scale = np.abs(ref).max()
    assert np.abs(img - ref).max() <= 0.05 * scale
    assert np.abs(img - ref).mean() <= 0.005 * scale
    np.testing.assert_allclose(res.alpha.numpy(), ref_alpha, atol=0.03)
    assert int(res.overflow) == 0
    # the weights really are rounded: the f32-weight image differs
    assert not torch.equal(res.image, _port(sc, budget_factor=bf, fast_color_rows=True).image)


def test_blend_bf16_plain_rounds_weights_and_colours():
    """blend_forward_plain's bf16 blend: colour rows and every weight are
    rounded to bf16 before an f32 multiply-add, alpha keeps the f32 T."""
    rng = np.random.default_rng(0)
    geom = torch.zeros((3, 8))
    geom[0, :6] = torch.tensor([8.0, 4.0, 0.02, 0.0, 0.02, 0.6])
    geom[1, :6] = torch.tensor([7.0, 5.0, 0.05, 0.01, 0.04, 0.7])
    colors = torch.as_tensor(rng.uniform(0, 1, (3, 4)).astype(np.float32))
    colors[2] = 0
    args = (geom, colors, torch.tensor([0, 1], dtype=torch.int32), torch.tensor([0]),
            torch.tensor([2]), torch.zeros(4), 1, 1, 8, 16)
    args = args[:3] + tuple(t.to(torch.int32) for t in args[3:5]) + args[5:]
    f32 = kernels.blend_forward_plain(*args)
    b16 = kernels.blend_forward_plain(*args, blend_bf16=True)
    torch.testing.assert_close(b16[..., -1], f32[..., -1], rtol=0, atol=0)
    w = torch.stack([s.w for s in kernels._walk_ranges(geom, *args[2:5], 1, 1, 8, 16)])
    cq = colors.to(torch.bfloat16).float()
    want = sum(w[k].to(torch.bfloat16).float()[..., None] * cq[k] for k in range(2))
    torch.testing.assert_close(b16[..., :4], want, rtol=0, atol=0)


@pytest.mark.parametrize("bf16,saturate", [(False, False), (True, False), (False, True),
                                           (True, True)])
def test_block_exit_bit_identical(bf16, saturate):
    sc = _scene(400, 11, 16)
    if saturate:
        sc = sc[:3] + (np.minimum(sc[3] * 5.0, 0.998),) + sc[4:]
    a = _port(sc, budget_factor=8, blend_bf16=bf16)
    b = _port(sc, budget_factor=8, blend_bf16=bf16, block_exit=True)
    assert torch.equal(a.image, b.image) and torch.equal(a.alpha, b.alpha)
    assert int(b.overflow) == 0


@pytest.mark.parametrize("cull", [False, True])
def test_fused_keys_end_to_end_image_bit_identical(cull):
    """test_fused_keys_end_to_end_image, and with the cull, which only drops
    instances that blend with alpha 0 (test_tile_cull_image_exact)."""
    sc = _scene(180, 9, 16)
    a = _port(sc, budget_factor=8, fast_color_rows=True)
    b = _port(sc, budget_factor=8, fast_color_rows=True, fused_keys=True, tile_cull=cull)
    assert torch.equal(a.image, b.image) and torch.equal(a.alpha, b.alpha)
    # and the fused, culled image matches JAX's
    j = _jax(sc, budget_factor=8, fast_color_rows=True, fused_keys=True, tile_cull=cull,
             mxu_sigma=False)
    np.testing.assert_allclose(b.image.numpy(), np.asarray(j.image), atol=2e-5, rtol=1e-4)


def test_tile_cull_image_exact():
    sc = _scene(200, 3, 8)
    on = _port(sc, budget_factor=8, tile_cull=True)
    off = _port(sc, budget_factor=8)
    assert int(on.overflow) == 0 and int(off.overflow) == 0
    assert torch.equal(on.image, off.image) and torch.equal(on.alpha, off.alpha)
    _, nv_on = rasterize_exit_stats(*(torch.as_tensor(a) for a in sc), W, H,
                                    config=RasterizeConfig(**BASE, budget_factor=8,
                                                           tile_cull=True), device="cpu")
    _, nv_off = rasterize_exit_stats(*(torch.as_tensor(a) for a in sc), W, H,
                                     config=RasterizeConfig(**BASE, budget_factor=8),
                                     device="cpu")
    assert int(nv_on) < int(nv_off)


# (n, seed, cdim, opacity override, width, height); at most FLIP_TILES tiles
# may move between the port's product of (1 - alpha) and JAX's sum of
# log2(1 - alpha) at the 1e-4 stop (an isolated threshold flip)
EXIT_CASES = [(400, 5, 16, None, 64, 32), (400, 5, 16, 0.999, 64, 32),
              (600, 8, 8, None, 128, 64), (1500, 3, 3, "x4", 64, 32)]
FLIP_TILES = 1


@pytest.mark.parametrize("n,seed,cdim,op_mode,width,height", EXIT_CASES)
def test_exit_stats_match_jax(n, seed, cdim, op_mode, width, height):
    """rasterize_exit_stats against JAX's (mxu_sigma=False, the elementwise
    kernel): lanes 1 and 3 (totals) exact; lanes 0 and 2 (done) exact apart
    from FLIP_TILES threshold-flip tiles; lane 4 (max log2 T) within 2e-3
    on tiles where some pixel never stops; num_valid exact."""
    sc = _scene(n, seed, cdim, width, height)
    if op_mode == 0.999:
        sc = sc[:3] + (np.full_like(sc[3], 0.999),) + sc[4:]
    elif op_mode == "x4":
        sc = sc[:3] + (np.minimum(sc[3] * 4.0, 0.98),) + sc[4:]
    cfg = dict(BASE, budget_factor=8, fast_color_rows=True)
    got, nv = rasterize_exit_stats(*(torch.as_tensor(a) for a in sc), width, height,
                                   config=RasterizeConfig(**cfg), device="cpu")
    want, jnv = jexit_stats(*(jnp.asarray(a) for a in sc), width, height,
                            config=JConfig(**cfg, interpret=True, mxu_sigma=False))
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape == ((width // 16) * (height // 8), 8, 128)
    assert int(nv) == int(jnv)
    assert not got[:, 1:].any() and not got[:, 0, 5:].any()
    np.testing.assert_array_equal(got[:, 0, 1], want[:, 0, 1])
    np.testing.assert_array_equal(got[:, 0, 3], want[:, 0, 3])
    moved = (got[:, 0, 2] != want[:, 0, 2]) | (got[:, 0, 0] != want[:, 0, 0])
    assert moved.sum() <= FLIP_TILES, np.nonzero(moved)
    open_tiles = (got[:, 0, 2] == got[:, 0, 3]) & (want[:, 0, 2] == want[:, 0, 3]) & \
        (got[:, 0, 4] >= np.log2(1e-4)) & (want[:, 0, 4] >= np.log2(1e-4))
    assert open_tiles.sum() > 0
    np.testing.assert_allclose(got[open_tiles, 0, 4], want[open_tiles, 0, 4], atol=2e-3)
    # done <= total, and every tile with instances does some work
    assert (got[:, 0, 0] <= got[:, 0, 1]).all() and (got[:, 0, 2] <= got[:, 0, 3]).all()
    assert ((got[:, 0, 3] > 0) == (got[:, 0, 2] > 0)).all()
    if op_mode == "x4":
        assert (got[:, 0, 2] < got[:, 0, 3]).sum() >= 2  # saturation ends tiles early


def test_exit_stats_leave_the_image_unchanged():
    sc = _scene(300, 4, 16)
    cfg = RasterizeConfig(**BASE, budget_factor=8)
    img = _port(sc, budget_factor=8).image
    stats, _ = rasterize_exit_stats(*(torch.as_tensor(a) for a in sc), W, H, config=cfg,
                                    device="cpu")
    assert stats.shape == (16, 8, 128) and torch.isfinite(stats).all()
    assert torch.equal(img, _port(sc, budget_factor=8).image)
    with pytest.raises(ValueError, match="unaligned"):
        rasterize_exit_stats(*(torch.as_tensor(a) for a in sc), W, H,
                             config=RasterizeConfig(tile_h=8, tile_w=16, chunk=8), device="cpu")
