"""gags_torch inference rasterizer and the K5 plain version vs gags_tpu
(Pallas in interpret mode) and vs the port's own oracle.

Tolerance atol 2e-5 / rtol 1e-4, as tests/test_pallas_rasterizer.py holds
the JAX unaligned path to its oracle: the JAX kernel composites in log
space, the port multiplies T sequentially, so values agree to float32
rounding of the transmittance product."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gags_tpu.core.camera import Camera as JCamera
from gags_tpu.splat import pallas_kernel as pk
from gags_tpu.splat.rasterizer import RasterizeConfig as JConfig
from gags_tpu.splat.rasterizer import rasterize as jrasterize
from gags_tpu.splat.render import render as jrender
from gags_torch.core.camera import Camera as TCamera
from gags_torch.splat import kernels
from gags_torch.splat.rasterizer import RasterizeConfig, _prepare, order_ext, rasterize
from gags_torch.splat.projection import project_gaussians
from gags_torch.splat.reference import rasterize_reference
from gags_torch.splat.render import render

W, H, F = 64, 32, 40.0
ATOL, RTOL = 2e-5, 1e-4


def _scene(n, seed=0, cdim=3):
    rng = np.random.default_rng(seed)
    means = np.stack(
        [rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n), rng.uniform(3, 9, n)], 1
    ).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(rng.normal(-1.8, 0.4, size=(n, 3))).astype(np.float32)
    op = rng.uniform(0.2, 0.95, n).astype(np.float32)
    col = rng.uniform(0, 1, (n, cdim)).astype(np.float32)
    vm = np.eye(4, dtype=np.float32)
    K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]], np.float32)
    return means, quats, scales, op, col, vm, K


def _t(arrs):
    return [torch.as_tensor(a) for a in arrs]


@pytest.mark.parametrize("cdim,seed", [(3, 1), (16, 2)])
def test_blend_plain_matches_pallas_fast_kernel(cdim, seed):
    """Same gathered inputs into pk.tile_blend_forward_fast (elementwise
    sigma) and into the port's plain K5."""
    n = 150
    means, quats, scales, op, col, vm, K = _scene(n, seed, cdim)
    cfg = RasterizeConfig(tile_h=8, tile_w=16, chunk=8, budget_factor=6)
    m, q, s, o, c, v, k = _t((means, quats, scales, op, col, vm, K))
    proj, binned, geom, tx, ty = _prepare(m, q, s, o, v, k, W, H, cfg)
    perm = order_ext(binned.order.long())
    geom_p = geom[perm]
    col_p = torch.cat([c, torch.zeros((1, cdim))])[perm]
    bg = torch.as_tensor(np.linspace(0.1, 0.9, cdim).astype(np.float32))
    got = kernels.blend_forward(geom_p, col_p, binned.inst_gid, binned.tile_starts,
                                binned.tile_counts, bg, tx, ty, 8, 16).numpy()

    # the Pallas kernel takes pre-gathered lane-major rows with segment slack
    # and channels padded to a multiple of 8
    slack = (pk.SEG_CHUNKS - 1) * cfg.chunk
    gid_ext = torch.cat([binned.inst_gid, torch.full((slack,), n, dtype=torch.int32)]).long()
    cpad = -cdim % 8
    col_pp = torch.nn.functional.pad(col_p, (0, cpad))
    out = pk.tile_blend_forward_fast(
        jnp.asarray(geom_p[gid_ext].T.numpy()), jnp.asarray(col_pp[gid_ext].T.numpy()),
        jnp.asarray(binned.tile_starts.numpy()), jnp.asarray(binned.tile_counts.numpy()),
        jnp.asarray(np.pad(bg.numpy(), (0, cpad))),
        tiles_x=tx, tiles_y=ty, tile_h=8, tile_w=16, chunk=cfg.chunk,
        mxu_sigma=False, interpret=True,
    )
    want = np.asarray(out)
    assert got.shape == (tx * ty, 128, cdim + 1)
    np.testing.assert_allclose(got[..., :cdim], want[..., :cdim], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got[..., -1], want[..., -1], atol=ATOL, rtol=RTOL)
    assert (got[..., -1] > 0.5).any()  # the scene really covers pixels


@pytest.mark.parametrize("cdim,seed,with_bg", [(3, 1, False), (3, 3, True), (16, 2, False), (16, 4, True)])
def test_rasterize_matches_jax_and_oracle(cdim, seed, with_bg):
    n = 160
    means, quats, scales, op, col, vm, K = _scene(n, seed, cdim)
    bg = np.linspace(0.2, 0.7, cdim).astype(np.float32) if with_bg else None
    jcfg = JConfig(tile_h=8, tile_w=16, chunk=8, budget_factor=6, interpret=True, aligned=False)
    rj = jax.jit(functools.partial(jrasterize, width=W, height=H, config=jcfg))(
        *map(jnp.asarray, (means, quats, scales, op, col, vm, K)),
        background=None if bg is None else jnp.asarray(bg),
    )
    tcfg = RasterizeConfig(tile_h=8, tile_w=16, chunk=8, budget_factor=6)
    rt = rasterize(*_t((means, quats, scales, op, col, vm, K)), W, H,
                   background=None if bg is None else torch.as_tensor(bg),
                   config=tcfg, device="cpu")
    assert rt.image.shape == (H, W, cdim) and rt.alpha.shape == (H, W)
    np.testing.assert_allclose(rt.image.numpy(), np.asarray(rj.image), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(rt.alpha.numpy(), np.asarray(rj.alpha), atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(rt.radii.numpy(), np.asarray(rj.radii))
    assert int(rt.overflow) == 0 == int(rj.overflow)

    # the port's oracle
    m, q, s, o, c, v, k = _t((means, quats, scales, op, col, vm, K))
    p = project_gaussians(m, q, s, v, k, W, H)
    ref_img, ref_alpha = rasterize_reference(
        p.means2d, p.conics, p.depths, p.radii, o * p.compensations, c, W, H,
        background=None if bg is None else torch.as_tensor(bg),
    )
    np.testing.assert_allclose(rt.image.numpy(), ref_img.numpy(), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(rt.alpha.numpy(), ref_alpha.numpy(), atol=ATOL, rtol=RTOL)


def test_rasterize_overflow_reported():
    means, quats, scales, op, col, vm, K = _scene(300, 4)
    cfg = RasterizeConfig(tile_h=8, tile_w=16, chunk=8, budget=64)
    res = rasterize(*_t((means, quats, scales, op, col, vm, K)), W, H, config=cfg, device="cpu")
    assert int(res.overflow) > 0


def test_rasterize_cpu_launches_no_kernel():
    kernels.reset_launch_counts()
    means, quats, scales, op, col, vm, K = _scene(50, 5)
    rasterize(*_t((means, quats, scales, op, col, vm, K)), W, H,
              config=RasterizeConfig(tile_h=8, tile_w=16, chunk=8), device="cpu")
    assert kernels.launch_counts == {"expand_gid": 0, "blend_forward": 0}


@pytest.mark.parametrize("mode", ["override", "sh_ed", "features_bg"])
def test_render_modes_match_jax(mode):
    """render(): override colours, SH colours with the expected-depth
    channel, and feature mode (background's first component broadcast)."""
    n = 120
    means, quats, scales, op, col, vm, K = _scene(n, 6, 3)
    rng = np.random.default_rng(8)
    arrays = dict(
        override_color=col,
        sh=(0.3 * rng.normal(size=(n, 16, 3))).astype(np.float32),
        semantic_features=rng.normal(size=(n, 16)).astype(np.float32),
    )
    kw = {
        "override": dict(override_color=None),
        "sh_ed": dict(sh=None, sh_degree=3, render_mode="RGB+ED"),
        "features_bg": dict(semantic_features=None, feature_mode=True),
    }[mode]
    bg = np.array([0.3, 0.5, 0.7], np.float32)
    jkw = {k: (jnp.asarray(arrays[k]) if v is None else v) for k, v in kw.items()}
    tkw = {k: (torch.as_tensor(arrays[k]) if v is None else v) for k, v in kw.items()}
    jcam = JCamera(viewmat=jnp.asarray(vm), K=jnp.asarray(K), width=W, height=H)
    tcam = TCamera(viewmat=torch.as_tensor(vm), K=torch.as_tensor(K), width=W, height=H)
    static = {k: v for k, v in kw.items() if v is not None}
    jcfg = JConfig(tile_h=8, tile_w=16, chunk=8, budget_factor=6, interpret=True, aligned=False)
    rj = jax.jit(functools.partial(jrender, config=jcfg, **static))(
        jcam, means=jnp.asarray(means), quats=jnp.asarray(quats),
        scales=jnp.asarray(scales), opacities=jnp.asarray(op),
        bg_color=jnp.asarray(bg), **{k: v for k, v in jkw.items() if k not in static},
    )
    rt = render(tcam, means=torch.as_tensor(means), quats=torch.as_tensor(quats),
                scales=torch.as_tensor(scales), opacities=torch.as_tensor(op),
                bg_color=torch.as_tensor(bg), **tkw,
                config=RasterizeConfig(tile_h=8, tile_w=16, chunk=8, budget_factor=6),
                device="cpu")
    want, got = np.asarray(rj.render), rt.render.numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(rt.alpha.numpy(), np.asarray(rj.alpha), atol=ATOL, rtol=RTOL)
    if mode == "sh_ed":
        # depth = blended depth / alpha: the division scales the blend's
        # 2e-5 error by 1/alpha, so it is held where alpha > 0.1
        np.testing.assert_allclose(got[..., :-1], want[..., :-1], atol=ATOL, rtol=RTOL)
        covered = np.asarray(rj.alpha) > 0.1
        assert covered.any()
        np.testing.assert_allclose(got[covered, -1], want[covered, -1], atol=1e-3, rtol=1e-3)
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
