"""The full rasterizer VJP of the port (geometry_grads: K1 forward, K8 +
K3 backward, autograd through the projection) on the CPU, through the
kernels' plain versions:

  (i)  plain K8 against gags_tpu's Pallas tile_blend_backward_full in
       interpret mode, on a small aligned binning (C = 3, a moderate and a
       saturated scene);
  (ii) gradients for means, quats, scales, opacities and colours against
       autodiff of the JAX oracle (project_gaussians + rasterize_reference),
       the cases of tests/test_geometry_grads.py at their tolerances;
  (iii) parked (dead) slots get finite, zero gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gags_tpu.splat import pallas_kernel as pk
from gags_tpu.splat.projection import project_gaussians as jproject
from gags_tpu.splat.reference import rasterize_reference as jreference
from gags_torch.splat import kernels
from gags_torch.splat.rasterizer import RasterizeConfig, _prepare, order_ext, rasterize

W, H, F = 48, 24, 40.0
CFG = RasterizeConfig(tile_h=8, tile_w=16, chunk=8, budget_factor=8, geometry_grads=True)
NAMES = ["means", "quats", "scales", "opacities", "colors"]


def _scene(n, seed=0, cdim=3, max_op=0.6):
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-1.2, 1.2, n), rng.uniform(-0.7, 0.7, n),
                      rng.uniform(3, 9, n)], 1).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(rng.normal(-1.8, 0.4, size=(n, 3))).astype(np.float32)
    op = rng.uniform(0.15, max_op, n).astype(np.float32)
    col = rng.uniform(0, 1, (n, cdim)).astype(np.float32)
    return [means, quats, scales, op, col]


def _saturated_scene():
    """Concentrated near-opaque splats: deep overdraw, rays that end early."""
    n = 80
    rng = np.random.default_rng(7)
    means = np.stack([rng.uniform(-0.35, 0.35, n), rng.uniform(-0.2, 0.2, n),
                      rng.uniform(3, 9, n)], 1).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(rng.normal(-1.2, 0.3, size=(n, 3))).astype(np.float32)
    col = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    op = np.random.default_rng(11).uniform(0.85, 0.999, n).astype(np.float32)
    return [means, quats, scales, op, col]


VM = np.eye(4, dtype=np.float32)
K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]], np.float32)
BG = np.array([0.3, 0.2, 0.1], np.float32)


def _port_grads(arrs, loss_fn, bg=None, cfg=CFG):
    ts = [torch.as_tensor(a).requires_grad_(True) for a in arrs]
    m, q, s, o, c = ts
    res = rasterize(m, q, s, o, c, torch.as_tensor(VM), torch.as_tensor(K), W, H,
                    background=None if bg is None else torch.as_tensor(bg), config=cfg,
                    device="cpu")
    loss_fn(res.image, res.alpha).backward()
    return [t.grad.numpy() for t in ts]


def _oracle_grads(arrs, loss_fn, bg=None):
    def loss(m, q, s, o, c):
        p = jproject(m, q, s, jnp.asarray(VM), jnp.asarray(K), W, H)
        img, alpha = jreference(p.means2d, p.conics, p.depths, p.radii, o * p.compensations,
                                c, W, H, background=None if bg is None else jnp.asarray(bg))
        return loss_fn(img, alpha)

    return [np.asarray(g) for g in
            jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*[jnp.asarray(a) for a in arrs])]


def _assert_grads_close(got, want, atol_frac, rtol, what):
    for name, a, b in zip(NAMES, want, got):
        scale = np.abs(a).max() + 1e-8
        np.testing.assert_allclose(b, a, atol=atol_frac * scale, rtol=rtol,
                                   err_msg=f"{what}: grad mismatch: {name}")


# --------------------------------------------------------------------------
# (i) plain K8 vs the Pallas kernel in interpret mode
# --------------------------------------------------------------------------


def _k8_inputs(arrs, seed):
    means, quats, scales, op, col = (torch.as_tensor(a) for a in arrs)
    _, binned, geom, tx, ty = _prepare(means, quats, scales, op, torch.as_tensor(VM),
                                       torch.as_tensor(K), W, H, CFG)
    perm = order_ext(binned.order.long())
    colors = torch.cat([col, torch.zeros((1, col.shape[1]))])[perm].contiguous()
    rng = np.random.default_rng(seed)
    npix = CFG.tile_h * CFG.tile_w
    g_img = rng.normal(size=(tx * ty, npix, 3)).astype(np.float32)
    g_alpha = rng.normal(size=(tx * ty, npix, 1)).astype(np.float32)
    return binned, geom[perm].contiguous(), colors, g_img, g_alpha, tx, ty


@pytest.fixture(scope="module", params=["moderate", "saturated"])
def k8_case(request):
    arrs = _scene(150, seed=4) if request.param == "moderate" else _saturated_scene()
    binned, geom, colors, g_img, g_alpha, tx, ty = _k8_inputs(arrs, seed=5)
    table = torch.cat([geom, torch.nn.functional.pad(colors, (0, 5))], 1)
    inst_data = jnp.asarray(table[binned.inst_gid.long()].T.numpy())
    gcol, ggeo = pk.tile_blend_backward_full(
        inst_data, jnp.asarray(binned.tile_starts.numpy()),
        jnp.asarray(binned.tile_counts.numpy()), jnp.asarray(np.pad(g_img, ((0, 0),) * 2 + ((0, 5),))),
        jnp.asarray(g_alpha), tiles_x=tx, tiles_y=ty, tile_h=CFG.tile_h, tile_w=CFG.tile_w,
        chunk=CFG.chunk, interpret=True)
    want = (np.asarray(gcol).T[:, :3], np.asarray(ggeo).T)  # the TPU layout, as rows
    return request.param, (binned, geom, colors, g_img, g_alpha, tx, ty), want


def test_blend_backward_full_plain_matches_pallas(k8_case):
    name, (binned, geom, colors, g_img, g_alpha, tx, ty), (want_col, want_geo) = k8_case
    got_col, got_geo = kernels.blend_backward_full(
        geom, colors, binned.inst_gid, binned.tile_starts, binned.tile_counts,
        torch.as_tensor(g_img), torch.as_tensor(g_alpha), tx, ty, CFG.tile_h, CFG.tile_w)
    m = binned.inst_gid.shape[0]
    assert got_col.shape == (m, 3) and got_geo.shape == (m, 8)
    assert not got_geo[:, 6:].any()
    geo_names = ("mx", "my", "ca", "cb", "cc", "opacity")
    for what, got, want in [(f"colour {j}", got_col[:, j].numpy(), want_col[:, j])
                            for j in range(3)] + [
                            (geo_names[j], got_geo[:, j].numpy(), want_geo[:, j])
                            for j in range(6)]:
        # column by column, each against its own scale (the conic columns
        # are thousands of times larger than mx, my and opacity): the
        # Pallas kernel walks log T, the port multiplies T, so sums agree to
        # float rounding; isolated splats may flip at the 1/255 or 1e-4
        # thresholds (NUMERICS.md), so at most 0.1% of values may fall
        # outside 1e-5 max|g| abs + 1e-4 rel (none do on these scenes), and
        # the mean error is at most 1e-5 max|g| and 1e-3 mean|g|
        scale = np.abs(want).max()
        err = np.abs(got - want)
        outside = err > 1e-5 * scale + 1e-4 * np.abs(want)
        assert scale > 0, (name, what)
        assert outside.mean() <= 1e-3, (name, what, outside.sum(), err.max() / scale)
        assert err.mean() <= 1e-5 * scale, (name, what, err.mean() / scale)
        assert err.mean() <= 1e-3 * np.abs(want).mean(), (name, what, err.mean())


# --------------------------------------------------------------------------
# (ii) autodiff of the JAX oracle
# --------------------------------------------------------------------------


def _l1_alpha_loss(tgt, xp):
    return lambda img, alpha: xp.mean(xp.abs(img - tgt)) + 0.1 * xp.mean(alpha)


@pytest.fixture(scope="module")
def oracle_l1():
    arrs = _scene(60, seed=0)
    tgt = np.random.default_rng(9).uniform(0, 1, (H, W, 3)).astype(np.float32)
    want = _oracle_grads(arrs, _l1_alpha_loss(jnp.asarray(tgt), jnp), bg=BG)
    return arrs, tgt, want


def test_geometry_grads_match_oracle(oracle_l1):
    arrs, tgt, want = oracle_l1
    got = _port_grads(arrs, _l1_alpha_loss(torch.as_tensor(tgt), torch), bg=BG)
    _assert_grads_close(got, want, 2e-4, 2e-3, "background + alpha term")
    assert all(np.abs(g).max() > 0 for g in got)


def test_geometry_grads_saturated_rays_match_oracle():
    """Every geometry gradient flows through T_fin (a weighted alpha-only
    loss): the backward's T_fin must be the transmittance after the last
    INCLUDED splat, not a carry that keeps absorbing excluded splats."""
    arrs = _saturated_scene()
    wmap = np.random.default_rng(13).uniform(0.5, 1.5, (H, W)).astype(np.float32)
    want = _oracle_grads(arrs, lambda img, alpha: jnp.mean(jnp.asarray(wmap) * alpha), bg=BG)
    got = _port_grads(arrs, lambda img, alpha: torch.mean(torch.as_tensor(wmap) * alpha), bg=BG)
    _assert_grads_close(got, want, 5e-4, 5e-3, "saturated")


def test_geometry_grads_finite_difference_spotcheck():
    arrs = _scene(12, seed=3)

    def loss(means):
        res = rasterize(means, *(torch.as_tensor(a) for a in arrs[1:]), torch.as_tensor(VM),
                        torch.as_tensor(K), W, H, config=CFG, device="cpu")
        return torch.sum(res.image ** 2)

    m = torch.as_tensor(arrs[0]).requires_grad_(True)
    loss(m).backward()
    g = m.grad.numpy()
    eps = 1e-3
    rng = np.random.default_rng(1)
    for _ in range(4):
        i = rng.integers(0, 12)
        j = rng.integers(0, 2)  # x or y (z moves the binning)
        dm = np.zeros((12, 3), np.float32)
        dm[i, j] = eps
        with torch.no_grad():
            lp = float(loss(torch.as_tensor(arrs[0] + dm)))
            lm = float(loss(torch.as_tensor(arrs[0] - dm)))
        fd = (lp - lm) / (2 * eps)
        assert abs(fd - g[i, j]) < 0.05 * (abs(fd) + abs(g[i, j]) + 1e-3), (i, j, fd, g[i, j])


def test_feature_mode_grads_unaffected():
    """The colour gradient is the same with geometry_grads on and off."""
    arrs = _scene(40, seed=5, cdim=8)
    cfg_off = RasterizeConfig(tile_h=8, tile_w=16, chunk=8, budget_factor=8)
    grads = []
    for cfg in (CFG, cfg_off):
        c = torch.as_tensor(arrs[4]).requires_grad_(True)
        res = rasterize(*(torch.as_tensor(a) for a in arrs[:4]), c, torch.as_tensor(VM),
                        torch.as_tensor(K), W, H, config=cfg, device="cpu")
        torch.mean(res.image ** 2).backward()
        grads.append(c.grad.numpy())
    np.testing.assert_allclose(grads[0], grads[1], atol=1e-6)


def test_means2d_tap_gradient_is_screen_grad():
    """dL/dmeans2d through the zero tap equals autodiff of the ORACLE with
    respect to the same screen-space shift."""
    n = 40
    arrs = _scene(n, seed=3)
    tgt = np.random.default_rng(11).uniform(0, 1, (H, W, 3)).astype(np.float32)
    means, quats, scales, op, col = (jnp.asarray(a) for a in arrs)

    def loss_oracle(tap):
        p = jproject(means, quats, scales, jnp.asarray(VM), jnp.asarray(K), W, H)
        img, _ = jreference(p.means2d + tap, p.conics, p.depths, p.radii, op * p.compensations,
                            col, W, H)
        return jnp.mean(jnp.abs(img - jnp.asarray(tgt)))

    go = np.asarray(jax.grad(loss_oracle)(jnp.zeros((n, 2), jnp.float32)))
    tap = torch.zeros((n, 2), requires_grad=True)
    res = rasterize(*(torch.as_tensor(a) for a in arrs), torch.as_tensor(VM), torch.as_tensor(K),
                    W, H, config=CFG, means2d_tap=tap, device="cpu")
    torch.mean(torch.abs(res.image - torch.as_tensor(tgt))).backward()
    gp = tap.grad.numpy()
    scale = np.abs(go).max() + 1e-8
    np.testing.assert_allclose(gp / scale, go / scale, atol=2e-4)
    assert np.abs(gp).max() > 0


# --------------------------------------------------------------------------
# (iii) parked slots
# --------------------------------------------------------------------------


def test_parked_slots_get_finite_zero_gradients():
    """Dead slots of the RGB trainer sit at z = -1e9 with tiny scales: the
    frustum cull drops them, and their gradients are exactly zero."""
    arrs = _scene(30, seed=6)
    arrs[0][20:] = [0.0, 0.0, -1.0e9]
    arrs[2][20:] = np.exp(-10.0)
    tgt = np.random.default_rng(2).uniform(0, 1, (H, W, 3)).astype(np.float32)
    tap = torch.zeros((30, 2), requires_grad=True)
    ts = [torch.as_tensor(a).requires_grad_(True) for a in arrs]
    res = rasterize(*ts, torch.as_tensor(VM), torch.as_tensor(K), W, H, background=torch.as_tensor(BG),
                    config=CFG, means2d_tap=tap, device="cpu")
    (torch.mean(torch.abs(res.image - torch.as_tensor(tgt))) + 0.1 * torch.mean(res.alpha)).backward()
    assert not res.radii[20:].any()
    for t in ts + [tap]:
        assert torch.isfinite(t.grad).all()
        assert not t.grad[20:].any()
        assert t.grad[:20].abs().max() > 0
