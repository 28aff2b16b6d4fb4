"""The port's training rasterizer (aligned binning, K1 forward, K2 + K3
colour backward) vs gags_tpu's public rasterize / rasterize_binned and
jax.grad, through the plain kernel versions on the CPU."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gags_tpu.splat import rasterizer as jr
from gags_torch.splat import rasterizer as tr
from gags_torch.utils.synthetic import make_camera, make_scene

W, H, N = 64, 32, 150
TILE = dict(tile_h=8, tile_w=16, chunk=8)
ATOL, RTOL = 2e-5, 1e-4


def _inputs(seed, cdim=16):
    raw = make_scene(N, seed=seed, feature_dim=cdim)
    cam = make_camera(W, H)
    geo = [raw[k] for k in ("means", "quats", "scales", "opacities")]
    return geo, raw["features"], cam.viewmat.numpy(), cam.K.numpy()


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


def _t(arrs):
    return [torch.as_tensor(a) for a in arrs]


@pytest.mark.parametrize("seed,cdim,with_bg", [(0, 16, False), (1, 3, True), (2, 16, True)])
def test_rasterize_aligned_matches_jax(seed, cdim, with_bg):
    geo, cols, vm, K = _inputs(seed, cdim)
    bg = np.linspace(0.2, 0.7, cdim).astype(np.float32) if with_bg else None
    rj = jax.jit(functools.partial(jr.rasterize, width=W, height=H,
                                   config=jr.auto_config(**TILE)))(
        *_j(geo), jnp.asarray(cols), jnp.asarray(vm), jnp.asarray(K),
        background=None if bg is None else jnp.asarray(bg))
    rt = tr.rasterize(*_t(geo), torch.as_tensor(cols), *_t((vm, K)), W, H,
                      background=None if bg is None else torch.as_tensor(bg),
                      config=tr.RasterizeConfig(**TILE), device="cpu")
    np.testing.assert_allclose(rt.image.detach().numpy(), np.asarray(rj.image), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(rt.alpha.numpy(), np.asarray(rj.alpha), atol=ATOL, rtol=RTOL)
    assert int(rt.overflow) == 0


def _port_binned(geo, cols, vm, K, cfg, bg=None):
    means, quats, scales, op = _t(geo)
    b = tr.prepare_binning(means, quats, scales, *_t((vm, K)), W, H, cfg, opacities=op)
    colors = cols if isinstance(cols, torch.Tensor) else torch.as_tensor(cols)
    return tr.rasterize_binned(
        means, quats, scales, op, colors, *_t((vm, K)), b.inst_gid, b.tile_starts,
        b.tile_counts, W, H, background=bg, config=cfg, order=b.order,
        red_slot=b.red.slot_to_pos, red_rank=b.red.slot_rank, red_block=b.red.chunk_block)


def test_rasterize_binned_matches_jax():
    geo, cols, vm, K = _inputs(3)
    cfg = jr.auto_config(**TILE)
    means, quats, scales, op = _j(geo)
    b = jr.prepare_binning(means, quats, scales, jnp.asarray(vm), jnp.asarray(K), W, H, cfg,
                           opacities=op)
    img_j, alpha_j = jr.rasterize_binned(
        means, quats, scales, op, jnp.asarray(cols), jnp.asarray(vm), jnp.asarray(K),
        b.inst_gid, b.tile_starts, b.tile_counts, W, H, config=cfg, order=b.order,
        red_slot=b.red.slot_to_pos, red_rank=b.red.slot_rank, red_block=b.red.chunk_block)
    img_t, alpha_t = _port_binned(geo, cols, vm, K, tr.RasterizeConfig(**TILE))
    np.testing.assert_allclose(img_t.detach().numpy(), np.asarray(img_j), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(alpha_t.numpy(), np.asarray(alpha_j), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("seed,cdim", [(4, 16), (5, 3)])
def test_color_gradient_matches_jax_grad(seed, cdim):
    geo, cols, vm, K = _inputs(seed, cdim)
    rng = np.random.default_rng(seed)
    wmap = rng.normal(size=(H, W, cdim)).astype(np.float32)
    bg = np.linspace(0.1, 0.4, cdim).astype(np.float32)
    cfg = jr.auto_config(**TILE)

    def loss_j(c):
        r = jr.rasterize(*_j(geo), c, jnp.asarray(vm), jnp.asarray(K), W, H,
                         background=jnp.asarray(bg), config=cfg)
        return jnp.sum(r.image * wmap) + jnp.sum(r.image ** 2)

    gj = np.asarray(jax.jit(jax.grad(loss_j))(jnp.asarray(cols)))
    ct = torch.as_tensor(cols).requires_grad_(True)
    rt = tr.rasterize(*_t(geo), ct, *_t((vm, K)), W, H, background=torch.as_tensor(bg),
                      config=tr.RasterizeConfig(**TILE), device="cpu")
    (torch.sum(rt.image * torch.as_tensor(wmap)) + torch.sum(rt.image ** 2)).backward()
    np.testing.assert_allclose(ct.grad.numpy(), gj, atol=1e-6, rtol=1e-4)
    assert np.abs(gj).max() > 1e-2


def test_binned_matches_full():
    geo, cols, vm, K = _inputs(6)
    cfg = tr.RasterizeConfig(**TILE)
    full = tr.rasterize(*_t(geo), torch.as_tensor(cols), *_t((vm, K)), W, H,
                        background=torch.zeros(16), config=cfg, device="cpu")
    img, alpha = _port_binned(geo, cols, vm, K, cfg, bg=torch.zeros(16))
    np.testing.assert_allclose(img.detach().numpy(), full.image.detach().numpy(), atol=1e-6)
    np.testing.assert_allclose(alpha.numpy(), full.alpha.numpy(), atol=1e-6)


def test_binned_gradients_match():
    geo, cols, vm, K = _inputs(7)
    cfg = tr.RasterizeConfig(**TILE)
    tgt = torch.as_tensor(np.random.default_rng(2).normal(size=(H, W, 16)), dtype=torch.float32)
    c1 = torch.as_tensor(cols).requires_grad_(True)
    r = tr.rasterize(*_t(geo), c1, *_t((vm, K)), W, H, config=cfg, device="cpu")
    torch.mean(torch.abs(r.image - tgt)).backward()
    c2 = torch.as_tensor(cols).requires_grad_(True)
    img, _ = _port_binned(geo, c2, vm, K, cfg)
    torch.mean(torch.abs(img - tgt)).backward()
    np.testing.assert_allclose(c1.grad.numpy(), c2.grad.numpy(), atol=1e-6)


def test_unaligned_backward_and_geometry_grads_raise():
    geo, cols, vm, K = _inputs(8, 3)
    c = torch.as_tensor(cols).requires_grad_(True)
    r = tr.rasterize(*_t(geo), c, *_t((vm, K)), W, H,
                     config=tr.RasterizeConfig(**TILE, aligned=False), device="cpu")
    with pytest.raises(ValueError, match="aligned"):
        r.image.sum().backward()
    # geometry gradients (K8) need the aligned layout too: the unaligned
    # forward runs, its backward raises
    m = torch.as_tensor(geo[0]).requires_grad_(True)
    r = tr.rasterize(m, *_t(geo[1:]), c, *_t((vm, K)), W, H,
                     config=tr.RasterizeConfig(**TILE, aligned=False, geometry_grads=True),
                     device="cpu")
    with pytest.raises(ValueError, match="aligned"):
        (r.image.sum() + r.alpha.sum()).backward()


def test_permute_rows_backward_is_inverse_gather():
    x = torch.arange(12.0).reshape(6, 2).requires_grad_(True)
    order = torch.tensor([3, 0, 5, 1, 4, 2], dtype=torch.int32)
    inv = tr._inverse_order(order)
    y = tr.permute_rows(x, order, inv)
    g = torch.arange(12.0).reshape(6, 2) * 10
    y.backward(g)
    torch.testing.assert_close(y.detach(), x.detach()[order.long()])
    torch.testing.assert_close(x.grad, g[inv.long()])
