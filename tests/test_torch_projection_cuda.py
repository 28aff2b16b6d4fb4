"""Kernel J2 (`splat/csrc/project.cu`, the projection forward and
backward) against the plain chain on the card.

Marked `cuda`: each test skips, with its reason, where no CUDA device is
present. On a machine with a card:
python -m pytest tests/test_torch_projection_cuda.py -q --noconftest
"""

import dataclasses

import numpy as np
import pytest
import torch

from gags_torch.splat import kernels, rasterizer
from gags_torch.splat.projection import (geom_table, project_gaussians, project_gaussians_plain,
                                         project_table, project_table_only)
from gags_torch.splat.rasterizer import RasterizeConfig, rasterize, rasterize_binned
from projection_cases import (CASES, SPECIAL_KINDS, THRESHOLD_KINDS, case_scene, special_scene,
                              threshold_scene)

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (J2 has no CPU mode)")
    return torch.device("cuda")


def _on(dev, scene):
    *arrays, w, h = scene[:8]
    return [torch.as_tensor(a, device=dev) for a in arrays] + [w, h]


def _same(a, b):
    """Equal values (NaN where NaN) and the same dtype."""
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.is_floating_point():
        return torch.equal(torch.nan_to_num(a, nan=7.0), torch.nan_to_num(b, nan=7.0)) and \
            torch.equal(torch.isnan(a), torch.isnan(b))
    return torch.equal(a, b)


def _check_forward(dev, scene, extents, antialiased):
    means, quats, scales, op, vm, K, w, h = _on(dev, scene)
    n = means.shape[0]
    tap = torch.as_tensor(np.random.default_rng(3).standard_normal((n, 2)).astype(np.float32),
                          device=dev)  # any tap: it is added, not multiplied
    plain = project_gaussians_plain(means, quats, scales, vm, K, w, h, antialiased=antialiased,
                                    opacities=op if extents else None)
    got = project_gaussians(means, quats, scales, vm, K, w, h, antialiased=antialiased,
                            opacities=op if extents else None)
    proj, table = project_table(means, quats, scales, op, vm, K, w, h, extents=extents,
                                means2d_tap=tap, antialiased=antialiased)
    torch.cuda.synchronize()
    for name in plain._fields:
        assert _same(getattr(got, name), getattr(plain, name)), name
        assert _same(getattr(proj, name), getattr(plain, name)), name
    want = geom_table(plain._replace(means2d=plain.means2d + tap), op)
    assert _same(table, want)
    if not antialiased:  # the table alone (rasterize_binned's)
        assert _same(project_table_only(means, quats, scales, op, vm, K, w, h),
                     geom_table(plain, op))
    return plain


@pytest.mark.parametrize("kind,n,seed", CASES)
@pytest.mark.parametrize("extents", [True, False])
@pytest.mark.parametrize("antialiased", [False, True])
def test_forward_matches_plain(dev, kind, n, seed, extents, antialiased):
    """Every output of J2's forward, and the table with a tap, equal the
    plain chain's on the card bit for bit."""
    plain = _check_forward(dev, case_scene(kind, n, seed), extents, antialiased)
    assert (plain.radii > 0).any()


@pytest.mark.parametrize("extents", [True, False])
@pytest.mark.parametrize("antialiased", [False, True])
def test_forward_special_rows(dev, extents, antialiased):
    """400k rows: ordinary, unnormalised (and zero) quaternions, behind the
    camera, parked at z = -1e9 and needles with det <= 0, bit for bit."""
    scene = special_scene()
    plain = _check_forward(dev, scene, extents, antialiased)
    kind = torch.as_tensor(scene[-1], device=dev)
    for k, name in enumerate(SPECIAL_KINDS):
        valid = int((plain.radii[kind == k] > 0).sum())
        assert (valid > 0) == (name in ("ordinary", "unnormalised", "needle")), (name, valid)
    mx, my = plain.means2d[:, 0], plain.means2d[:, 1]
    on_screen = (mx > 0) & (mx < scene[6]) & (my > 0) & (my < scene[7]) & (plain.depths > 0.01)
    assert int(((plain.radii == 0) & on_screen & (kind == 4)).sum()) > 1000  # det <= 0


def _rel_l2(got, want):
    return float(torch.linalg.vector_norm(got.double() - want) / torch.linalg.vector_norm(want))


def _plain_grads(inputs, vm, K, w, h, g, antialiased, dtype):
    leaves = [t.detach().to(dtype).requires_grad_(True) for t in inputs]
    p = project_gaussians_plain(*leaves[:3], vm.to(dtype), K.to(dtype), w, h,
                                antialiased=antialiased)
    table = geom_table(p._replace(means2d=p.means2d + leaves[4]), leaves[3])
    return torch.autograd.grad(table, leaves, g.to(dtype))


def _check_backward(dev, scene, extents, antialiased, g, rows=None):
    """J2's gradients against autograd through the plain chain in float64
    and float32, over `rows` (all by default): there autograd's float64
    numbers are finite (elsewhere, with antialiasing, 0 x inf gives NaN)."""
    means, quats, scales, op, vm, K, w, h = _on(dev, scene)
    n = means.shape[0]
    leaves = [t.clone().requires_grad_(True)
              for t in (means, quats, scales, op, torch.zeros((n, 2), device=dev))]
    _, table = project_table(*leaves[:4], vm, K, w, h, extents=extents, means2d_tap=leaves[4],
                             antialiased=antialiased)
    kernels.reset_launch_counts()
    got = torch.autograd.grad(table, leaves, g)
    torch.cuda.synchronize()
    assert kernels.launch_counts["project_backward"] == 1
    f64 = _plain_grads(leaves, vm, K, w, h, g, antialiased, torch.float64)
    f32 = _plain_grads(leaves, vm, K, w, h, g, antialiased, torch.float32)
    for name, a, b64, b32 in zip(("means", "quats", "scales", "opacities", "tap"), got, f64,
                                 f32):
        assert a.dtype == torch.float32 and torch.isfinite(a).all(), name
        if rows is not None:
            a, b64, b32 = a[rows], b64[rows], b32[rows]
        gap, own = _rel_l2(a, b64), _rel_l2(b32, b64)
        assert gap <= own, (name, gap, own)
    return got


@pytest.mark.parametrize("kind,n,seed", CASES)
@pytest.mark.parametrize("extents", [True, False])
@pytest.mark.parametrize("antialiased", [False, True])
def test_backward_matches_float64_autograd(dev, kind, n, seed, extents, antialiased):
    """J2's backward from a seeded table gradient (its sentinel row and
    zero columns too, which it ignores) against float64 autograd through
    the plain chain: a relative L2 no worse than float32 autograd's."""
    g = torch.as_tensor(np.random.default_rng(seed).standard_normal((n + 1, 8)).astype(
        np.float32), device=dev)
    _check_backward(dev, case_scene(kind, n, seed), extents, antialiased, g)


@pytest.mark.parametrize("extents", [True, False])
@pytest.mark.parametrize("antialiased", [False, True])
def test_backward_special_rows(dev, extents, antialiased):
    """400k rows; parked, behind-camera and needle rows get no upstream
    gradient, as culled rows in training: exactly zero there, finite
    everywhere, float64 autograd's numbers elsewhere."""
    scene = special_scene()
    kind = torch.as_tensor(scene[-1], device=dev)
    n = kind.shape[0]
    g = torch.as_tensor(np.random.default_rng(5).standard_normal((n + 1, 8)).astype(
        np.float32), device=dev)
    culled = torch.cat([(kind >= 2), torch.ones(1, dtype=torch.bool, device=dev)])
    g[culled] = 0.0
    got = _check_backward(dev, scene, extents, antialiased, g, rows=~culled[:n])
    for name, a in zip(("means", "quats", "scales", "opacities", "tap"), got):
        assert not a[culled[:n]].any(), name
        assert a[~culled[:n]].any(), name


@pytest.mark.parametrize("antialiased", [False, True])
def test_backward_takes_the_forwards_branches(dev, antialiased):
    """Rows at the near plane and at the FoV clip whose float32 chain (the
    forward's, which made their table rows) and float64 recomputation
    branch apart: the forward is the plain chain's bit for bit, and the
    backward follows the float32 branches, as float32 autograd does, and
    not float64 autograd's. No screen-position gradient, so that the
    clip's branch shows in the means' gradient."""
    scene = threshold_scene()
    _check_forward(dev, scene, True, antialiased)
    means, quats, scales, op, vm, K, w, h = _on(dev, scene)
    kind = torch.as_tensor(scene[-1], device=dev)
    n = means.shape[0]
    g = torch.as_tensor(np.random.default_rng(1).standard_normal((n + 1, 8)).astype(
        np.float32), device=dev)
    g[:, :2] = 0.0
    g[n] = 0.0
    leaves = [t.clone().requires_grad_(True)
              for t in (means, quats, scales, op, torch.zeros((n, 2), device=dev))]
    _, table = project_table(*leaves[:4], vm, K, w, h, means2d_tap=leaves[4],
                             antialiased=antialiased)
    got = torch.autograd.grad(table, leaves[:4], g)
    f64 = _plain_grads(leaves, vm, K, w, h, g, antialiased, torch.float64)
    f32 = _plain_grads(leaves, vm, K, w, h, g, antialiased, torch.float32)
    for k, where in enumerate(THRESHOLD_KINDS):
        rows = kind == k
        for name, a, b32 in zip(("means", "quats", "scales", "opacities"), got, f32):
            assert torch.isfinite(a).all(), (where, name)
            if b32[rows].any():
                assert _rel_l2(a[rows], b32[rows].double()) < 1e-3, (where, name)
        # the rows do branch apart: float64 autograd's means gradient is another
        assert _rel_l2(f32[0][rows], f64[0][rows]) > 0.05, where


@pytest.mark.parametrize("antialiased", [False, True])
def test_backward_finite_with_gradient_on_every_row(dev, antialiased):
    """400k special rows, each given an upstream gradient, the culled too:
    every gradient finite (a needle whose float64 determinant cancels to
    0 where the forward's float32 one is positive included)."""
    scene = special_scene()
    means, quats, scales, op, vm, K, w, h = _on(dev, scene)
    n = means.shape[0]
    g = torch.as_tensor(np.random.default_rng(7).standard_normal((n + 1, 8)).astype(
        np.float32), device=dev)
    leaves = [t.clone().requires_grad_(True) for t in (means, quats, scales, op)]
    _, table = project_table(*leaves, vm, K, w, h, antialiased=antialiased)
    for name, a in zip(("means", "quats", "scales", "opacities"),
                       torch.autograd.grad(table, leaves, g)):
        assert torch.isfinite(a).all(), name


def _rgb_scene(dev, n=20_000, w=320, h=180):
    scene = case_scene("synthetic", n, 2)
    means, quats, scales, op, vm, K, _, _ = _on(dev, scene)
    K = K.clone()
    K[0, 2], K[1, 2] = w / 2, h / 2
    colors = torch.rand((n, 3), device=dev, generator=torch.Generator(dev).manual_seed(0))
    return means, quats, scales, op, colors, vm, K, w, h


def test_rasterize_one_projection_each_way(dev, monkeypatch):
    """rasterize with geometry_grads: the image, alpha, radii and binning
    of the plain chain (the projection before J2, patched in), one J2
    forward and one J2 backward; rasterize_binned: one forward."""
    means, quats, scales, op, colors, vm, K, w, h = _rgb_scene(dev)
    cfg = RasterizeConfig(geometry_grads=True)

    def run():
        leaves = [t.clone().requires_grad_(True) for t in (means, quats, scales, op, colors)]
        tap = torch.zeros((means.shape[0], 2), device=dev, requires_grad=True)
        res = rasterize(*leaves[:4], leaves[4], vm, K, w, h, config=cfg, means2d_tap=tap,
                        device=dev)
        (res.image.square().sum() + res.alpha.sum()).backward()
        torch.cuda.synchronize()
        return res, [t.grad for t in leaves + [tap]]

    kernels.reset_launch_counts()
    res, grads = run()
    counts = dict(kernels.launch_counts)
    assert counts["project_forward"] == 1 and counts["project_backward"] == 1, counts
    _, binned, _, _, _ = rasterizer._prepare(means, quats, scales, op, vm, K, w, h, cfg)

    def plain_table(m, q, s, o, vm_, K_, w_, h_, *, extents, means2d_tap=None):
        p = project_gaussians_plain(m, q, s, vm_, K_, w_, h_, opacities=o if extents else None)
        pm = p if means2d_tap is None else p._replace(means2d=p.means2d + means2d_tap)
        return p._replace(**{f: getattr(p, f).detach() for f in p._fields}), geom_table(pm, o)

    monkeypatch.setattr(rasterizer, "project_table", plain_table)
    want, want_grads = run()
    _, want_bin, _, _, _ = rasterizer._prepare(means, quats, scales, op, vm, K, w, h, cfg)
    for name in ("image", "alpha", "radii", "means2d"):
        assert torch.equal(getattr(res, name), getattr(want, name)), name
    for name in ("inst_gid", "tile_starts", "tile_counts", "order"):
        assert torch.equal(getattr(binned, name), getattr(want_bin, name)), name
    for name, a, b in zip(("means", "quats", "scales", "opacities", "colors", "tap"), grads,
                          want_grads):  # the colour and tap gradients do not pass through J2
        if name in ("colors", "tap"):
            assert torch.equal(a, b), name
        else:
            assert _rel_l2(a, b.double()) < 1e-4, name
    monkeypatch.undo()

    kernels.reset_launch_counts()
    bcfg = dataclasses.replace(cfg, geometry_grads=False)
    with torch.no_grad():
        b = rasterizer.prepare_binning(means, quats, scales, vm, K, w, h, bcfg, opacities=op)
    assert kernels.launch_counts["project_forward"] == 1
    kernels.reset_launch_counts()
    img, _ = rasterize_binned(means, quats, scales, op, colors, vm, K, b.inst_gid,
                              b.tile_starts, b.tile_counts, w, h, config=bcfg, order=b.order,
                              red_slot=b.red.slot_to_pos, red_rank=b.red.slot_rank,
                              red_block=b.red.chunk_block)
    torch.cuda.synchronize()
    assert kernels.launch_counts["project_forward"] == 1
    assert kernels.launch_counts["project_backward"] == 0
    assert torch.isfinite(img).all()
