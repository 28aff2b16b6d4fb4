"""gags_torch.splat.projection vs gags_tpu.splat.projection."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gags_tpu.splat.projection import project_gaussians as jproj
from gags_torch.splat.projection import (effective_opacity, geom_table,
                                         project_gaussians as tproj, project_gaussians_plain,
                                         project_table, project_table_only)
from projection_cases import CASES, case_scene


@pytest.mark.parametrize("kind,n,seed", CASES)
@pytest.mark.parametrize("with_opacity", [True, False])
@pytest.mark.parametrize("antialiased", [False, True])
def test_projection_matches_jax(kind, n, seed, with_opacity, antialiased):
    means, quats, scales, op, vm, K, w, h = case_scene(kind, n, seed)
    kw = dict(antialiased=antialiased)
    pj = jproj(*map(jnp.asarray, (means, quats, scales, vm, K)), w, h,
               opacities=jnp.asarray(op) if with_opacity else None, **kw)
    pt = tproj(*map(torch.as_tensor, (means, quats, scales, vm, K)), w, h,
               opacities=torch.as_tensor(op) if with_opacity else None, **kw)
    for name in ("radii", "radii_x", "radii_y"):
        np.testing.assert_array_equal(getattr(pt, name).numpy(), np.asarray(getattr(pj, name)), err_msg=name)
    assert (np.asarray(pj.radii) > 0).any()
    for name in ("means2d", "conics", "depths", "compensations"):
        a = np.asarray(getattr(pj, name))
        b = getattr(pt, name).numpy()
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5, err_msg=name)
    assert pt.radii.dtype == torch.int32


def test_effective_opacity():
    o = torch.tensor([0.5, 0.2])
    c = torch.tensor([1.0, 0.5])
    assert torch.equal(effective_opacity(o, c), torch.tensor([0.5, 0.1]))


def _old_table_grads(means, quats, scales, op, vm, K, w, h, tap, g, antialiased):
    """The table and its gradients through the elementwise chain: a
    projection without extents, the tap added to means2d, `geom_table`,
    autograd."""
    leaves = [t.clone().requires_grad_(True) for t in (means, quats, scales, op, tap)]
    p = project_gaussians_plain(*leaves[:3], vm, K, w, h, antialiased=antialiased)
    table = geom_table(p._replace(means2d=p.means2d + leaves[4]), leaves[3])
    return table.detach(), torch.autograd.grad(table, leaves, g)


@pytest.mark.parametrize("kind,n,seed", CASES)
@pytest.mark.parametrize("extents", [True, False])
@pytest.mark.parametrize("antialiased", [False, True])
def test_project_table_cpu_matches_autograd(kind, n, seed, extents, antialiased):
    """project_table on CPU tensors (the autograd.Function's plain
    versions): the table and every gradient equal the elementwise chain
    differentiated by autograd, bit for bit; the projection equals
    project_gaussians with the extents' opacities."""
    means, quats, scales, op, vm, K, w, h = map(
        lambda a: torch.as_tensor(a) if isinstance(a, np.ndarray) else a, case_scene(kind, n, seed))
    rng = np.random.default_rng(seed + 17)
    tap = torch.zeros((n, 2))
    g = torch.as_tensor(rng.standard_normal((n + 1, 8)).astype(np.float32))
    want_table, want = _old_table_grads(means, quats, scales, op, vm, K, w, h, tap, g, antialiased)
    leaves = [t.clone().requires_grad_(True) for t in (means, quats, scales, op, tap)]
    proj, table = project_table(*leaves[:4], vm, K, w, h, extents=extents,
                                means2d_tap=leaves[4], antialiased=antialiased)
    assert torch.equal(table, want_table)
    got = torch.autograd.grad(table, leaves, g)
    for name, a, b in zip(("means", "quats", "scales", "opacities", "tap"), got, want):
        assert torch.equal(a, b), name
    ref = tproj(means, quats, scales, vm, K, w, h, antialiased=antialiased,
                opacities=op if extents else None)
    for name in ref._fields:
        assert torch.equal(getattr(proj, name), getattr(ref, name)), name
        assert not getattr(proj, name).requires_grad, name


def test_project_table_without_grad_is_the_plain_projection():
    """Under no_grad (the binning, GAD's table, serving) nothing is
    recorded; without a tap the table's means2d are the projection's."""
    means, quats, scales, op, vm, K, w, h = map(
        lambda a: torch.as_tensor(a) if isinstance(a, np.ndarray) else a, case_scene("box", 300, 0))
    leaves = [t.clone().requires_grad_(True) for t in (means, quats, scales, op)]
    with torch.no_grad():
        proj, table = project_table(*leaves, vm, K, w, h)
    assert table.grad_fn is None and table.shape == (301, 8)
    assert torch.equal(table[:300, :2], proj.means2d) and not table[300].any()
    assert torch.equal(table[:300, 5], op)


@pytest.mark.parametrize("kind,n,seed", CASES)
def test_project_table_only_is_project_tables_table(kind, n, seed):
    """The table alone (rasterize_binned's, on CPU tensors) equals
    project_table's without a tap, bit for bit, and carries no gradient."""
    means, quats, scales, op, vm, K, w, h = map(
        lambda a: torch.as_tensor(a) if isinstance(a, np.ndarray) else a, case_scene(kind, n, seed))
    leaves = [t.clone().requires_grad_(True) for t in (means, quats, scales, op)]
    only = project_table_only(*leaves, vm, K, w, h)
    _, table = project_table(*leaves, vm, K, w, h)
    assert only.grad_fn is None and not only.requires_grad
    assert torch.equal(only, table.detach())
