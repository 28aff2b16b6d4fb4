"""gags_torch.splat.projection vs gags_tpu.splat.projection."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gags_tpu.splat.projection import project_gaussians as jproj
from gags_torch.splat.projection import effective_opacity, project_gaussians as tproj
from gags_torch.utils.synthetic import make_camera, make_scene

W, H, F = 64, 32, 40.0


def _scene(n, seed):
    rng = np.random.default_rng(seed)
    means = np.stack(
        [rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n), rng.uniform(-1, 9, n)], 1
    ).astype(np.float32)  # some behind the near plane
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(rng.normal(-1.8, 0.6, size=(n, 3))).astype(np.float32)
    op = rng.uniform(0.01, 0.95, n).astype(np.float32)
    vm = np.eye(4, dtype=np.float32)
    vm[:3, 3] = rng.normal(scale=0.2, size=3)
    K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]], np.float32)
    return means, quats, scales, op, vm, K, W, H


def _synthetic(n, seed):
    raw = make_scene(n, seed=seed, extent=3.0)
    cam = make_camera(128, 72)
    return (raw["means"], raw["quats"], raw["scales"], raw["opacities"],
            cam.viewmat.numpy(), cam.K.numpy(), 128, 72)


CASES = [("box", 300, 0), ("box", 500, 1), ("synthetic", 2000, 0), ("synthetic", 1000, 5)]


@pytest.mark.parametrize("kind,n,seed", CASES)
@pytest.mark.parametrize("with_opacity", [True, False])
@pytest.mark.parametrize("antialiased", [False, True])
def test_projection_matches_jax(kind, n, seed, with_opacity, antialiased):
    means, quats, scales, op, vm, K, w, h = (_scene if kind == "box" else _synthetic)(n, seed)
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
