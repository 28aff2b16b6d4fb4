"""The scene-level densification ops (gags_torch.scene.densify) against
gags_tpu.scene.densify on the CPU: clone, prune and reset exactly; split
with the same normal samples."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gags_tpu.scene import densify as jd
from gags_tpu.scene.gaussian_data import GaussianScene as JScene
from gags_torch.models.weights import scene_from_arrays
from gags_torch.scene import densify as td
from gags_torch.utils.synthetic import make_scene

FIELDS = ("means", "sh", "opacities_raw", "scales_raw", "quats", "semantic_features")


def _raw(n=40, seed=0):
    raw = make_scene(n, seed=seed)
    return dict(means=raw["means"], quats=raw["quats"], scales_raw=np.log(raw["scales"]),
                opacities_raw=np.log(raw["opacities"] / (1 - raw["opacities"])), sh=raw["sh"],
                semantic_features=raw["features"][:, :8])


def _both(raw):
    return (JScene(**{k: jnp.asarray(v) for k, v in raw.items()}),
            scene_from_arrays(**raw))


def _assert_same(got, want, rtol=0.0, atol=0.0):
    assert got.num_gaussians == want.num_gaussians
    for k in FIELDS:
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=rtol, atol=atol, err_msg=k)


def _grads(n, hot):
    g = np.zeros(n)
    g[hot] = 1.0
    return g


@pytest.mark.parametrize("extent", [100.0, 1.0])
def test_clone_matches_jax(extent):
    raw = _raw()
    js, ts = _both(raw)
    g = _grads(40, [0, 3, 5, 7, 11, 30])
    want = jd.densify_and_clone(js, g, 0.5, scene_extent=extent)
    got = td.densify_and_clone(ts, g, 0.5, scene_extent=extent)
    _assert_same(got, want)


@pytest.mark.parametrize("n_split", [2, 3])
def test_split_matches_jax_with_the_same_noise(n_split):
    raw = _raw(seed=1)
    js, ts = _both(raw)
    hot = [1, 2, 9, 20]
    g = _grads(40, hot)
    want = jd.densify_and_split(js, g, 0.5, scene_extent=1e-6, n_split=n_split,
                                rng=np.random.default_rng(5))
    rng = np.random.default_rng(5)
    noise = [rng.normal(size=(len(hot), 3)) for _ in range(n_split)]
    got = td.densify_and_split(ts, g, 0.5, scene_extent=1e-6, n_split=n_split, noise=noise)
    assert got.num_gaussians == 40 - len(hot) + n_split * len(hot)
    _assert_same(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.scales[-len(hot):].numpy(),
                               np.exp(raw["scales_raw"][hot]) / (0.8 * n_split), rtol=1e-5)


def test_split_draws_from_a_torch_generator():
    _, ts = _both(_raw(seed=2))
    g = _grads(40, [4, 8])
    a = td.densify_and_split(ts, g, 0.5, scene_extent=1e-6, rng=torch.Generator().manual_seed(3))
    b = td.densify_and_split(ts, g, 0.5, scene_extent=1e-6, rng=torch.Generator().manual_seed(3))
    c = td.densify_and_split(ts, g, 0.5, scene_extent=1e-6, rng=torch.Generator().manual_seed(4))
    assert torch.equal(a.means, b.means) and not torch.equal(a.means, c.means)
    assert a.num_gaussians == 40 + 2


def test_prune_and_reset_opacity_match_jax():
    raw = _raw(seed=3)
    raw["opacities_raw"][[0, 5, 6]] = -10.0  # ~0 opacity
    js, ts = _both(raw)
    _assert_same(td.reset_opacity(ts, 0.01), jd.reset_opacity(js, 0.01), rtol=1e-6)
    radii = np.arange(40.0)
    for kw in (dict(min_opacity=0.005),
               dict(min_opacity=0.005, scene_extent=0.5, max_radii2d=radii, max_screen_size=30)):
        want, kept_w = jd.prune(js, **kw)
        got, kept_g = td.prune(ts, **kw)
        np.testing.assert_array_equal(kept_g.numpy(), np.asarray(kept_w))
        _assert_same(got, want)
    assert not td.prune(ts)[1][[0, 5, 6]].any()
