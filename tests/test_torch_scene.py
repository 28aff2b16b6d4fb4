"""gags_torch.scene vs gags_tpu.scene: PLY in both directions, activations."""

import jax.numpy as jnp
import numpy as np
import torch

from gags_tpu.scene.gaussian_data import GaussianScene as JScene
from gags_torch.scene.gaussian_data import GaussianScene as TScene
from gags_torch.models.weights import scene_from_arrays


def _raw(n=40, f=16, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        means=rng.normal(size=(n, 3)).astype(np.float32),
        sh=rng.normal(size=(n, 16, 3)).astype(np.float32),
        opacities_raw=rng.normal(size=(n,)).astype(np.float32),
        scales_raw=rng.normal(-3, 0.5, size=(n, 3)).astype(np.float32),
        quats=rng.normal(size=(n, 4)).astype(np.float32),
        semantic_features=rng.normal(size=(n, f)).astype(np.float32),
    )


def _jscene(raw):
    return JScene(**{k: jnp.asarray(v) for k, v in raw.items()})


def _assert_same(js, ts):
    for name in ("means", "sh", "opacities_raw", "scales_raw", "quats", "semantic_features"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)))
    np.testing.assert_allclose(ts.opacities.numpy(), np.asarray(js.opacities), atol=1e-7, rtol=1e-6)
    np.testing.assert_allclose(ts.scales.numpy(), np.asarray(js.scales), atol=1e-7, rtol=1e-6)


def test_ply_written_by_jax_read_by_port(tmp_path):
    raw = _raw()
    js = _jscene(raw)
    path = str(tmp_path / "a.ply")
    js.save_ply(path)
    ts = TScene.from_ply(path)
    assert ts.semantic_features.shape == (40, 16)
    _assert_same(js, ts)


def test_ply_written_by_port_read_by_jax(tmp_path):
    raw = _raw(seed=1, f=8)
    ts = scene_from_arrays(
        raw["means"], raw["quats"], raw["scales_raw"], raw["opacities_raw"],
        raw["sh"], semantic_features=raw["semantic_features"],
    )
    path = str(tmp_path / "b.ply")
    ts.save_ply(path)
    js = JScene.from_ply(path)
    assert js.semantic_features.shape == (40, 8)
    _assert_same(js, ts)


def test_scene_to_device_keeps_values():
    ts = scene_from_arrays(**{k: v for k, v in _raw(n=5).items() if k != "semantic_features"})
    moved = ts.to("cpu")
    assert moved.semantic_features is None
    assert torch.equal(moved.means, ts.means) and moved.num_gaussians == 5
