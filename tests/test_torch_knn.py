"""Exact 3-NN (gags_torch.knn) and the seed-cloud initialisation
(GaussianScene.from_point_cloud) against gags_tpu on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gags_tpu.knn import knn_sq_dists as jknn
from gags_tpu.knn import mean_knn_sq_dist as jmean
from gags_tpu.scene.gaussian_data import GaussianScene as JScene
from gags_torch.knn import knn_sq_dists, mean_knn_sq_dist
from gags_torch.scene.gaussian_data import GaussianScene


def _cloud(n, seed):
    rng = np.random.default_rng(seed)
    # a clustered cloud: near neighbours at several scales
    centres = rng.normal(size=(max(n // 50, 1), 3)) * 3.0
    pts = centres[rng.integers(0, len(centres), n)] + rng.normal(size=(n, 3)) * 0.2
    return pts.astype(np.float32)


@pytest.mark.parametrize("n,row_block,col_block", [(200, 1024, 4096), (1500, 256, 512),
                                                   (1500, 1024, 4096)])
def test_knn_matches_jax(n, row_block, col_block):
    """Several row and column blocks (1500 points in 6 x 3 blocks). Both
    sides evaluate ||x||^2 + ||y||^2 - 2 x.y in float32: each distance may
    round differently by a few ulps of the operands' squared norms, so the
    bound is 8 float32 epsilons of the largest ||x||^2 + ||y||^2 a row sees."""
    pts = _cloud(n, seed=n)
    got = knn_sq_dists(torch.as_tensor(pts), k=3, row_block=row_block,
                       col_block=col_block).numpy()
    want = np.asarray(jknn(jnp.asarray(pts), k=3, row_block=row_block, col_block=col_block))
    sq = (pts.astype(np.float64) ** 2).sum(1)
    bound = 8 * np.finfo(np.float32).eps * (sq[:, None] + sq.max())
    assert got.shape == want.shape == (n, 3)
    assert np.all(np.abs(got - want) <= bound), np.abs(got - want).max()
    assert np.all(np.diff(got, axis=1) >= 0)  # ascending
    # and the definition, in float64
    d2 = ((pts[:, None, :].astype(np.float64) - pts[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    np.testing.assert_allclose(got, np.sort(d2, axis=1)[:, :3], atol=bound.max(), rtol=1e-5)


def test_knn_exact_small_and_mean():
    pts = torch.tensor([[0.0, 0, 0], [1, 0, 0], [0, 2, 0], [0, 0, 3], [5, 5, 5]])
    np.testing.assert_allclose(knn_sq_dists(pts)[0].numpy(), [1, 4, 9], rtol=1e-6)
    np.testing.assert_allclose(mean_knn_sq_dist(pts).numpy(),
                               np.asarray(jmean(jnp.asarray(pts.numpy()))), rtol=1e-6)


@pytest.mark.parametrize("sh_degree,feature_dim", [(3, 16), (1, 0)])
def test_from_point_cloud_matches_jax(sh_degree, feature_dim):
    rng = np.random.default_rng(sh_degree)
    xyz = _cloud(300, seed=7)
    xyz[:2] = xyz[2]  # duplicates: a zero 3-NN distance takes the 1e-7 floor
    xyz[:3] = xyz[3]
    rgb = rng.uniform(0, 1, size=(300, 3)).astype(np.float32)
    want = JScene.from_point_cloud(xyz, rgb, max_sh_degree=sh_degree, feature_dim=feature_dim)
    got = GaussianScene.from_point_cloud(xyz, rgb, max_sh_degree=sh_degree,
                                         feature_dim=feature_dim)
    assert got.max_sh_degree == want.max_sh_degree == sh_degree
    for k in ("means", "sh", "opacities_raw", "quats"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    # isotropic scales: exp(2 scale) is the floored mean 3-NN squared
    # distance, held to the bound of test_knn_matches_jax (plus exp/log
    # rounding)
    sq = (xyz.astype(np.float64) ** 2).sum(1)
    bound = 8 * np.finfo(np.float32).eps * (sq + sq.max())
    d2_got = np.exp(2 * got.scales_raw.numpy().astype(np.float64))
    d2_want = np.exp(2 * np.asarray(want.scales_raw, np.float64))
    assert np.all(np.abs(d2_got - d2_want) <= bound[:, None] + 1e-6 * d2_want)
    assert np.all(got.scales_raw.numpy() == got.scales_raw.numpy()[:, :1])
    np.testing.assert_allclose(got.scales_raw[:3].numpy(), np.log(np.sqrt(1e-7)), rtol=1e-6)
    # given the same distances, the scales agree to float32 rounding
    d = np.asarray(jmean(jnp.asarray(xyz)))
    same = GaussianScene.from_point_cloud(xyz, rgb, max_sh_degree=sh_degree,
                                          feature_dim=feature_dim, knn_mean_sq_dist=d)
    np.testing.assert_allclose(same.scales_raw.numpy(), np.asarray(want.scales_raw), rtol=1e-6,
                               atol=1e-6)
    if feature_dim:
        assert got.semantic_features.shape == (300, feature_dim)
        assert not got.semantic_features.any()
    else:
        assert got.semantic_features is None and want.semantic_features is None
