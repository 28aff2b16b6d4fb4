"""gags_torch.core vs gags_tpu.core: camera, SH colours, transforms."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gags_tpu.core import camera as jcam
from gags_tpu.core import sh as jsh
from gags_tpu.core import transforms as jtr
from gags_torch.core import camera as tcam
from gags_torch.core import sh as tsh
from gags_torch.core import transforms as ttr

TOL = 1e-6


def _pose(seed):
    rng = np.random.default_rng(seed)
    eye = rng.uniform(-3, 3, 3)
    target = rng.uniform(-1, 1, 3) + np.array([0.0, 0.0, 5.0])
    return tcam.look_at(eye, target, np.array([0.0, -1.0, 0.0]))


def test_camera_helpers_match():
    for fov, px in [(math.radians(60), 640), (1.1, 333)]:
        assert tcam.fov_to_focal(fov, px) == jcam.fov_to_focal(fov, px)
        f = tcam.fov_to_focal(fov, px)
        assert tcam.focal_to_fov(f, px) == jcam.focal_to_fov(f, px)
    np.testing.assert_array_equal(
        tcam.intrinsics_from_fov(1.0, 0.7, 640, 480),
        jcam.intrinsics_from_fov(1.0, 0.7, 640, 480),
    )
    rng = np.random.default_rng(0)
    R, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    t = rng.normal(size=3)
    np.testing.assert_array_equal(tcam.world_to_view(R, t), jcam.world_to_view(R, t))
    eye, target, up = np.array([1.0, 2, -3]), np.array([0.0, 0, 5]), np.array([0.0, -1, 0])
    np.testing.assert_array_equal(tcam.look_at(eye, target, up), jcam.look_at(eye, target, up))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_campos_matches(seed):
    vm = _pose(seed)
    K = tcam.intrinsics_from_fov(1.0, 0.8, 64, 48)
    cj = jcam.Camera(viewmat=jnp.asarray(vm), K=jnp.asarray(K), width=64, height=48)
    ct = tcam.Camera(viewmat=torch.as_tensor(vm), K=torch.as_tensor(K), width=64, height=48)
    np.testing.assert_allclose(ct.campos.numpy(), np.asarray(cj.campos), atol=TOL, rtol=TOL)
    assert ct.fovx == pytest.approx(cj.fovx, rel=1e-12)
    assert ct.fovy == pytest.approx(cj.fovy, rel=1e-12)


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_sh_colors_match(deg):
    rng = np.random.default_rng(10 + deg)
    n = 64
    k = 25 if deg == 4 else 16  # degree 4 reads coefficients 16-24
    sh = (0.5 * rng.normal(size=(n, k, 3))).astype(np.float32)
    means = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    campos = np.array([0.1, -0.2, -4.0], np.float32)
    want = jsh.sh_colors(deg, jnp.asarray(sh), jnp.asarray(means), jnp.asarray(campos))
    got = tsh.sh_colors(deg, torch.as_tensor(sh), torch.as_tensor(means), torch.as_tensor(campos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_sh_degree_outside_range_refused():
    sh = np.zeros((4, 3, 36), np.float32)
    dirs = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (4, 1))
    with pytest.raises(AssertionError):
        jsh.eval_sh(5, jnp.asarray(sh), jnp.asarray(dirs))
    with pytest.raises(ValueError, match="outside"):
        tsh.eval_sh(5, torch.as_tensor(sh), torch.as_tensor(dirs))
    with pytest.raises(ValueError, match="too few"):
        tsh.eval_sh(4, torch.as_tensor(sh[..., :16]), torch.as_tensor(dirs))


def test_rgb_sh_roundtrip_and_inverse_sigmoid():
    rng = np.random.default_rng(3)
    rgb = rng.uniform(0, 1, size=(32, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tsh.rgb_to_sh(torch.as_tensor(rgb)).numpy(), np.asarray(jsh.rgb_to_sh(jnp.asarray(rgb))),
        atol=TOL, rtol=TOL,
    )
    p = rng.uniform(0.01, 0.99, size=(100,)).astype(np.float32)
    np.testing.assert_allclose(
        ttr.inverse_sigmoid(torch.as_tensor(p)).numpy(),
        np.asarray(jtr.inverse_sigmoid(jnp.asarray(p))), atol=TOL, rtol=TOL,
    )


def test_quat_to_rotmat_matches():
    q = np.random.default_rng(4).normal(size=(50, 4)).astype(np.float32)
    np.testing.assert_allclose(
        ttr.quat_to_rotmat(torch.as_tensor(q)).numpy(),
        np.asarray(jtr.quat_to_rotmat(jnp.asarray(q))), atol=TOL, rtol=TOL,
    )


def test_covariance_helpers_match():
    """build_scaling_rotation, build_covariance_3d (JAX's einsum at
    HIGHEST against a float32 matmul) and strip_symmetric."""
    rng = np.random.default_rng(6)
    q = rng.normal(size=(40, 4)).astype(np.float32)
    s = rng.uniform(0.01, 2.0, size=(40, 3)).astype(np.float32)
    tq, ts = torch.as_tensor(q), torch.as_tensor(s)
    np.testing.assert_allclose(ttr.build_scaling_rotation(ts, tq).numpy(),
                               np.asarray(jtr.build_scaling_rotation(jnp.asarray(s), jnp.asarray(q))),
                               atol=TOL, rtol=TOL)
    cov = ttr.build_covariance_3d(ts, tq)
    want = np.asarray(jtr.build_covariance_3d(jnp.asarray(s), jnp.asarray(q)))
    np.testing.assert_allclose(cov.numpy(), want, atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(ttr.strip_symmetric(cov).numpy(),
                                  np.asarray(jtr.strip_symmetric(jnp.asarray(cov.numpy()))))


@pytest.mark.parametrize("znear,zfar,fovx,fovy", [(0.01, 100.0, 1.2, 0.8), (0.2, 5.0, 0.3, 0.5)])
def test_projection_matrix_matches(znear, zfar, fovx, fovy):
    got = tcam.projection_matrix(znear, zfar, fovx, fovy)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jcam.projection_matrix(znear, zfar, fovx, fovy))
