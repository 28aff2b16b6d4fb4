"""Camera paths, point-cloud utilities and the video writer of gags_torch
against gags_tpu on the same numpy inputs: campath (interpolate_path,
simple_interpolation, novel_camera), pose_paths (spiral_path,
spherify_path), pcd (euclidean_clusters, points_to_map,
position_encoding), video.write_video.

Tolerances: poses 1e-5 absolute (the same float64 numpy code, viewmats
float32); labels and maps equal; encodings 1e-6."""

import builtins

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gags_tpu.core.camera import look_at as jlook_at
from gags_tpu.utils import campath as jcampath
from gags_tpu.utils import pcd as jpcd
from gags_tpu.utils import pose_paths as jpose
from gags_torch.core.camera import Camera
from gags_torch.utils import campath, pcd, pose_paths, video

POSE_TOL = 1e-5


def _ring(n=6, seed=0):
    """Cameras on a jittered ring looking at the origin (c2w)."""
    rng = np.random.default_rng(seed)
    out = []
    for a in np.linspace(0, 2 * np.pi, n, endpoint=False) + rng.uniform(0, 0.3, n):
        eye = np.array([3 * np.cos(a), 0.3 * rng.normal(), 3 * np.sin(a)])
        out.append(np.linalg.inv(jlook_at(eye, rng.normal(0, 0.1, 3), np.array([0, -1.0, 0]))))
    return np.stack(out)


@pytest.mark.parametrize("const_speed", [False, True])
@pytest.mark.parametrize("n_keys", [4, 8])
def test_interpolate_path_matches(n_keys, const_speed):
    c2ws = _ring(n_keys, seed=n_keys)
    want = jcampath.interpolate_path(c2ws, 30, const_speed=const_speed)
    got = campath.interpolate_path(c2ws, 30, const_speed=const_speed)
    assert got.shape == (30, 4, 4)
    np.testing.assert_allclose(got, want, atol=POSE_TOL, rtol=0)


def test_simple_interpolation_matches():
    vms = np.stack([np.linalg.inv(c) for c in _ring(5, seed=1)])
    want = jcampath.simple_interpolation(vms, 4)
    got = campath.simple_interpolation(vms, 4)
    assert got.shape == (4 * 4 + 1, 4, 4)
    np.testing.assert_allclose(got, want, atol=POSE_TOL, rtol=0)


def test_novel_camera_keeps_template():
    K = torch.tensor([[50.0, 0, 16], [0, 50.0, 8], [0, 0, 1]])
    tpl = Camera(viewmat=torch.eye(4), K=K, width=32, height=16, znear=0.1, name="t")
    vm = np.linalg.inv(_ring(3)[1])
    cam = campath.novel_camera(vm, tpl, "novel_0001")
    assert cam.name == "novel_0001" and cam.viewmat.dtype == torch.float32
    assert (cam.width, cam.height, cam.znear) == (32, 16, 0.1) and torch.equal(cam.K, K)
    np.testing.assert_array_equal(cam.viewmat.numpy(), vm.astype(np.float32))


@pytest.mark.parametrize("kw", [dict(n_frames=24), dict(n_frames=10, n_rots=1, zrate=0.2,
                                                        focus_depth=2.5)])
def test_spiral_path_matches(kw):
    c2ws = _ring(7, seed=2)
    np.testing.assert_allclose(pose_paths.spiral_path(c2ws, **kw), jpose.spiral_path(c2ws, **kw),
                               atol=POSE_TOL, rtol=0)


def test_spherify_path_matches():
    c2ws = _ring(9, seed=3)
    got = pose_paths.spherify_path(c2ws, n_frames=16)
    np.testing.assert_allclose(got, jpose.spherify_path(c2ws, n_frames=16), atol=POSE_TOL, rtol=0)
    assert got.shape == (16, 4, 4) and got.dtype == np.float32


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_euclidean_clusters_match(dtype):
    """Several blobs, a chain and noise; labels equal (block = 64 so the
    blocked loop takes several row and column blocks)."""
    rng = np.random.default_rng(4)
    parts = [rng.normal(0, 0.01, (40, 3)) + c for c in rng.uniform(-2, 2, (5, 3))]
    parts.append(np.linspace(0, 0.6, 20)[:, None] * np.array([[1.0, 0, 0]]) + 3.0)
    parts.append(rng.uniform(-5, 5, (15, 3)))
    xyz = np.concatenate(parts).astype(dtype)
    xyz = xyz[rng.permutation(len(xyz))]
    want = jpcd.euclidean_clusters(xyz, eps=0.05, min_points=10)
    got = pcd.euclidean_clusters(torch.from_numpy(xyz), eps=0.05, min_points=10, block=64)
    np.testing.assert_array_equal(got, want)
    assert got.max() == 5 and (got == -1).sum() >= 15
    assert pcd.euclidean_clusters(np.zeros((0, 3))).shape == (0,)


def test_points_to_map_matches():
    rng = np.random.default_rng(5)
    uv = rng.integers(-2, 12, (200, 2))
    for vals in (rng.normal(size=200).astype(np.float32),
                 rng.normal(size=(200, 3)).astype(np.float32)):
        want = jpcd.points_to_map(uv, vals, (10, 9))
        got = pcd.points_to_map(torch.from_numpy(uv), torch.from_numpy(vals), (10, 9)).numpy()
        np.testing.assert_array_equal(got, want)  # later points overwrite, clipped


def test_position_encoding_matches():
    xyz = np.random.default_rng(6).normal(size=(7, 3)).astype(np.float32)
    want = np.asarray(jpcd.position_encoding(jnp.asarray(xyz), num_freqs=5))
    got = pcd.position_encoding(torch.from_numpy(xyz), num_freqs=5).numpy()
    assert got.shape == (7, 30)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_write_video_without_cv2_keeps_contract(tmp_path, monkeypatch, capsys):
    real_import = builtins.__import__

    def no_cv2(name, *a, **k):
        if name == "cv2":
            raise ImportError("no cv2")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    frames = [np.zeros((8, 8, 3), np.float32)] * 2
    assert video.write_video(str(tmp_path / "v" / "a.mp4"), frames) is False
    assert "cv2 unavailable" in capsys.readouterr().out
    assert video.write_video(str(tmp_path / "b.mp4"), []) is False
