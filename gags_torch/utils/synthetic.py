"""Synthetic Gaussian scenes for tests and the chip smoke run (copy of
gags_tpu.utils.synthetic: the same seed gives the same numpy arrays)."""

from __future__ import annotations

import math

import numpy as np
import torch

from gags_torch.core.camera import Camera, look_at


def make_scene(
    n: int,
    seed: int = 0,
    extent: float = 2.0,
    feature_dim: int = 16,
    scale_mean: float = -4.2,
    scale_std: float = 0.6,
):
    """Dict of numpy arrays: means, quats, scales (activated), opacities
    (activated), sh (N, 16, 3), features (N, feature_dim)."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-extent, extent, size=(n, 3)).astype(np.float32)
    means[:, 2] += 6.0  # push the cloud in front of the camera at the origin
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(rng.normal(scale_mean, scale_std, size=(n, 3))).astype(np.float32)
    opacities = rng.uniform(0.2, 0.95, size=(n,)).astype(np.float32)
    sh = np.zeros((n, 16, 3), np.float32)
    sh[:, 0, :] = rng.uniform(-1.5, 1.5, size=(n, 3))
    sh[:, 1:, :] = 0.1 * rng.normal(size=(n, 15, 3))
    features = rng.normal(size=(n, feature_dim)).astype(np.float32) * 0.3
    return dict(
        means=means,
        quats=quats,
        scales=scales,
        opacities=opacities,
        sh=sh.astype(np.float32),
        features=features,
    )


def make_camera(width: int, height: int, fov_deg: float = 60.0, dist: float = 0.0,
                device="cpu") -> Camera:
    fovx = math.radians(fov_deg)
    fx = width / (2 * math.tan(fovx / 2))
    viewmat = look_at(
        eye=np.array([0.0, 0.0, -dist]),
        target=np.array([0.0, 0.0, 6.0]),
        up=np.array([0.0, -1.0, 0.0]),
    )
    K = np.array([[fx, 0, width / 2.0], [0, fx, height / 2.0], [0, 0, 1]], np.float32)
    return Camera(
        viewmat=torch.as_tensor(viewmat, device=device),
        K=torch.as_tensor(K, device=device),
        width=width,
        height=height,
        name="synthetic",
    )
