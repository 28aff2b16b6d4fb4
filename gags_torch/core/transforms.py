"""Quaternion and activation helpers (port of gags_tpu.core.transforms)."""

from __future__ import annotations

import torch


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternions (unnormalised ok) → (..., 3, 3) rotations."""
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1.0 - x))


def build_scaling_rotation(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """L = R @ diag(s), (..., 3, 3): the factor of the 3D covariance."""
    return quat_to_rotmat(quats) * scales[..., None, :]


def build_covariance_3d(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """Sigma = R S S^T R^T, (..., 3, 3), in float32 (L L^T)."""
    m = build_scaling_rotation(scales, quats)
    return m @ m.transpose(-1, -2)


def strip_symmetric(cov: torch.Tensor) -> torch.Tensor:
    """The upper triangle of symmetric (..., 3, 3) as (..., 6): xx, xy, xz,
    yy, yz, zz."""
    return torch.stack([cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2], cov[..., 1, 1],
                        cov[..., 1, 2], cov[..., 2, 2]], dim=-1)
