"""Camera model (port of gags_tpu.core.camera).

A `Camera` holds the standard world→camera matrix and pinhole intrinsics
as float32 tensors, plus the image size. Conventions are COLMAP / OpenCV:
x right, y down, z forward.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def fov_to_focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal_to_fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def world_to_view(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """4x4 world→camera matrix from a camera-to-world rotation R (as the
    3DGS loaders store it) and the COLMAP translation t."""
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    return Rt.astype(np.float32)


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    """The OpenGL-style perspective matrix (4, 4) float32 of the reference's
    viewer cameras; the rasterizer works from pinhole intrinsics."""
    top = math.tan(fovy / 2.0) * znear
    right = math.tan(fovx / 2.0) * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def intrinsics_from_fov(fovx: float, fovy: float, width: int, height: int) -> np.ndarray:
    """3x3 K from FoV, principal point at the image centre."""
    fx = fov_to_focal(fovx, width)
    fy = fov_to_focal(fovy, height)
    return np.array(
        [[fx, 0.0, width / 2.0], [0.0, fy, height / 2.0], [0.0, 0.0, 1.0]],
        dtype=np.float32,
    )


def look_at(eye: np.ndarray, target: np.ndarray, up: np.ndarray) -> np.ndarray:
    """World→camera viewmat looking from `eye` toward `target` (+z forward)."""
    eye = np.asarray(eye, dtype=np.float64)
    fwd = np.asarray(target, dtype=np.float64) - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, dtype=np.float64))
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    R_wc = np.stack([right, down, fwd], axis=0)
    t = -R_wc @ eye
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = R_wc
    out[:3, 3] = t
    return out


@dataclasses.dataclass(frozen=True)
class Camera:
    """A posed pinhole camera; `viewmat` (4, 4) and `K` (3, 3) are float32."""

    viewmat: torch.Tensor
    K: torch.Tensor
    width: int
    height: int
    znear: float = 0.01
    zfar: float = 100.0
    name: str = ""

    @property
    def fovx(self) -> float:
        return focal_to_fov(float(self.K[0, 0]), self.width)

    @property
    def fovy(self) -> float:
        return focal_to_fov(float(self.K[1, 1]), self.height)

    @property
    def campos(self) -> torch.Tensor:
        """Camera centre in world coordinates: -R^T t."""
        R = self.viewmat[:3, :3]
        t = self.viewmat[:3, 3]
        return -(R.T @ t)

    def resized(self, width: int, height: int) -> "Camera":
        """The camera rendering at another resolution: fx and cx scaled by
        width / self.width, fy and cy by height / self.height."""
        sx = width / self.width
        sy = height / self.height
        scale = torch.tensor([[sx, 1.0, sx], [1.0, sy, sy], [1.0, 1.0, 1.0]],
                             dtype=self.K.dtype, device=self.K.device)
        return dataclasses.replace(self, K=self.K * scale, width=int(width), height=int(height))

    def to(self, device) -> "Camera":
        return dataclasses.replace(
            self, viewmat=self.viewmat.to(device), K=self.K.to(device)
        )

    @staticmethod
    def from_colmap(R: np.ndarray, t: np.ndarray, fovx: float, fovy: float,
                    width: int, height: int, name: str = "", znear: float = 0.01,
                    zfar: float = 100.0) -> "Camera":
        """Camera from a camera-to-world rotation R, the COLMAP translation
        t and the fields of view (tensors on the CPU)."""
        return Camera(
            viewmat=torch.as_tensor(world_to_view(R, t)),
            K=torch.as_tensor(intrinsics_from_fov(fovx, fovy, width, height)),
            width=int(width), height=int(height), znear=znear, zfar=zfar, name=name,
        )
