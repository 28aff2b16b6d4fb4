"""Camera paths for novel-view videos (port of gags_tpu.utils.campath).

A B-spline through keyframe poses (scipy splprep / splev, optionally
resampled to constant speed) or linear in-betweens, both in the
(position, look-at point, up point) parameterisation, which avoids
rotation interpolation artefacts; `novel_camera` poses a template camera.
Poses are float numpy arrays; only `novel_camera` makes tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gags_torch.core.camera import Camera, look_at


def poses_to_points(c2ws: np.ndarray, dist: float = 1.0) -> np.ndarray:
    """(N, 4, 4) camera-to-world → (N, 3, 3): [position, lookat, up]."""
    pos = c2ws[:, :3, 3]
    lookat = pos + dist * c2ws[:, :3, 2]
    up = pos - dist * c2ws[:, :3, 1]
    return np.stack([pos, lookat, up], axis=1)


def points_to_poses(points: np.ndarray) -> np.ndarray:
    """(N, 3, 3) → (N, 4, 4) world→camera viewmats via look_at."""
    out = []
    for pos, lookat, upp in points:
        up_dir = pos - upp  # up is kept as pos - up_point
        out.append(look_at(pos, lookat, -up_dir))
    return np.stack(out)


def interpolate_path(c2ws: np.ndarray, n_out: int, smoothness: float = 0.03,
                     spline_degree: int = 5, const_speed: bool = False) -> np.ndarray:
    """Smooth B-spline through keyframe c2w poses → (n_out, 4, 4) viewmats."""
    from scipy import interpolate as si

    pts = poses_to_points(c2ws)  # (N, 3, 3)
    n, k, _ = pts.shape
    flat = pts.reshape(n, -1).T  # (9, N)
    deg = min(spline_degree, n - 1)
    tck, _ = si.splprep(flat, s=smoothness, k=deg)
    u = np.linspace(0, 1, n_out, endpoint=False)
    if const_speed:
        # resample u by arc length of the position curve
        uu = np.linspace(0, 1, 10 * n_out)
        dense = np.array(si.splev(uu, tck)).T.reshape(-1, k, 3)
        seg = np.linalg.norm(np.diff(dense[:, 0], axis=0), axis=-1)
        cum = np.concatenate([[0], np.cumsum(seg)])
        cum /= cum[-1] if cum[-1] > 0 else 1.0
        u = np.interp(np.linspace(0, 1, n_out, endpoint=False), cum, uu)
    out = np.array(si.splev(u, tck)).T.reshape(n_out, k, 3)
    return points_to_poses(out)


def simple_interpolation(viewmats: np.ndarray, factor: int) -> np.ndarray:
    """Linear in-between poses: `factor` a keyframe interval, positions
    and look-at / up points interpolated linearly."""
    c2ws = np.linalg.inv(viewmats)
    pts = poses_to_points(c2ws)
    out = []
    for i in range(len(pts) - 1):
        for t in np.linspace(0, 1, factor, endpoint=False):
            out.append(pts[i] * (1 - t) + pts[i + 1] * t)
    out.append(pts[-1])
    return points_to_poses(np.stack(out))


def novel_camera(viewmat: np.ndarray, template: Camera, name: str = "novel") -> Camera:
    """`template` (intrinsics, size, clip planes) at world→camera `viewmat`."""
    vm = torch.as_tensor(np.asarray(viewmat, np.float32), device=template.viewmat.device)
    return dataclasses.replace(template, viewmat=vm, name=name)
