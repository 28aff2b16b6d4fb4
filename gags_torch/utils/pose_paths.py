"""Classic NeRF camera paths, spiral and spherify (port of
gags_tpu.utils.pose_paths), for novel-view videos of forward-facing and
360-degree captures. numpy in, numpy out."""

from __future__ import annotations

import numpy as np

from gags_torch.core.camera import look_at


def _normalize(v):
    return v / (np.linalg.norm(v) + 1e-12)


def view_matrix(z: np.ndarray, up: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """c2w (3, 4) from forward vector, up hint and position."""
    vec2 = _normalize(z)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], axis=1)


def poses_avg(c2ws: np.ndarray) -> np.ndarray:
    center = c2ws[:, :3, 3].mean(0)
    vec2 = _normalize(c2ws[:, :3, 2].sum(0))
    up = c2ws[:, :3, 1].sum(0)
    return view_matrix(vec2, up, center)


def spiral_path(c2ws: np.ndarray, n_frames: int = 120, n_rots: int = 2, zrate: float = 0.5,
                focus_depth: float | None = None) -> np.ndarray:
    """(F, 4, 4) world→camera spiral around the average pose."""
    avg = poses_avg(c2ws)
    up = _normalize(c2ws[:, :3, 1].sum(0))
    rads = np.percentile(np.abs(c2ws[:, :3, 3] - avg[:, 3]), 90, axis=0) + 1e-6
    focus = focus_depth or float(np.mean(np.linalg.norm(c2ws[:, :3, 3], axis=1)))
    out = []
    for theta in np.linspace(0, 2 * np.pi * n_rots, n_frames, endpoint=False):
        offs = np.array([np.cos(theta), -np.sin(theta), -np.sin(theta * zrate)]) * rads
        pos = avg[:, 3] + avg[:, :3] @ offs
        lookat = avg[:, 3] + avg[:, :3] @ np.array([0, 0, focus])
        out.append(look_at(pos, lookat, -up))
    return np.stack(out).astype(np.float32)


def spherify_path(c2ws: np.ndarray, n_frames: int = 120) -> np.ndarray:
    """(F, 4, 4) world→camera orbit for inward-facing 360 captures: about
    the point closest to every camera axis, at their mean distance."""
    rays_o = c2ws[:, :3, 3]
    rays_d = c2ws[:, :3, 2]
    a = np.eye(3) - rays_d[..., None] * rays_d[:, None, :]
    b = (a @ rays_o[..., None]).sum(0)
    center = np.squeeze(np.linalg.inv(a.sum(0)) @ b)
    rad = float(np.mean(np.linalg.norm(rays_o - center, axis=1)))
    up = _normalize((rays_o - center).mean(0))
    # orthonormal basis with `up` as pole
    v0 = _normalize(np.cross(up, np.array([0.1, 0.2, 0.3])))
    v1 = np.cross(up, v0)
    out = []
    for th in np.linspace(0, 2 * np.pi, n_frames, endpoint=False):
        pos = center + rad * (np.cos(th) * v0 + np.sin(th) * v1) + 0.2 * rad * up
        out.append(look_at(pos, center, -up))
    return np.stack(out).astype(np.float32)
