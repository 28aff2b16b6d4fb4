"""Spherical-harmonics colour up to degree 3 (port of gags_tpu.core.sh)."""

from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """SH colour at directions `dirs` (..., 3); `sh` is (..., C, K) with
    K >= (deg+1)^2. Returns (..., C), before the +0.5 shift."""
    if not 0 <= deg <= 3:
        raise ValueError(f"SH degree {deg} outside [0, 3]")
    if sh.shape[-1] < (deg + 1) ** 2:
        raise ValueError("too few SH coefficients for the degree")
    result = SH_C0 * sh[..., 0]
    if deg > 0:
        x = dirs[..., 0:1]
        y = dirs[..., 1:2]
        z = dirs[..., 2:3]
        result = (
            result
            - SH_C1 * y * sh[..., 1]
            + SH_C1 * z * sh[..., 2]
            - SH_C1 * x * sh[..., 3]
        )
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (
                result
                + SH_C2[0] * xy * sh[..., 4]
                + SH_C2[1] * yz * sh[..., 5]
                + SH_C2[2] * (2.0 * zz - xx - yy) * sh[..., 6]
                + SH_C2[3] * xz * sh[..., 7]
                + SH_C2[4] * (xx - yy) * sh[..., 8]
            )
            if deg > 2:
                result = (
                    result
                    + SH_C3[0] * y * (3 * xx - yy) * sh[..., 9]
                    + SH_C3[1] * xy * z * sh[..., 10]
                    + SH_C3[2] * y * (4 * zz - xx - yy) * sh[..., 11]
                    + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[..., 12]
                    + SH_C3[4] * x * (4 * zz - xx - yy) * sh[..., 13]
                    + SH_C3[5] * z * (xx - yy) * sh[..., 14]
                    + SH_C3[6] * x * (xx - 3 * yy) * sh[..., 15]
                )
    return result


def sh_colors(deg: int, sh: torch.Tensor, means: torch.Tensor, campos: torch.Tensor) -> torch.Tensor:
    """3DGS colour: view direction, SH eval, +0.5, clamp at 0.

    sh: (N, K, 3), dc first. Returns (N, 3)."""
    dirs = means - campos[None, :]
    dirs = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-12)
    cols = eval_sh(deg, sh.transpose(-1, -2), dirs) + 0.5
    return torch.clamp_min(cols, 0.0)


def rgb_to_sh(rgb: torch.Tensor) -> torch.Tensor:
    return (rgb - 0.5) / SH_C0

