"""Spherical-harmonics colour up to degree 4 (port of gags_tpu.core.sh).

On CUDA tensors `sh_colors` is kernel J3 (`csrc/sh.cu`), which takes
float32 only: one launch forward, which equals the eager chain on the
card bit for bit, and one backward (the closed-form VJP of
`sh_colors_backward_plain`) in place of autograd's ~300 launches. On CPU
tensors the eager chain runs, and autograd through it is the backward.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch
from torch.autograd.function import once_differentiable

from gags_torch import _kernels
from gags_torch.splat.kernels import _dispatch, _ptr, _stream

SH_SRC = Path(__file__).resolve().parent / "csrc" / "sh.cu"

launch_counts = {"sh_forward": 0, "sh_backward": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0

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
SH_C4 = (
    2.5033429417967046,
    -1.7701307697799304,
    0.9461746957575601,
    -0.6690465435572892,
    0.10578554691520431,
    -0.6690465435572892,
    0.47308734787878004,
    -1.7701307697799304,
    0.6258357354491761,
)


def _check_deg(deg: int, k: int) -> None:
    if not 0 <= deg <= 4:
        raise ValueError(f"SH degree {deg} outside [0, 4]")
    if k < (deg + 1) ** 2:
        raise ValueError("too few SH coefficients for the degree")


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """SH colour at directions `dirs` (..., 3); `sh` is (..., C, K) with
    K >= (deg+1)^2. Returns (..., C), before the +0.5 shift."""
    _check_deg(deg, sh.shape[-1])
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
                if deg > 3:
                    result = (
                        result
                        + SH_C4[0] * xy * (xx - yy) * sh[..., 16]
                        + SH_C4[1] * yz * (3 * xx - yy) * sh[..., 17]
                        + SH_C4[2] * xy * (7 * zz - 1) * sh[..., 18]
                        + SH_C4[3] * yz * (7 * zz - 3) * sh[..., 19]
                        + SH_C4[4] * (zz * (35 * zz - 30) + 3) * sh[..., 20]
                        + SH_C4[5] * xz * (7 * zz - 3) * sh[..., 21]
                        + SH_C4[6] * (xx - yy) * (7 * zz - 1) * sh[..., 22]
                        + SH_C4[7] * xz * (xx - 3 * yy) * sh[..., 23]
                        + SH_C4[8]
                        * (xx * (xx - 3 * yy) - yy * (3 * xx - yy))
                        * sh[..., 24]
                    )
    return result


def _unclamped(deg, sh, means, campos):
    dirs = means - campos[None, :]
    dirs = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-12)
    return eval_sh(deg, sh.transpose(-1, -2), dirs) + 0.5


def sh_colors_plain(deg: int, sh: torch.Tensor, means: torch.Tensor,
                    campos: torch.Tensor) -> torch.Tensor:
    """`sh_colors` as an elementwise chain, differentiable by autograd
    (J3's plain version)."""
    return torch.clamp_min(_unclamped(deg, sh, means, campos), 0.0)


def _basis_and_grads(deg: int, x, y, z):
    """[(basis k, its gradient in (x, y, z))] for k < (deg + 1)^2: the
    closed forms of eval_sh's polynomials."""
    zero = torch.zeros_like(x)
    c = SH_C0 + zero
    out = [(c, (zero, zero, zero))]
    if deg > 0:
        c1 = SH_C1 + zero
        out += [(-SH_C1 * y, (zero, -c1, zero)), (SH_C1 * z, (zero, zero, c1)),
                (-SH_C1 * x, (-c1, zero, zero))]
    if deg > 1:
        xx, yy, zz = x * x, y * y, z * z
        a, b, c, d, e = SH_C2
        out += [(a * x * y, (a * y, a * x, zero)), (b * y * z, (zero, b * z, b * y)),
                (c * (2 * zz - xx - yy), (-2 * c * x, -2 * c * y, 4 * c * z)),
                (d * x * z, (d * z, zero, d * x)), (e * (xx - yy), (2 * e * x, -2 * e * y, zero))]
    if deg > 2:
        c = SH_C3
        out += [
            (c[0] * y * (3 * xx - yy), (c[0] * 6 * x * y, c[0] * 3 * (xx - yy), zero)),
            (c[1] * x * y * z, (c[1] * y * z, c[1] * x * z, c[1] * x * y)),
            (c[2] * y * (4 * zz - xx - yy),
             (-2 * c[2] * x * y, c[2] * (4 * zz - xx - 3 * yy), 8 * c[2] * y * z)),
            (c[3] * z * (2 * zz - 3 * xx - 3 * yy),
             (-6 * c[3] * x * z, -6 * c[3] * y * z, c[3] * (6 * zz - 3 * xx - 3 * yy))),
            (c[4] * x * (4 * zz - xx - yy),
             (c[4] * (4 * zz - 3 * xx - yy), -2 * c[4] * x * y, 8 * c[4] * x * z)),
            (c[5] * z * (xx - yy), (2 * c[5] * x * z, -2 * c[5] * y * z, c[5] * (xx - yy))),
            (c[6] * x * (xx - 3 * yy), (3 * c[6] * (xx - yy), -6 * c[6] * x * y, zero)),
        ]
    if deg > 3:
        c = SH_C4
        a1, a3 = 7 * zz - 1, 7 * zz - 3
        out += [
            (c[0] * x * y * (xx - yy), (c[0] * y * (3 * xx - yy), c[0] * x * (xx - 3 * yy), zero)),
            (c[1] * y * z * (3 * xx - yy),
             (6 * c[1] * x * y * z, 3 * c[1] * z * (xx - yy), c[1] * y * (3 * xx - yy))),
            (c[2] * x * y * a1, (c[2] * y * a1, c[2] * x * a1, 14 * c[2] * x * y * z)),
            (c[3] * y * z * a3, (zero, c[3] * z * a3, c[3] * y * (21 * zz - 3))),
            (c[4] * (zz * (35 * zz - 30) + 3), (zero, zero, c[4] * z * (140 * zz - 60))),
            (c[5] * x * z * a3, (c[5] * z * a3, zero, c[5] * x * (21 * zz - 3))),
            (c[6] * (xx - yy) * a1, (2 * c[6] * x * a1, -2 * c[6] * y * a1,
                                     14 * c[6] * z * (xx - yy))),
            (c[7] * x * z * (xx - 3 * yy),
             (3 * c[7] * z * (xx - yy), -6 * c[7] * x * y * z, c[7] * x * (xx - 3 * yy))),
            (c[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy)),
             (4 * c[8] * x * (xx - 3 * yy), 4 * c[8] * y * (yy - 3 * xx), zero)),
        ]
    return out


def sh_colors_backward_plain(deg: int, sh: torch.Tensor, means: torch.Tensor,
                             campos: torch.Tensor, g_colors: torch.Tensor,
                             mask_dtype: torch.dtype = None):
    """J3's backward as closed forms in torch (its plain version): the
    gradients of sh (N, K, 3), exact zeros above (deg + 1)^2, and of the
    means, from the colours' gradient `g_colors` (N, 3), computed in the
    inputs' dtype. The clamp passes the gradient where the colour before
    it is >= 0 (as clamp_min's backward takes it), that colour computed by
    the eager chain in `mask_dtype` (default: the inputs'; J3 takes it
    from its float32 forward)."""
    _check_deg(deg, sh.shape[1])
    dt = mask_dtype or sh.dtype
    with torch.no_grad():
        pre = _unclamped(deg, sh.to(dt), means.to(dt), campos.to(dt))
    w = torch.where(pre >= 0, g_colors, torch.zeros_like(g_colors))  # (N, 3)
    d = means - campos[None, :]
    r = torch.linalg.norm(d, dim=-1)
    den = r + 1e-12
    x, y, z = (d / den[:, None]).unbind(-1)
    g_sh = torch.zeros_like(sh)
    g_dir = torch.zeros_like(d)
    for k, (b, grad) in enumerate(_basis_and_grads(deg, x, y, z)):
        g_sh[:, k] = w * b[:, None]
        ws = (w * sh[:, k]).sum(-1)
        g_dir += ws[:, None] * torch.stack(grad, dim=-1)
    # direction = d / (r + eps): the norm's term is 0 where r = 0, as its
    # backward takes it
    dot = (g_dir * d).sum(-1)
    k2 = torch.where(r > 0, dot / (den * den * torch.where(r > 0, r, torch.ones_like(r))),
                     torch.zeros_like(r))
    return g_sh, g_dir / den[:, None] - d * k2[:, None]


def _sh_inputs(deg, sh, means, campos):
    n = means.shape[0]
    _check_deg(deg, sh.shape[1])
    if tuple(sh.shape) != (n, sh.shape[1], 3) or tuple(means.shape) != (n, 3) or \
            tuple(campos.shape) != (3,):
        raise ValueError(f"J3: sh (N, K, 3), means (N, 3), campos (3,), got "
                         f"{tuple(sh.shape)}, {tuple(means.shape)}, {tuple(campos.shape)}")
    return n, sh.shape[1], sh.contiguous(), means.contiguous(), campos.contiguous()


def sh_forward(deg: int, sh: torch.Tensor, means: torch.Tensor,
               campos: torch.Tensor) -> torch.Tensor:
    """J3 forward: the colours (N, 3) of CUDA float32 inputs, bit for bit
    `sh_colors_plain`'s on the card."""
    n, k, sh, means, campos = _sh_inputs(deg, sh, means, campos)
    colors = torch.empty((n, 3), dtype=torch.float32, device=means.device)
    lib = _kernels.load(SH_SRC)
    fn = lib.gags_sh_forward
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    err = fn(_ptr(sh), _ptr(means), _ptr(campos), n, k, deg, _ptr(colors), _stream(means))
    _kernels.check(lib, err, "sh_forward")
    launch_counts["sh_forward"] += 1
    return colors


def sh_backward(deg: int, sh: torch.Tensor, means: torch.Tensor, campos: torch.Tensor,
                g_colors: torch.Tensor):
    """J3 backward: (g_sh (N, K, 3), g_means (N, 3)) from the colours'
    gradient, the clamp's mask from the float32 forward recomputed, the
    chain rule in float64 (`sh_colors_backward_plain`'s closed forms)."""
    n, k, sh, means, campos = _sh_inputs(deg, sh, means, campos)
    g_colors = g_colors.contiguous()
    if tuple(g_colors.shape) != (n, 3) or g_colors.dtype != torch.float32:
        raise ValueError(f"g_colors: expected float32 ({n}, 3), got {g_colors.dtype} "
                         f"{tuple(g_colors.shape)}")
    g_sh = torch.empty_like(sh)
    g_means = torch.empty_like(means)
    lib = _kernels.load(SH_SRC)
    fn = lib.gags_sh_backward
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    err = fn(_ptr(sh), _ptr(means), _ptr(campos), _ptr(g_colors), n, k, deg, _ptr(g_sh),
             _ptr(g_means), _stream(means))
    _kernels.check(lib, err, "sh_backward")
    launch_counts["sh_backward"] += 1
    return g_sh, g_means


class _SHColors(torch.autograd.Function):
    """J3's two launches as one differentiable function of sh and means."""

    @staticmethod
    def forward(ctx, deg, sh, means, campos):
        ctx.deg = deg
        ctx.save_for_backward(sh, means, campos)
        return sh_forward(deg, sh, means, campos)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_colors):
        sh, means, campos = ctx.saved_tensors
        g_sh, g_means = sh_backward(ctx.deg, sh, means, campos, g_colors)
        return (None, g_sh if ctx.needs_input_grad[1] else None,
                g_means if ctx.needs_input_grad[2] else None, None)


def sh_colors(deg: int, sh: torch.Tensor, means: torch.Tensor, campos: torch.Tensor) -> torch.Tensor:
    """3DGS colour: view direction, SH eval, +0.5, clamp at 0.

    sh: (N, K, 3), dc first. Returns (N, 3). CUDA tensors run J3, which
    takes float32 inputs and no gradient for campos (it raises on others);
    CPU tensors run the eager chain."""
    if not _dispatch(means):
        return sh_colors_plain(deg, sh, means, campos)
    for name, t in (("sh", sh), ("means", means), ("campos", campos)):
        if t.device != means.device or t.dtype != torch.float32:
            raise ValueError(f"sh_colors: {name} must be float32 on {means.device}, got "
                             f"{t.dtype} on {t.device}")
    if torch.is_grad_enabled() and campos.requires_grad:
        raise ValueError("sh_colors: no gradient for campos on CUDA")
    return _SHColors.apply(deg, sh, means, campos)


def rgb_to_sh(rgb: torch.Tensor) -> torch.Tensor:
    return (rgb - 0.5) / SH_C0


def sh_to_rgb(sh: torch.Tensor) -> torch.Tensor:
    return sh * SH_C0 + 0.5
