"""World→screen projection of 3D Gaussians (EWA splatting), port of
gags_tpu.splat.projection.

Perspective EWA with the FoV-clamped Jacobian, a +0.3 px^2 low-pass on the
2D covariance, tight per-axis extents shrunk to the alpha-floor contour
when opacities are given, and a border cull on the geometric 3-sigma box.
Every 3x3 product is written out elementwise in the same order as the JAX
package, so both packages give the same float32 values on the CPU.

On CUDA tensors the projection is kernel J2 (`csrc/project.cu`): one
launch forward, which equals this chain on the card bit for bit, and one
backward (`project_table`'s VJP) in place of autograd's ~440. On CPU
tensors this elementwise chain runs, and autograd through it is the
backward.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.autograd.function import once_differentiable

from gags_torch.splat import kernels

EPS2D = 0.3
NEAR_PLANE = 0.01
FAR_PLANE = 1e10
RADIUS_CLIP = 0.0


class ProjectedGaussians(NamedTuple):
    means2d: torch.Tensor  # (N, 2) pixel coords
    conics: torch.Tensor  # (N, 3) upper triangle (a, b, c) of the inverse 2D cov
    depths: torch.Tensor  # (N,) camera-space z
    radii: torch.Tensor  # (N,) int32 3-sigma max-axis radius, 0 = culled
    compensations: torch.Tensor  # (N,) AA opacity scale (1.0 when unused)
    radii_x: torch.Tensor  # (N,) int32 tight x half-extent, 0 = culled
    radii_y: torch.Tensor  # (N,) int32 tight y half-extent


def effective_opacity(opacities: torch.Tensor, compensations: torch.Tensor) -> torch.Tensor:
    """The opacity the blend floors against: opacity × AA compensation."""
    return opacities * compensations


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def project_gaussians_plain(
    means: torch.Tensor,
    quats: torch.Tensor,
    scales: torch.Tensor,
    viewmat: torch.Tensor,
    K: torch.Tensor,
    width: int,
    height: int,
    eps2d: float = EPS2D,
    near_plane: float = NEAR_PLANE,
    far_plane: float = FAR_PLANE,
    antialiased: bool = False,
    opacities: Optional[torch.Tensor] = None,
) -> ProjectedGaussians:
    """`project_gaussians` as an elementwise chain, differentiable by
    autograd (J2's plain version)."""
    w0, w1, w2 = means[:, 0], means[:, 1], means[:, 2]
    q0, q1, q2, q3 = quats[:, 0], quats[:, 1], quats[:, 2], quats[:, 3]
    s0, s1, s2 = scales[:, 0], scales[:, 1], scales[:, 2]
    vm = viewmat.to(means.dtype)
    Kf = K.to(means.dtype)
    r00, r01, r02 = vm[0, 0], vm[0, 1], vm[0, 2]
    r10, r11, r12 = vm[1, 0], vm[1, 1], vm[1, 2]
    r20, r21, r22 = vm[2, 0], vm[2, 1], vm[2, 2]
    t0, t1, t2 = vm[0, 3], vm[1, 3], vm[2, 3]
    fx, fy = Kf[0, 0], Kf[1, 1]
    cx, cy = Kf[0, 2], Kf[1, 2]

    # world → camera
    px_cam = r00 * w0 + r01 * w1 + r02 * w2 + t0
    py_cam = r10 * w0 + r11 * w1 + r12 * w2 + t1
    z = r20 * w0 + r21 * w1 + r22 * w2 + t2
    in_depth = (z > near_plane) & (z < far_plane)
    zs = torch.where(in_depth, z, torch.ones_like(z))

    # camera-frame covariance (R L)(R L)^T, L = R_quat diag(s)
    qden = torch.sqrt(q0 * q0 + q1 * q1 + q2 * q2 + q3 * q3 + 1e-24)
    qw, qx, qy, qz = q0 / qden, q1 / qden, q2 / qden, q3 / qden
    l00 = (1 - 2 * (qy * qy + qz * qz)) * s0
    l01 = 2 * (qx * qy - qw * qz) * s1
    l02 = 2 * (qx * qz + qw * qy) * s2
    l10 = 2 * (qx * qy + qw * qz) * s0
    l11 = (1 - 2 * (qx * qx + qz * qz)) * s1
    l12 = 2 * (qy * qz - qw * qx) * s2
    l20 = 2 * (qx * qz - qw * qy) * s0
    l21 = 2 * (qy * qz + qw * qx) * s1
    l22 = (1 - 2 * (qx * qx + qy * qy)) * s2
    m00 = r00 * l00 + r01 * l10 + r02 * l20
    m01 = r00 * l01 + r01 * l11 + r02 * l21
    m02 = r00 * l02 + r01 * l12 + r02 * l22
    m10 = r10 * l00 + r11 * l10 + r12 * l20
    m11 = r10 * l01 + r11 * l11 + r12 * l21
    m12 = r10 * l02 + r11 * l12 + r12 * l22
    m20 = r20 * l00 + r21 * l10 + r22 * l20
    m21 = r20 * l01 + r21 * l11 + r22 * l21
    m22 = r20 * l02 + r21 * l12 + r22 * l22
    c00 = m00 * m00 + m01 * m01 + m02 * m02
    c01 = m00 * m10 + m01 * m11 + m02 * m12
    c02 = m00 * m20 + m01 * m21 + m02 * m22
    c11 = m10 * m10 + m11 * m11 + m12 * m12
    c12 = m10 * m20 + m11 * m21 + m12 * m22
    c22 = m20 * m20 + m21 * m21 + m22 * m22

    # perspective Jacobian with the FoV clamp
    tan_fovx = 0.5 * width / fx
    tan_fovy = 0.5 * height / fy
    lim_x = 1.3 * tan_fovx
    lim_y = 1.3 * tan_fovy
    tx = zs * _clip(px_cam / zs, -lim_x, lim_x)
    ty = zs * _clip(py_cam / zs, -lim_y, lim_y)
    rz = 1.0 / zs
    rz2 = rz * rz
    j00 = fx * rz
    j02 = -fx * tx * rz2
    j11 = fy * rz
    j12 = -fy * ty * rz2

    # cov2d = J cov_cam J^T
    a = j00 * (j00 * c00 + j02 * c02) + j02 * (j00 * c02 + j02 * c22)
    b = j00 * (j11 * c01 + j12 * c02) + j02 * (j11 * c12 + j12 * c22)
    c = j11 * (j11 * c11 + j12 * c12) + j12 * (j11 * c12 + j12 * c22)

    det_orig = a * c - b * b
    a_b = a + eps2d
    c_b = c + eps2d
    det = a_b * c_b - b * b
    comp = torch.sqrt(torch.clamp_min(det_orig / torch.clamp_min(det, 1e-30), 0.0))
    compensations = comp if antialiased else torch.ones_like(comp)

    valid_det = det > 0
    inv_det = 1.0 / torch.where(valid_det, det, torch.ones_like(det))
    conic_a = c_b * inv_det
    conic_b = -b * inv_det
    conic_c = a_b * inv_det

    # screen position and extents
    mx = fx * px_cam * rz + cx
    my = fy * py_cam * rz + cy
    bmid = 0.5 * (a_b + c_b)
    v1 = bmid + torch.sqrt(torch.clamp_min(bmid * bmid - det, 0.01))
    radius = torch.ceil(3.0 * torch.sqrt(v1))
    if opacities is None:
        k = 3.0
    else:
        o_eff = effective_opacity(opacities, compensations)
        k = torch.sqrt(
            2.0 * torch.clamp_min(torch.log(255.0 * torch.clamp_min(o_eff, 1e-12)), 0.0)
        )
        k = torch.clamp_max(k, 3.0).detach()
    sx = torch.sqrt(torch.clamp_min(a_b, 0.0))
    sy = torch.sqrt(torch.clamp_min(c_b, 0.0))
    rx = torch.ceil(k * sx)
    ry = torch.ceil(k * sy)

    # border cull on the geometric 3-sigma box (shrunk extents never flip it)
    rx3 = torch.ceil(3.0 * sx)
    ry3 = torch.ceil(3.0 * sy)
    inside = (mx + rx3 > 0) & (mx - rx3 < width) & (my + ry3 > 0) & (my - ry3 < height)
    valid = in_depth & valid_det & (radius > RADIUS_CLIP) & inside
    zero = torch.zeros_like(radius)

    return ProjectedGaussians(
        means2d=torch.stack([mx, my], dim=-1),
        conics=torch.stack([conic_a, conic_b, conic_c], dim=-1),
        depths=z,
        radii=torch.where(valid, radius, zero).to(torch.int32),
        compensations=compensations,
        radii_x=torch.where(valid, rx, zero).to(torch.int32),
        radii_y=torch.where(valid, ry, zero).to(torch.int32),
    )


def geom_table(proj: ProjectedGaussians, opacities: torch.Tensor) -> torch.Tensor:
    """(N+1, 8) table [mx, my, ca, cb, cc, opac, 0, 0] with a zero
    (opacity-0) sentinel row; differentiable where its inputs are."""
    n = proj.means2d.shape[0]
    rows = torch.cat([proj.means2d, proj.conics,
                      effective_opacity(opacities, proj.compensations)[:, None],
                      proj.means2d.new_zeros((n, 2))], dim=1)
    return torch.cat([rows, rows.new_zeros((1, 8))])


def _camera(viewmat, K, means):
    return (viewmat.to(device=means.device, dtype=means.dtype),
            K.to(device=means.device, dtype=means.dtype))


def project_gaussians(
    means: torch.Tensor,
    quats: torch.Tensor,
    scales: torch.Tensor,
    viewmat: torch.Tensor,
    K: torch.Tensor,
    width: int,
    height: int,
    eps2d: float = EPS2D,
    near_plane: float = NEAR_PLANE,
    far_plane: float = FAR_PLANE,
    antialiased: bool = False,
    opacities: Optional[torch.Tensor] = None,
) -> ProjectedGaussians:
    """Project N Gaussians into one camera.

    means (N, 3), quats (N, 4) wxyz, scales (N, 3) activated, viewmat
    (4, 4) world→camera, K (3, 3). With `opacities`, radii_x/radii_y shrink
    to the alpha-floor contour (image-exact). Culled Gaussians get radii 0.
    On CUDA tensors one launch of J2, whose outputs carry no gradient
    (`project_table` is the differentiable form); on CPU tensors the plain
    chain, differentiable by autograd.
    """
    if not kernels._dispatch(means):
        return project_gaussians_plain(means, quats, scales, viewmat, K, width, height, eps2d,
                                       near_plane, far_plane, antialiased, opacities)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (means, quats, scales, opacities)):
        raise ValueError("project_gaussians: no gradient on CUDA; project_table carries one")
    vm, Kf = _camera(viewmat, K, means)
    proj, _ = kernels.project_forward(
        means, quats, scales, vm, Kf, width, height, eps2d=eps2d, near_plane=near_plane,
        far_plane=far_plane, antialiased=antialiased, opacities=opacities,
        extents=opacities is not None)
    return ProjectedGaussians(*proj)


_CONSTANTS = dict(eps2d=EPS2D, near_plane=NEAR_PLANE, far_plane=FAR_PLANE)


@torch.no_grad()
def project_table_only(means, quats, scales, opacities, viewmat, K, width: int,
                       height: int) -> torch.Tensor:
    """`project_table`'s (N+1, 8) geometry table alone, without gradient
    or antialiasing, for a caller that bins nothing (the GAD step, whose
    binning is made once a camera). CUDA: one J2 launch that writes the
    table only."""
    if not kernels._dispatch(means):
        return geom_table(project_gaussians_plain(means, quats, scales, viewmat, K, width, height),
                          opacities)
    vm, Kf = _camera(viewmat, K, means)
    _, table = kernels.project_forward(means, quats, scales, vm, Kf, width, height,
                                       antialiased=False, opacities=opacities, table=True,
                                       projection=False, **_CONSTANTS)
    return table


class _ProjectTable(torch.autograd.Function):
    """The projection and the geometry table in one forward; the table is
    differentiable with respect to means, quats, scales, opacities and
    the tap. CUDA: J2's two launches. CPU: the plain chain forward and, in
    the backward, autograd through the chain recomputed without the
    extents (integers no gradient reads) and `geom_table`; the tap's
    gradient is the table's means2d columns either way."""

    @staticmethod
    def forward(ctx, means, quats, scales, opacities, tap, viewmat, K, width, height, extents,
                antialiased):
        if kernels._dispatch(means):
            proj, table = kernels.project_forward(
                means, quats, scales, viewmat, K, width, height, antialiased=antialiased,
                opacities=opacities, extents=extents, tap=tap, table=True, **_CONSTANTS)
        else:
            proj = project_gaussians_plain(means, quats, scales, viewmat, K, width, height,
                                           antialiased=antialiased,
                                           opacities=opacities if extents else None)
            tapped = proj if tap is None else proj._replace(means2d=proj.means2d + tap)
            table = geom_table(tapped, opacities)
        ctx.save_for_backward(means, quats, scales, opacities, viewmat, K)
        ctx.args = (width, height, antialiased)
        ctx.mark_non_differentiable(*proj)
        return (*proj, table)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        g_table = grads[-1]
        means, quats, scales, opacities, viewmat, K = ctx.saved_tensors
        width, height, antialiased = ctx.args
        n = means.shape[0]
        if kernels._dispatch(means):
            g = kernels.project_backward(means, quats, scales, opacities, viewmat, K, width,
                                         height, g_table, antialiased=antialiased, **_CONSTANTS)
        else:
            inputs = [t.detach().requires_grad_(True) for t in (means, quats, scales, opacities)]
            with torch.enable_grad():
                proj = project_gaussians_plain(*inputs[:3], viewmat, K, width, height,
                                               antialiased=antialiased)
                table = geom_table(proj, inputs[3])
            g = torch.autograd.grad(table, inputs, g_table, allow_unused=True)
        g = [gi if need else None for gi, need in zip(g, ctx.needs_input_grad[:4])]
        g_tap = g_table[:n, :2] if ctx.needs_input_grad[4] else None
        return (*g, g_tap) + (None,) * 6



def project_table(means, quats, scales, opacities, viewmat, K, width: int, height: int, *,
                  extents: bool = True, means2d_tap: Optional[torch.Tensor] = None,
                  antialiased: bool = False):
    """One projection for the binning and the blend: the projected
    Gaussians (radii_x / radii_y shrunk to the opacities' alpha-floor
    contour when `extents`), which carry no gradient, and the (N+1, 8)
    geometry table [mx, my, ca, cb, cc, opacity x compensation, 0, 0]
    with its zero sentinel row, differentiable with respect to means,
    quats, scales, opacities and `means2d_tap` (an optional (N, 2) zero
    tensor added to the table's mx, my: its gradient is dL/dmeans2d).
    CUDA: J2 forward and backward, one launch each. Returns
    (ProjectedGaussians, table)."""
    vm, Kf = _camera(viewmat, K, means)
    out = _ProjectTable.apply(means, quats, scales, opacities, means2d_tap, vm, Kf, width,
                              height, extents, antialiased)
    return ProjectedGaussians(*out[:7]), out[7]
