"""Plain tile rasterizer: the benchmark's reference for every render the
port's kernels produce (K1, K5 forward; K2, K8 backward through autograd).

Plain PyTorch, float32, imports nothing of the program. The semantics are
those of 3D Gaussian splatting as the port states them (EWA projection
with a 0.3 px^2 low-pass, tight per-axis extents at the alpha-floor
contour, 32x32 tiles, front-to-back compositing per pixel with alpha
floor 1/255, alpha clamp 0.999, a splat that would take the
transmittance below 1e-4 ends the pixel). The projection is written out
elementwise as the port's plain version writes it, a frozen copy.

A render runs in two passes. `walk` evaluates every (pixel, instance)
pair of the tile lists densely, a group of tiles at a time, without
gradient, and returns the pairs that blend (pixel, Gaussian, weight) in
pixel-major, front-to-back order, with the pair counts of a roofline
bound. `composite` then recomputes those pairs' alphas from
differentiable geometry, so autograd gives the geometry gradients; a
colour-only render (GAD) needs only the weights of the first pass.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

ALPHA_FLOOR = 1.0 / 255.0
ALPHA_CLAMP = 0.999
T_EPS = 1e-4
TILE = 32
EPS2D = 0.3
NEAR_PLANE = 0.01
FAR_PLANE = 1e10
GROUP_ELEMS = 1 << 25  # (tiles x pixels x instances) evaluated at once


class Projected(NamedTuple):
    means2d: torch.Tensor  # (N, 2)
    conics: torch.Tensor  # (N, 3)
    depths: torch.Tensor  # (N,)
    radii: torch.Tensor  # (N,) int32 3-sigma radius, 0 = culled
    radii_x: torch.Tensor  # (N,) int32
    radii_y: torch.Tensor  # (N,) int32


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def project(means, quats, scales, opacities, viewmat, K, width: int, height: int) -> Projected:
    """Perspective EWA projection of N Gaussians (quats wxyz, scales and
    opacities activated); differentiable in every input."""
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
    px_cam = r00 * w0 + r01 * w1 + r02 * w2 + t0
    py_cam = r10 * w0 + r11 * w1 + r12 * w2 + t1
    z = r20 * w0 + r21 * w1 + r22 * w2 + t2
    in_depth = (z > NEAR_PLANE) & (z < FAR_PLANE)
    zs = torch.where(in_depth, z, torch.ones_like(z))
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
    a = j00 * (j00 * c00 + j02 * c02) + j02 * (j00 * c02 + j02 * c22)
    b = j00 * (j11 * c01 + j12 * c02) + j02 * (j11 * c12 + j12 * c22)
    c = j11 * (j11 * c11 + j12 * c12) + j12 * (j11 * c12 + j12 * c22)
    a_b = a + EPS2D
    c_b = c + EPS2D
    det = a_b * c_b - b * b
    valid_det = det > 0
    inv_det = 1.0 / torch.where(valid_det, det, torch.ones_like(det))
    conic_a = c_b * inv_det
    conic_b = -b * inv_det
    conic_c = a_b * inv_det
    mx = fx * px_cam * rz + cx
    my = fy * py_cam * rz + cy
    bmid = 0.5 * (a_b + c_b)
    v1 = bmid + torch.sqrt(torch.clamp_min(bmid * bmid - det, 0.01))
    radius = torch.ceil(3.0 * torch.sqrt(v1))
    k = torch.sqrt(2.0 * torch.clamp_min(torch.log(255.0 * torch.clamp_min(opacities, 1e-12)), 0.0))
    k = torch.clamp_max(k, 3.0).detach()
    sx = torch.sqrt(torch.clamp_min(a_b, 0.0))
    sy = torch.sqrt(torch.clamp_min(c_b, 0.0))
    rx = torch.ceil(k * sx)
    ry = torch.ceil(k * sy)
    rx3 = torch.ceil(3.0 * sx)
    ry3 = torch.ceil(3.0 * sy)
    inside = (mx + rx3 > 0) & (mx - rx3 < width) & (my + ry3 > 0) & (my - ry3 < height)
    valid = in_depth & valid_det & (radius > 0) & inside
    zero = torch.zeros_like(radius)
    return Projected(
        means2d=torch.stack([mx, my], dim=-1),
        conics=torch.stack([conic_a, conic_b, conic_c], dim=-1),
        depths=z,
        radii=torch.where(valid, radius, zero).to(torch.int32).detach(),
        radii_x=torch.where(valid, rx, zero).to(torch.int32).detach(),
        radii_y=torch.where(valid, ry, zero).to(torch.int32).detach(),
    )


class TileLists(NamedTuple):
    gauss: torch.Tensor  # (I,) Gaussian index of each instance, tile-major, front to back
    starts: torch.Tensor  # (T,) int64
    counts: torch.Tensor  # (T,) int64
    tiles_x: int
    tiles_y: int


@torch.no_grad()
def tile_lists(proj: Projected, width: int, height: int) -> TileLists:
    """Every Gaussian listed in each tile its rectangle [x0, x1) x [y0, y1)
    covers, the rectangle being its extents around its mean in tile units;
    each tile's list in depth order (ties by index)."""
    dev = proj.depths.device
    tiles_x, tiles_y = -(-width // TILE), -(-height // TILE)
    mx, my = proj.means2d[:, 0].detach(), proj.means2d[:, 1].detach()
    rx, ry = proj.radii_x.to(torch.float32), proj.radii_y.to(torch.float32)
    x0 = torch.clamp(torch.floor((mx - rx) / TILE), 0, tiles_x).long()
    x1 = torch.clamp(torch.ceil((mx + rx) / TILE), 0, tiles_x).long()
    y0 = torch.clamp(torch.floor((my - ry) / TILE), 0, tiles_y).long()
    y1 = torch.clamp(torch.ceil((my + ry) / TILE), 0, tiles_y).long()
    alive = (proj.radii_x > 0) & (proj.radii_y > 0)
    w = torch.where(alive, x1 - x0, 0)
    h = torch.where(alive, y1 - y0, 0)
    cnt = w * h
    depth = torch.where(cnt > 0, proj.depths.detach(), torch.full_like(proj.depths, math.inf))
    order = torch.argsort(depth, stable=True)
    order = order[cnt[order] > 0]
    c_o = cnt[order]
    gauss = torch.repeat_interleave(order, c_o)
    first = torch.repeat_interleave(torch.cumsum(c_o, 0) - c_o, c_o)
    j = torch.arange(gauss.shape[0], device=dev) - first
    wg = w[gauss]
    tile = (y0[gauss] + j // wg) * tiles_x + (x0[gauss] + j % wg)
    perm = torch.argsort(tile, stable=True)
    gauss, tile = gauss[perm], tile[perm]
    num_tiles = tiles_x * tiles_y
    counts = torch.bincount(tile, minlength=num_tiles)
    starts = torch.cumsum(counts, 0) - counts
    return TileLists(gauss, starts, counts, tiles_x, tiles_y)


class Walk(NamedTuple):
    pix: torch.Tensor  # (B,) int64 pixel index y * width + x of each blended pair
    gauss: torch.Tensor  # (B,) int64 Gaussian index
    weight: torch.Tensor  # (B,) alpha * transmittance in front
    t_final: torch.Tensor  # (H * W,) transmittance after the last blended splat
    walked: int  # pairs walked: each pixel up to the splat that ends it
    near: int  # walked pairs with sigma <= ln(255 op) + 0.01
    blended: int
    instances: int
    visible: int  # Gaussians with at least one instance


@torch.no_grad()
def walk(proj: Projected, opacities: torch.Tensor, lists: TileLists, width: int,
         height: int, want_pairs: bool = True) -> Walk:
    """The front-to-back walk of every in-image pixel over its tile's
    list, a group of tiles at a time; see the module docstring."""
    dev = opacities.device
    m2 = proj.means2d.detach()
    con = proj.conics.detach()
    geom = torch.cat([m2, con, opacities.detach()[:, None]], dim=1)  # (N, 6)
    geom = torch.cat([geom, geom.new_zeros((1, 6))])  # padding row, opacity 0
    pad_row = geom.shape[0] - 1
    num_tiles = lists.tiles_x * lists.tiles_y
    t_final = torch.ones((height * width,), dtype=torch.float32, device=dev)
    pix_out, g_out, w_out = [], [], []
    walked = near = blended = 0
    order = torch.argsort(lists.counts)
    counts_sorted = lists.counts[order].tolist()
    p_loc = torch.arange(TILE * TILE, device=dev)
    i = 0
    while i < num_tiles:
        cmax = max(counts_sorted[i], 1)
        n_t = max(1, min(num_tiles - i, GROUP_ELEMS // (TILE * TILE * cmax)))
        # the group's largest list is its last (lists sorted by length)
        cmax = max(counts_sorted[i + n_t - 1], 1)
        while n_t > 1 and n_t * TILE * TILE * cmax > GROUP_ELEMS:
            n_t -= 1
            cmax = max(counts_sorted[i + n_t - 1], 1)
        tiles = order[i:i + n_t]
        i += n_t
        if counts_sorted[i - 1] == 0:
            continue
        k = torch.arange(cmax, device=dev)
        cnt = lists.counts[tiles]
        inr = k[None, :] < cnt[:, None]  # (t, G)
        pos = torch.where(inr, lists.starts[tiles][:, None] + k[None, :], 0)
        gid = torch.where(inr, lists.gauss[pos], pad_row)  # (t, G)
        rows = geom[gid]  # (t, G, 6)
        tx, ty = tiles % lists.tiles_x, tiles // lists.tiles_x
        col = tx[:, None] * TILE + p_loc[None, :] % TILE  # (t, P)
        row = ty[:, None] * TILE + p_loc[None, :] // TILE
        in_img = (col < width) & (row < height)
        px = col.to(torch.float32)[:, :, None] + 0.5
        py = row.to(torch.float32)[:, :, None] + 0.5
        dx = px - rows[:, None, :, 0]
        dy = py - rows[:, None, :, 1]
        sigma = (0.5 * (rows[:, None, :, 2] * dx * dx + rows[:, None, :, 4] * dy * dy)
                 + rows[:, None, :, 3] * dx * dy)
        del dx, dy
        op = rows[:, None, :, 5]
        alpha = torch.clamp_max(op * torch.exp(-sigma), ALPHA_CLAMP)
        live = (sigma >= 0.0) & (alpha >= ALPHA_FLOOR)
        alpha = torch.where(live, alpha, 0.0)
        t_inc = torch.cumprod(1.0 - alpha, dim=2)
        kill = (alpha > 0.0) & (t_inc < T_EPS)
        killed = kill.any(dim=2)
        kidx = torch.where(killed, torch.argmax(kill.to(torch.uint8), dim=2),
                           cnt[:, None].expand_as(killed))  # (t, P)
        kk = k[None, None, :]
        use = (alpha > 0.0) & (kk < kidx[..., None]) & in_img[..., None]
        t_exc = torch.cat([torch.ones_like(t_inc[..., :1]), t_inc[..., :-1]], dim=2)
        tf = torch.gather(t_exc, 2, torch.clamp_max(kidx, cmax - 1)[..., None])[..., 0]
        tf = torch.where(killed, tf, t_inc[..., -1])
        n_walk = torch.where(killed, kidx + 1, cnt[:, None].expand_as(killed))
        walk_mask = (kk < n_walk[..., None]) & in_img[..., None]
        walked += int(walk_mask.sum())
        near += int((walk_mask & (sigma <= torch.log(255.0 * op) + 0.01)).sum())
        blended += int(use.sum())
        gpix = (row * width + col)
        t_final[gpix[in_img]] = tf[in_img]
        if want_pairs:
            tt, pp, kx = torch.nonzero(use, as_tuple=True)
            pix_out.append(gpix[tt, pp])
            g_out.append(gid[tt, kx])
            w_out.append((alpha * t_exc)[tt, pp, kx])
        del sigma, alpha, t_inc, t_exc, kill, use, live, walk_mask, op, rows
    if want_pairs and pix_out:
        pix = torch.cat(pix_out)
        gauss = torch.cat(g_out)
        weight = torch.cat(w_out)
        # pixel-major, front to back: a stable sort by pixel keeps each
        # pixel's pairs in list (depth) order
        srt = torch.argsort(pix, stable=True)
        pix, gauss, weight = pix[srt], gauss[srt], weight[srt]
    else:
        pix = gauss = torch.zeros((0,), dtype=torch.int64, device=dev)
        weight = torch.zeros((0,), dtype=torch.float32, device=dev)
    return Walk(pix, gauss, weight, t_final, walked, near, blended,
                int(lists.gauss.shape[0]), int(torch.unique(lists.gauss).numel()))


def render_colors(w: Walk, colors: torch.Tensor, width: int, height: int,
                  background: torch.Tensor | None = None) -> torch.Tensor:
    """(H, W, C) image of fixed geometry: sum of weight x colour per pixel
    (differentiable in `colors`) plus the background behind T_final."""
    c = colors.shape[1]
    img = colors.new_zeros((height * width, c)).index_add(
        0, w.pix, w.weight[:, None] * colors[w.gauss])
    if background is not None:
        img = img + w.t_final[:, None] * background[None, :]
    return img.reshape(height, width, c)


def composite(w: Walk, proj: Projected, opacities: torch.Tensor, colors: torch.Tensor,
              width: int, height: int):
    """(H, W, C) image and (H, W) alpha over the pairs the walk blended,
    their alphas recomputed from `proj`, `opacities` and `colors` with
    gradient. The transmittance in front of a pair is the product over its
    pixel's earlier pairs, taken as a sum of logarithms in float64."""
    m2 = proj.means2d[w.gauss]
    con = proj.conics[w.gauss]
    op = opacities[w.gauss]
    px = (w.pix % width).to(torch.float32) + 0.5
    py = torch.div(w.pix, width, rounding_mode="floor").to(torch.float32) + 0.5
    dx = px - m2[:, 0]
    dy = py - m2[:, 1]
    sigma = 0.5 * (con[:, 0] * dx * dx + con[:, 2] * dy * dy) + con[:, 1] * dx * dy
    alpha = torch.clamp_max(op * torch.exp(-sigma), ALPHA_CLAMP)
    lg = torch.log1p(-alpha.double())
    csum = torch.cumsum(lg, 0)
    n = w.pix.shape[0]
    first = torch.ones((n,), dtype=torch.bool, device=w.pix.device)
    if n > 1:
        first[1:] = w.pix[1:] != w.pix[:-1]
    start_idx = torch.cummax(torch.where(first, torch.arange(n, device=w.pix.device), 0), 0)[0]
    base = (csum - lg)[start_idx]
    t_before = torch.exp(csum - lg - base).to(torch.float32)
    wt = alpha * t_before
    npx = height * width
    c = colors.shape[1]
    img = colors.new_zeros((npx, c)).index_add(0, w.pix, wt[:, None] * colors[w.gauss])
    log_t = lg.new_zeros((npx,)).index_add(0, w.pix, lg)
    t_fin = torch.exp(log_t).to(torch.float32)
    return img.reshape(height, width, c), (1.0 - t_fin).reshape(height, width)
