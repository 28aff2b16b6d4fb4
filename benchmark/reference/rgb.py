"""Plain reference of the RGB 3D Gaussian splatting step that GAGS
pretrains with (3DGS's train.py): SH colours seen from the camera, the
projection and compositing with gradients into every Gaussian parameter,
L1 + 0.2 (1 - SSIM), per-group Adam (eps 1e-15, bias correction from the
global step), the densification statistics (the screen-space mean
gradient's norm in (W/2, H/2) units, views that saw each Gaussian, the
largest 3-sigma radius), and the densify step (clone, split, prune into
a fixed number of slots). Plain PyTorch in float32 with TF32 off.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import raster

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154,
         -0.4570457994644658, 1.445305721320277, -0.5900435899266435)
GROUPS = ("means", "sh_dc", "sh_rest", "opacities_raw", "scales_raw", "quats")
DEAD_Z = -1.0e9


def sh_colors(deg: int, sh: torch.Tensor, means: torch.Tensor, campos: torch.Tensor):
    """(N, 3) colours of SH (N, K, 3) up to degree 3 seen from `campos`,
    +0.5 and clamped at 0."""
    d = means - campos[None, :]
    d = d / (torch.linalg.norm(d, dim=-1, keepdim=True) + 1e-12)
    c = sh.transpose(-1, -2)  # (N, 3, K)
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    out = SH_C0 * c[..., 0]
    if deg > 0:
        out = out - SH_C1 * y * c[..., 1] + SH_C1 * z * c[..., 2] - SH_C1 * x * c[..., 3]
    if deg > 1:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        out = (out + SH_C2[0] * xy * c[..., 4] + SH_C2[1] * yz * c[..., 5]
               + SH_C2[2] * (2.0 * zz - xx - yy) * c[..., 6] + SH_C2[3] * xz * c[..., 7]
               + SH_C2[4] * (xx - yy) * c[..., 8])
    if deg > 2:
        out = (out + SH_C3[0] * y * (3 * xx - yy) * c[..., 9] + SH_C3[1] * xy * z * c[..., 10]
               + SH_C3[2] * y * (4 * zz - xx - yy) * c[..., 11]
               + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * c[..., 12]
               + SH_C3[4] * x * (4 * zz - xx - yy) * c[..., 13]
               + SH_C3[5] * z * (xx - yy) * c[..., 14] + SH_C3[6] * x * (xx - 3 * yy) * c[..., 15])
    return torch.clamp_min(out + 0.5, 0.0)


def gaussian_window(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32) - size // 2
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / torch.sum(g)


def ssim(img1: torch.Tensor, img2: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """3DGS's SSIM of (H, W, C) images: an 11-tap Gaussian window (sigma
    1.5), zero 'same' padding, C1 = 0.01^2, C2 = 0.03^2, mean over all."""
    k, c = win.shape[0], img1.shape[-1]
    w2 = (win[:, None] * win[None, :]).reshape(1, 1, k, k).expand(c, 1, k, k)

    def filt(x):
        return F.conv2d(x.permute(2, 0, 1)[None], w2, padding=k // 2, groups=c)[0].permute(1, 2, 0)

    mu1, mu2 = filt(img1), filt(img2)
    s1 = filt(img1 * img1) - mu1 * mu1
    s2 = filt(img2 * img2) - mu2 * mu2
    s12 = filt(img1 * img2) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / ((mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2))
    return torch.mean(m)


def expon_lr(step: float, lr_init: float, lr_final: float, delay_mult: float,
             max_steps: int) -> float:
    """3DGS's exponential position schedule, in float32."""
    f = np.float32
    t = np.clip(f(step) / f(max_steps), f(0), f(1))
    log_lerp = np.exp(np.log(f(lr_init)) * (f(1) - t) + np.log(f(lr_final)) * t)
    delay = f(delay_mult) + (f(1) - f(delay_mult)) * np.sin(f(0.5 * math.pi) * t)
    return float(f(delay * log_lerp))


@torch.no_grad()
def adam(p, g, m, v, lr, step, eps=1e-15, b1=0.9, b2=0.999):
    m.mul_(b1).add_(g, alpha=1 - b1)
    v.mul_(b2).addcmul_(g, g, value=1 - b2)
    t = np.float32(step + 1.0)
    mh = m / float(np.float32(1) - np.float32(b1) ** t)
    vh = v / float(np.float32(1) - np.float32(b2) ** t)
    p.sub_(lr * mh / (torch.sqrt(vh) + eps))


def loss_and_grads(params: Dict[str, torch.Tensor], viewmat, K, image, width, height,
                   sh_degree: int, win, lam: float = 0.2):
    """Loss, per-group gradients, the means2d gradient and the radii."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    sh = torch.cat([leaves["sh_dc"], leaves["sh_rest"]], dim=1)
    campos = -viewmat[:3, :3].T @ viewmat[:3, 3]
    colors = sh_colors(sh_degree, sh, leaves["means"], campos)
    opac = torch.sigmoid(leaves["opacities_raw"])
    proj = raster.project(leaves["means"], leaves["quats"], torch.exp(leaves["scales_raw"]), opac,
                          viewmat, K, width, height)
    m2 = proj.means2d
    m2.retain_grad()
    lists = raster.tile_lists(proj, width, height)
    walk = raster.walk(proj, opac, lists, width, height)
    del lists
    img, _alpha = raster.composite(walk, proj, opac, colors, width, height)
    l1 = torch.mean(torch.abs(img - image))
    loss = (1 - lam) * l1 + lam * (1.0 - ssim(img, image, win))
    loss.backward()
    grads = {k: leaves[k].grad for k in GROUPS}
    return float(loss.detach()), grads, m2.grad, proj.radii


def run_steps(params0: Dict[str, torch.Tensor], alive: torch.Tensor, steps, width: int,
              height: int, cfg: Dict, radius: float) -> Dict:
    """Follow the steps [(iteration, viewmat, K, image f32 (H, W, 3))]
    from fixed-capacity `params0` (slots not alive parked behind every
    camera). Returns each step's loss, the first step's gradient norms
    by group, each group's change norm after the last step and the
    densification statistics after it."""
    dev = params0["means"].device
    win = gaussian_window().to(dev)
    p = {k: v.clone() for k, v in params0.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    vv = {k: torch.zeros_like(v) for k, v in p.items()}
    cap = p["means"].shape[0]
    acc = torch.zeros((cap,), dtype=torch.float32, device=dev)
    denom = torch.zeros_like(acc)
    max_r = torch.zeros_like(acc)
    out = {"loss": [], "grad_norm": None}
    for i, (it, viewmat, K, image) in enumerate(steps):
        loss, grads, g_m2d, radii = loss_and_grads(p, viewmat, K, image, width, height,
                                                    min(it // 1000, cfg["sh_degree"]), win,
                                                    cfg["lambda_dssim"])
        out["loss"].append(loss)
        if i == 0:
            out["grad_norm"] = {k: float(torch.linalg.vector_norm(g.double()))
                                for k, g in grads.items()}
        lrs = dict(means=expon_lr(float(it), cfg["position_lr_init"] * radius,
                                  cfg["position_lr_final"] * radius, cfg["position_lr_delay_mult"],
                                  cfg["position_lr_max_steps"]),
                   sh_dc=cfg["feature_lr"], sh_rest=cfg["feature_lr"] / 20.0,
                   opacities_raw=cfg["opacity_lr"], scales_raw=cfg["scaling_lr"],
                   quats=cfg["rotation_lr"])
        for k in GROUPS:
            adam(p[k], grads[k], m[k], vv[k], lrs[k], i)
        with torch.no_grad():
            p["means"].copy_(park(p["means"], alive))
            g2d = torch.linalg.norm(torch.stack([g_m2d[:, 0] * (width * 0.5),
                                                 g_m2d[:, 1] * (height * 0.5)], -1), dim=-1)
            vis = radii > 0
            acc += torch.where(vis, g2d, 0.0)
            denom += vis.to(torch.float32)
            max_r.copy_(torch.maximum(max_r, radii.to(torch.float32)))
    out["change_norm"] = {k: float(torch.linalg.vector_norm((p[k] - params0[k]).double()))
                          for k in GROUPS}
    out["stats"] = dict(grad_accum=acc, denom=denom, max_radii=max_r)
    return out


def park(means, alive):
    parked = means.new_zeros((3,))
    parked[2] = DEAD_Z
    return torch.where(alive[:, None], means, parked)


def quat_to_rotmat(q):
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


@torch.no_grad()
def densify(params, alive, grad_accum, denom, noise, cfg: Dict, radius: float):
    """3DGS's densify-and-prune into fixed slots: the Gaussians whose mean
    screen-space gradient reaches the threshold clone (small) into the
    free slots in slot order, or split (large) into two children drawn
    from the parent (noise: two (cap, 3) unit normals), scales / 1.6, the
    parent freed; then the transparent ones are freed. Returns the new
    (params, alive). Every written slot's Adam moments restart at 0,
    which the caller reads from the returned `written` mask."""
    cap = alive.shape[0]
    grads = torch.where(denom > 0, grad_accum / denom, 0.0)
    scales = torch.exp(params["scales_raw"])
    sel = grads >= cfg["densify_grad_threshold"]
    small = torch.max(scales, dim=-1).values <= cfg["percent_dense"] * radius
    clone, split = sel & small & alive, sel & ~small & alive
    free = torch.nonzero(~alive)[:, 0]
    src_c = torch.nonzero(clone)[:, 0]
    src_s = torch.nonzero(split)[:, 0]
    dst = free.tolist()
    new = {k: v.clone() for k, v in params.items()}
    written = torch.zeros((cap,), dtype=torch.bool, device=alive.device)
    R = quat_to_rotmat(params["quats"])
    jobs = [(int(s), None) for s in src_c.tolist()]
    for s in src_s.tolist():
        jobs += [(int(s), 0), (int(s), 1)]
    n = min(len(jobs), len(dst))
    if n:
        src = torch.tensor([j[0] for j in jobs[:n]], device=alive.device)
        kind = torch.tensor([-1 if j[1] is None else j[1] for j in jobs[:n]], device=alive.device)
        d = torch.tensor(dst[:n], device=alive.device)
        for k, v in params.items():
            new[k][d] = v[src]
        for which in (0, 1):
            sel_k = kind == which
            s_k = src[sel_k]
            child = params["means"][s_k] + torch.einsum(
                "nij,nj->ni", R[s_k], noise[which][s_k] * scales[s_k])
            new["means"][d[sel_k]] = child
            new["scales_raw"][d[sel_k]] = params["scales_raw"][s_k] - math.log(0.8 * 2)
        written[d] = True
    new_alive = (alive | written) & ~split
    new_alive &= ~(alive & (torch.sigmoid(new["opacities_raw"]) < cfg["min_opacity"]))
    new["means"] = park(new["means"], new_alive)
    return new, new_alive, written
