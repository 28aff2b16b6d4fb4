"""Depth-sample stage (GAS stage B): project Gaussians, min-depth splats
(port of gags_tpu.gas.depth_sampler).

Semantics:
  * round-to-nearest pixel, half to even (torch.round),
  * occlusion test |z - depth[v,u]| <= 0.25 * depth[v,u],
  * per-point min over cameras, then per-image splat of that min depth at
    the projected pixel, where the last visible point of a pixel wins.

The projection is written as elementwise products and sums in a fixed
order, so the card rounds every step as the CPU does and the pixel a point
lands on does not depend on the device (a matmul may sum in another order
or use TF32). The splat picks each pixel's last visible point by a
scatter of point indices with amax, which has one answer on any device
(an index_put_ with repeated indices has no defined winner on CUDA).
"""

from __future__ import annotations

from typing import Tuple

import torch

BIG = 1e9


def project_points(points: torch.Tensor, viewmat: torch.Tensor, K: torch.Tensor,
                   depth_map: torch.Tensor, width: int, height: int,
                   vis_thres: float = 0.25, cut_bound: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """points (N, 3), viewmat (4, 4), K (3, 3), depth_map (H, W) → (u (N,)
    int32, v (N,) int32, visible (N,) bool, z (N,) camera-space depth)."""
    x, y, zw = points[:, 0], points[:, 1], points[:, 2]

    def row(i):
        return x * viewmat[i, 0] + y * viewmat[i, 1] + zw * viewmat[i, 2] + viewmat[i, 3]

    px, py, z = row(0), row(1), row(2)
    zs = torch.where(z == 0, torch.full_like(z, 1e-9), z)
    u = torch.round(px * K[0, 0] / zs + K[0, 2]).to(torch.int32)
    v = torch.round(py * K[1, 1] / zs + K[1, 2]).to(torch.int32)
    inside = ((u >= cut_bound) & (v >= cut_bound)
              & (u < width - cut_bound) & (v < height - cut_bound))
    uc = u.long().clamp(0, width - 1)
    vc = v.long().clamp(0, height - 1)
    d = depth_map[vc, uc]
    visible = inside & ((d - z).abs() <= vis_thres * d)
    return u, v, visible, z


def min_depth_over_cameras(points: torch.Tensor, viewmats: torch.Tensor, Ks: torch.Tensor,
                           depth_maps: torch.Tensor, vis_thres: float = 0.25
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-point minimum camera-space depth over all views where visible.

    Returns (min_depth (N,), vis (N, C) bool, uv (N, C, 2) int32 as (v, u))."""
    _, h, w = depth_maps.shape
    mind = torch.full((points.shape[0],), BIG, dtype=points.dtype, device=points.device)
    vis, uv = [], []
    for vm, K, dm in zip(viewmats, Ks, depth_maps):
        u, v, visible, z = project_points(points, vm, K, dm, w, h, vis_thres=vis_thres)
        mind = torch.minimum(mind, torch.where(visible, z, torch.full_like(z, BIG)))
        vis.append(visible)
        uv.append(torch.stack([v, u], -1))
    return mind, torch.stack(vis, 1), torch.stack(uv, 1)


def splat_depth_samples(min_depth: torch.Tensor, vis: torch.Tensor, uv: torch.Tensor,
                        height: int, width: int) -> torch.Tensor:
    """(H, W) map with each visible point's min depth written at its pixel;
    where several visible points share a pixel, the last of them wins.
    vis (N,) bool and uv (N, 2) int32 (v, u) are ONE camera's."""
    dev = min_depth.device
    vc = uv[:, 0].long().clamp(0, height - 1)
    uc = uv[:, 1].long().clamp(0, width - 1)
    ids = torch.nonzero(vis).squeeze(1)
    winner = torch.full((height * width,), -1, dtype=torch.long, device=dev)
    winner.scatter_reduce_(0, vc[ids] * width + uc[ids], ids, reduce="amax")
    out = torch.where(winner >= 0, min_depth[winner.clamp_min(0)],
                      torch.zeros((), dtype=min_depth.dtype, device=dev))
    return out.reshape(height, width)
