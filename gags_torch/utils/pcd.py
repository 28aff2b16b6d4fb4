"""Point-cloud utilities (port of gags_tpu.utils.pcd): euclidean
clustering of a selection, splatting per-point values into an image, and a
sinusoidal position encoding. Tensors on any device; the clustering's
union-find runs on the host."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def euclidean_clusters(xyz, eps: float = 0.05, min_points: int = 10,
                       block: int = 2048) -> np.ndarray:
    """(N,) int32 cluster labels (-1: noise) of the eps-neighbourhood graph,
    DBSCAN-style: union-find over pairs within eps, from distances in
    blocks of `block` points on xyz's device (for the selections of a few
    thousand points that text grounding leaves). Clusters of fewer than
    `min_points` are noise; labels follow the order of the clusters'
    union-find roots."""
    xyz = torch.as_tensor(xyz)
    n = xyz.shape[0]
    if n == 0:
        return np.zeros((0,), np.int32)
    parent = np.arange(n)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    eps2 = eps * eps
    for i0 in range(0, n, block):
        xi = xyz[i0:i0 + block]
        for j0 in range(i0, n, block):
            d = xi[:, None, :] - xyz[j0:j0 + block][None, :, :]
            d2 = d[..., 0] ** 2 + d[..., 1] ** 2 + d[..., 2] ** 2  # numpy's order
            ii, jj = (t.cpu().numpy() for t in torch.nonzero(d2 <= eps2, as_tuple=True))
            for a, b in zip(ii + i0, jj + j0):
                if a != b:
                    ra, rb = find(a), find(b)
                    if ra != rb:
                        parent[rb] = ra
    roots = np.array([find(i) for i in range(n)])
    labels = -np.ones(n, np.int32)
    next_label = 0
    for r in np.unique(roots):
        members = np.nonzero(roots == r)[0]
        if len(members) >= min_points:
            labels[members] = next_label
            next_label += 1
    return labels


def points_to_map(uv: torch.Tensor, values: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Write per-point values (N,) or (N, C) at their pixels uv (N, 2) int
    (v, u), clipped to the image; where points share a pixel the later one
    wins (a scatter of point indices with amax, deterministic on any
    device)."""
    h, w = hw
    dev = values.device
    v = uv[:, 0].long().clamp(0, h - 1)
    u = uv[:, 1].long().clamp(0, w - 1)
    last = torch.full((h * w,), -1, dtype=torch.long, device=dev)
    last.scatter_reduce_(0, v * w + u, torch.arange(len(v), device=dev), "amax")
    hit = last >= 0
    out = torch.zeros((h * w,) + tuple(values.shape[1:]), dtype=values.dtype, device=dev)
    out[hit] = values[last[hit]]
    return out.reshape((h, w) + tuple(values.shape[1:]))


def position_encoding(xyz: torch.Tensor, num_freqs: int = 4) -> torch.Tensor:
    """(N, 3) → (N, 3 * 2 * num_freqs): per axis sin then cos of
    xyz * 2^f, f < num_freqs."""
    freqs = 2.0 ** torch.arange(num_freqs, dtype=xyz.dtype, device=xyz.device)
    ang = xyz[..., None] * freqs
    enc = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return enc.reshape(*xyz.shape[:-1], -1)
