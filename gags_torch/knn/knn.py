"""Exact k-nearest neighbours (port of gags_tpu.knn.knn, and of the
indexed search in gags_tpu.query.grounding._knn_with_indices).

The mean squared distance of each point to its 3 nearest neighbours
initialises the Gaussians' scales, once per scene (the reference's
`simple_knn._C.distCUDA2`); the relevancy CLI's point grounding votes
among each point's 32 nearest neighbours. Exact blocked distance matrices, written as
||x||^2 + ||y||^2 - 2 x.y clamped at 0 (not `torch.cdist`, which may take
another route and round differently), with the point itself and the
padding excluded and a running top-k merge per row block. Not a Pallas
kernel in the JAX package: plain matmul + topk here too.
"""

from __future__ import annotations

from typing import Tuple

import torch

_BIG = 3.0e38


@torch.no_grad()
def knn_with_indices(xyz: torch.Tensor, k: int, row_block: int = 1024,
                     col_block: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, k) squared distances to the k nearest *other* points, ascending,
    and their (N, k) int64 indices, on the input's device."""
    n = xyz.shape[0]
    dev = xyz.device
    rb = min(row_block, max(8, n))
    cb = min(col_block, max(128, n))
    n_rpad = -(-n // rb) * rb
    n_cpad = -(-n // cb) * cb
    # padded rows sit at the origin; padded columns are masked out below
    pts = torch.zeros((max(n_rpad, n_cpad), 3), dtype=torch.float32, device=dev)
    pts[:n] = xyz.to(torch.float32)
    sq = torch.sum(pts * pts, dim=-1)
    big = torch.tensor(_BIG, dtype=torch.float32, device=dev)
    out_d = torch.empty((n_rpad, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((n_rpad, k), dtype=torch.long, device=dev)
    for r in range(n_rpad // rb):
        xr, sr = pts[r * rb:(r + 1) * rb], sq[r * rb:(r + 1) * rb]
        rid = torch.arange(r * rb, (r + 1) * rb, device=dev)
        best_d = torch.full((rb, k), _BIG, dtype=torch.float32, device=dev)
        best_i = torch.zeros((rb, k), dtype=torch.long, device=dev)
        for c in range(n_cpad // cb):
            xc, sc = pts[c * cb:(c + 1) * cb], sq[c * cb:(c + 1) * cb]
            cid = torch.arange(c * cb, (c + 1) * cb, device=dev)
            d2 = sr[:, None] + sc[None, :] - 2.0 * (xr @ xc.T)
            bad = (cid[None, :] == rid[:, None]) | (cid[None, :] >= n)
            d2 = torch.where(bad, big, torch.clamp_min(d2, 0.0))
            blk_d, blk_p = torch.topk(d2, min(k, cb), dim=1, largest=False)
            best_d, pos = torch.topk(torch.cat([best_d, blk_d], dim=1), k, dim=1, largest=False)
            best_i = torch.gather(torch.cat([best_i, blk_p + c * cb], dim=1), 1, pos)
        out_d[r * rb:(r + 1) * rb] = best_d
        out_i[r * rb:(r + 1) * rb] = best_i
    return out_d[:n], out_i[:n]


def knn_sq_dists(xyz: torch.Tensor, k: int = 3, row_block: int = 1024,
                 col_block: int = 4096) -> torch.Tensor:
    """(N, k) squared distances to the k nearest *other* points, ascending,
    on the input's device."""
    return knn_with_indices(xyz, k, row_block, col_block)[0]


def mean_knn_sq_dist(xyz: torch.Tensor, k: int = 3) -> torch.Tensor:
    """Mean of the k nearest squared distances (distCUDA2 semantics)."""
    return torch.mean(knn_sq_dists(xyz, k=k), dim=-1)
