"""Decoding features to CLIP space, and 3D point grounding (port of
gags_tpu.query.grounding).

`decode_map_rows` decodes a rendered (H, W, F) feature map in row
chunks. Point grounding (the relevancy CLI's pcd mode): every Gaussian's
feature decoded in chunks, cosine relevancy against the prompts, a
threshold, then a neighbour vote: a point stays selected iff at least
`min_votes` of its k nearest neighbours within `radius` are selected
too. The k nearest neighbours come from knn/knn.py's exact blocked
search, with their indices.

The decode is plain `nn.Linear` products. On the card, float32 products
must stay full float32: the entry points set
`torch.backends.cuda.matmul.allow_tf32 = False` (PyTorch's default).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gags_torch.knn.knn import knn_with_indices
from gags_torch.query.relevancy import relevancy


@torch.no_grad()
def decode_map_rows(decoder: nn.Module, feat_map: torch.Tensor,
                    rows_per_chunk: int = 96) -> torch.Tensor:
    """Decode an (H, W, F) feature map to (H, W, D) in row chunks, which
    bounds the (rows, W, 256) hidden activations of the decoder."""
    h = feat_map.shape[0]
    return torch.cat(
        [decoder(feat_map[i : i + rows_per_chunk]) for i in range(0, h, rows_per_chunk)]
    )


@torch.no_grad()
def decode_features_chunked(decoder: nn.Module, features: torch.Tensor,
                            chunk: int = 1_048_576) -> torch.Tensor:
    """Decode (N, F) per-Gaussian features to (N, D) in chunks of `chunk`."""
    n = features.shape[0]
    return torch.cat([decoder(features[i : i + chunk]) for i in range(0, n, chunk)])


def point_relevancy(decoded: torch.Tensor, pos_embeds: torch.Tensor, neg_embeds: torch.Tensor,
                    normalize: bool = True) -> torch.Tensor:
    """(N, P) relevancy scores, optionally min-max normalised per prompt."""
    rel = relevancy(decoded, pos_embeds, neg_embeds)
    if normalize:
        lo = torch.amin(rel, dim=0, keepdim=True)
        hi = torch.amax(rel, dim=0, keepdim=True)
        rel = (rel - lo) / torch.clamp_min(hi - lo, 1e-9)
    return rel


def smooth_point_mask(xyz: torch.Tensor, mask: torch.Tensor, k: int = 32, radius: float = 0.05,
                      min_votes: int = 20) -> torch.Tensor:
    """Keep a point iff >= min_votes of its k nearest neighbours within
    `radius` are also selected (a k-NN neighbourhood capped at `radius`
    instead of an unbounded ball query)."""
    d2, idx = knn_with_indices(xyz, k)
    return vote_mask(mask, d2, idx, radius, min_votes)


def vote_mask(mask: torch.Tensor, d2: torch.Tensor, idx: torch.Tensor, radius: float = 0.05,
              min_votes: int = 20) -> torch.Tensor:
    """The neighbour vote of `smooth_point_mask` on a KNN already taken
    (`knn.knn_with_indices`), so several masks can share one search."""
    votes = torch.sum(mask[idx] & (d2 <= radius * radius), dim=1)
    return mask & (votes >= min_votes)


def select_gaussians(rel: torch.Tensor, prompt_idx: int, thresh: float,
                     xyz: Optional[torch.Tensor] = None, smooth: bool = True) -> torch.Tensor:
    """(N,) bool mask of the Gaussians relevant to one prompt (rel: (N, P)
    normalised relevancy), neighbour-smoothed where xyz is given."""
    mask = rel[:, prompt_idx] > thresh
    if smooth and xyz is not None:
        mask = smooth_point_mask(xyz, mask)
    return mask
