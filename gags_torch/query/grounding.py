"""Decoding rendered feature maps to CLIP space (port of
gags_tpu.query.grounding.decode_map_rows).

The decode is plain `nn.Linear` products. On the card, float32 products
must stay full float32: the serving entry points set
`torch.backends.cuda.matmul.allow_tf32 = False` (PyTorch's default).
"""

from __future__ import annotations

import torch
from torch import nn


@torch.no_grad()
def decode_map_rows(decoder: nn.Module, feat_map: torch.Tensor,
                    rows_per_chunk: int = 96) -> torch.Tensor:
    """Decode an (H, W, F) feature map to (H, W, D) in row chunks, which
    bounds the (rows, W, 256) hidden activations of the decoder."""
    h = feat_map.shape[0]
    return torch.cat(
        [decoder(feat_map[i : i + rows_per_chunk]) for i in range(0, h, rows_per_chunk)]
    )
