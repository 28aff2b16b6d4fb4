"""GAD loss library with segment reductions (port of gags_tpu.gad.losses).

The per-region losses sum pixel rows per segment with kernel K4
(`kernels.dense_segment_sum`) at every segment count; its backward is a
gather. Conventions: images channel-last (H, W, C); seg maps int (H, W)
with -1 for "no mask". With `group` (the row strips of one image over the
ranks of a torch.distributed group, gags_torch.parallel.gshard) the
segment moments are summed over the ranks by a differentiable all_reduce
whose backward is the identity, so every rank holds the full-image loss
and its own pixels' exact gradient (the JAX package's `axis_name`
branches, whose psum transpose scales the gradients by the rank count).
"""

from __future__ import annotations

import torch

from gags_torch.splat import kernels


def channel_mean(v: torch.Tensor) -> torch.Tensor:
    """Mean over the trailing channel dim: (..., C) → (...)."""
    return torch.mean(v, dim=-1)


def l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(x - y))


def l2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((x - y) ** 2)


def cosine_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """1 - mean cosine similarity along the channel dim."""
    num = torch.sum(x * y, dim=-1)
    den = torch.linalg.norm(x, dim=-1) * torch.linalg.norm(y, dim=-1)
    return 1.0 - torch.mean(num / torch.clamp(den, min=1e-8))


def l1_map(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-pixel L1 averaged over channels: (H, W, C) → (H, W)."""
    return channel_mean(torch.abs(x - y))


def scale_entropy_loss(scale_map: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Entropy regulariser pushing the 3-way softmax toward one-hot."""
    return torch.mean(-scale_map * torch.log(scale_map + eps))


class _DenseSegsum(torch.autograd.Function):
    """Per-segment sums of (P, C) rows (kernel K4); the backward gathers
    each pixel's segment cotangent, zero for ids outside [0, S)."""

    @staticmethod
    def forward(ctx, values, ids, num_segments):
        ctx.save_for_backward(ids)
        ctx.num_segments = num_segments
        return kernels.dense_segment_sum(values.contiguous(), ids, num_segments)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        in_range = (ids >= 0) & (ids < ctx.num_segments)
        rows = g[torch.where(in_range, ids, 0).long()]
        return torch.where(in_range[:, None], rows, 0.0), None, None


def dense_segsum(values: torch.Tensor, ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """(P, C) f32 rows summed per segment id (P,) → (num_segments, C)."""
    return _DenseSegsum.apply(values, ids.to(torch.int32).contiguous(), num_segments)


def _group_sum(moments: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return moments
    from gags_torch.parallel.collectives import all_reduce_sum

    return all_reduce_sum(moments, group)


def region_balanced_l1(loss_map: torch.Tensor, seg: torch.Tensor, max_segments: int,
                       group=None) -> torch.Tensor:
    """Mean over regions of the per-region mean loss (regions weigh equally
    regardless of their pixel count). With `group`, loss_map and seg are
    this rank's strip and the result is the whole image's."""
    ids = (seg + 1).reshape(-1)  # 0 = invalid bucket
    flat = loss_map.reshape(-1)
    packed = torch.stack([torch.ones_like(flat), flat], dim=1)  # (P, 2)
    out = _group_sum(dense_segsum(packed, ids, max_segments + 1), group)
    cnts, sums = out[1:, 0], out[1:, 1]
    present = cnts > 0
    means = torch.where(present, sums / torch.clamp_min(cnts, 1.0), 0.0)
    return torch.sum(means) / torch.clamp_min(present.sum(), 1)


def region_variance_loss(feat: torch.Tensor, seg: torch.Tensor, max_segments: int,
                         group=None, num_pixels: int | None = None) -> torch.Tensor:
    """Pixel-count-weighted per-region feature variance: for each region of
    >= 2 pixels, the unbiased per-channel variance averaged over channels,
    times the pixel count; summed and divided by the pixel count.
    feat is (H, W, C) or pre-flattened (H*W, C). With `group`, feat and seg
    are this rank's strip and `num_pixels`, required then, is the whole
    image's H*W (never the strips' padded size)."""
    if group is not None and num_pixels is None:
        raise ValueError("region_variance_loss over a group needs num_pixels, the image's H*W")
    c = feat.shape[-1]
    ids = (seg + 1).reshape(-1)
    flat = feat.reshape(-1, c)
    packed = torch.cat([torch.ones_like(flat[:, :1]), flat, flat * flat], dim=1)  # (P, 1+2C)
    out = _group_sum(dense_segsum(packed, ids, max_segments + 1), group)
    cnt, s1, s2 = out[:, 0], out[:, 1:1 + c], out[:, 1 + c:]
    n = cnt[:, None]
    # unbiased: (sum(x^2) - n mean^2) / (n - 1)
    var = (s2 - s1 * s1 / torch.clamp_min(n, 1.0)) / torch.clamp_min(n - 1.0, 1.0)
    var = torch.clamp_min(var, 0.0)  # guard fp cancellation
    valid = cnt >= 2
    valid[0] = False  # drop the invalid bucket
    contrib = torch.where(valid, cnt * torch.mean(var, dim=-1), 0.0)
    return torch.sum(contrib) / (flat.shape[0] if num_pixels is None else num_pixels)


def tv_loss(feat: torch.Tensor) -> torch.Tensor:
    """Total variation on (H, W, C)."""
    dx = feat[:, 1:, :] - feat[:, :-1, :]
    dy = feat[1:, :, :] - feat[:-1, :, :]
    return torch.sum(dx * dx) + torch.sum(dy * dy)
