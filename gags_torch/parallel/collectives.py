"""The collectives of multi-rank GAD training, over torch.distributed.

The two that carry a gradient are autograd Functions:

  all_gather_rows   (n_l, C) per rank -> (world * n_l, C) everywhere; the
                    backward is a reduce_scatter (sum): each rank gets the
                    summed cotangent of its own rows (the counterpart of
                    JAX's all_gather transpose, psum_scatter);
  all_reduce_sum    a replicated sum (the region moments of the strip
                    losses); the backward is the identity. Every rank
                    backpropagates its own copy of the replicated loss, so
                    the cotangent of its local term is the loss's cotangent
                    of the sum, once: summing it again over the ranks (what
                    JAX's psum transpose does under check_vma=False) would
                    scale every gradient by the world size.

`halo_rows` (the k // 2 rows on either side of a row strip) and
`all_reduce_max` (the worst strip's overflow) need no gradient.

Every collective here runs on CUDA tensors under NCCL and under gloo
(ranks that share a card). Checked on the card's torch 2.11 (NVIDIA H100,
two ranks over gloo): all_reduce (sum and max), all_gather_into_tensor and
reduce_scatter_tensor take CUDA tensors; send and recv do not
(batch_isend_irecv fails, "writev ... Bad address"), so the halo exchange
is an all_gather of the strips' edge rows, not a send/recv pair, and
nothing needs a host copy.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


# torch 2.13 renames the two tensor collectives (*_single); 2.11 has the old names only
def _gather_into(out: torch.Tensor, x: torch.Tensor, group) -> None:
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, x, group=group)


def _reduce_scatter_into(out: torch.Tensor, x: torch.Tensor, group) -> None:
    fn = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    fn(out, x, group=group)


def all_gather_tensor(x: torch.Tensor, group=None) -> torch.Tensor:
    """(n, ...) per rank -> (world * n, ...), rank order, no gradient."""
    world = dist.get_world_size(group)
    x = x.contiguous()
    out = x.new_empty((world * x.shape[0],) + tuple(x.shape[1:]))
    _gather_into(out, x, group)
    return out


def reduce_scatter_tensor(x: torch.Tensor, group=None) -> torch.Tensor:
    """(world * n, ...) per rank -> this rank's (n, ...) of the sum over
    ranks, no gradient."""
    world = dist.get_world_size(group)
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // world,) + tuple(x.shape[1:]))
    _reduce_scatter_into(out, x, group)
    return out


def all_reduce_(x: torch.Tensor, group=None, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all_reduce of a contiguous tensor, no gradient; returns x."""
    dist.all_reduce(x, op=op, group=group)
    return x


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_tensor(x, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_tensor(g, ctx.group), None


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable row all_gather: (n_l, C) -> (world * n_l, C); the
    gradient of each rank's rows is the sum of every rank's cotangent."""
    return _AllGatherRows.apply(x, group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.detach().clone().contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over the group's ranks, replicated; the backward passes the
    cotangent through unchanged (see the module docstring)."""
    return _AllReduceSum.apply(x, group)


def all_reduce_max(x: torch.Tensor, group=None) -> torch.Tensor:
    """Elementwise maximum over the group's ranks (a copy; no gradient)."""
    return all_reduce_(x.detach().clone().contiguous(), group, op=dist.ReduceOp.MAX)


@torch.no_grad()
def halo_rows(x: torch.Tensor, halo: int, group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows above, rows below) of this rank's row strip `x` (strip_h, ...):
    the last `halo` rows of the rank before and the first `halo` rows of
    the rank after, zeros at the image's top and bottom. One all_gather of
    every rank's edge rows."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    edges = all_gather_tensor(torch.cat([x[:halo], x[-halo:]]), group)
    edges = edges.reshape((world, 2 * halo) + tuple(x.shape[1:]))
    zeros = x.new_zeros((halo,) + tuple(x.shape[1:]))
    above = edges[rank - 1, halo:] if rank > 0 else zeros
    below = edges[rank + 1, :halo] if rank < world - 1 else zeros
    return above, below
