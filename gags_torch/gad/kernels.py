"""Wrapper of the GAD step's kernel, beside its plain version:

  J6 supervision_forward   the per-pixel tail of the GAD step: the feature
     supervision_backward  decoder's L2 normalisation, the scale-blended GT
                           gather, the mask and the masked per-pixel L1,
                           and its gradient in the rows and the scale map

No TPU counterpart: the JAX package leaves this chain to XLA, which fuses
it; PyTorch runs it eagerly, ~30 passes over a (P, 512) float32 tensor
forward and ~60 backward. `gad/supervision.normalised_supervision_l1`
dispatches: CPU tensors run the plain version (the normalisation, then
`fused_supervision_l1`, autograd its backward); CUDA tensors launch the
kernel (``csrc/supervision.cu``, built with nvcc at first use and bound
through ctypes) or raise. `launch_counts` counts kernel launches only.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch
from torch.autograd.function import once_differentiable

from gags_torch import _kernels
from gags_torch.splat.kernels import _aligned16, _ptr, _stream

CSRC = Path(__file__).resolve().parent / "csrc"
SUPERVISION_SRC = CSRC / "supervision.cu"
SOURCES = (SUPERVISION_SRC,)
WIDTHS = (128, 256, 512, 768, 1024)  # csrc/supervision.cu's row widths D

launch_counts = {"supervision_forward": 0, "supervision_backward": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _inputs(raw, img_embed, seg_sml, scale_map):
    """The kernel's operands: rows (P, D), the table, ids and scale maps as
    (P, 3) views (any row stride, unit column stride), and the flags. Raises
    on what J6 does not take."""
    dev = raw.device
    if dev.type != "cuda" or raw.dtype != torch.float32 or not raw.is_contiguous():
        raise ValueError(f"J6: raw rows must be contiguous CUDA float32, got {raw.dtype} on "
                         f"{dev}, contiguous {raw.is_contiguous()}")
    d = raw.shape[-1]
    if d not in WIDTHS:
        raise ValueError(f"J6: row width {d} not one of {WIDTHS}")
    lead = tuple(raw.shape[:-1])
    if img_embed.device != dev or img_embed.dtype not in (torch.float32, torch.float16) or \
            img_embed.dim() != 2 or img_embed.shape[1] != d or img_embed.shape[0] < 1:
        raise ValueError(f"J6: img_embed (M, {d}) float32 or float16 on {dev}, got "
                         f"{img_embed.dtype} {tuple(img_embed.shape)} on {img_embed.device}")
    if seg_sml.device != dev or seg_sml.dtype != torch.int32 or \
            tuple(seg_sml.shape) != lead + (3,):
        raise ValueError(f"J6: seg_sml {lead + (3,)} int32 on {dev}, got {seg_sml.dtype} "
                         f"{tuple(seg_sml.shape)} on {seg_sml.device}")
    if scale_map.device != dev or scale_map.dtype != torch.float32 or \
            tuple(scale_map.shape) != lead + (3,):
        raise ValueError(f"J6: scale_map {lead + (3,)} float32 on {dev}, got "
                         f"{scale_map.dtype} {tuple(scale_map.shape)} on {scale_map.device}")
    x = _aligned16(raw.reshape(-1, d))
    ids, scale = seg_sml.reshape(-1, 3), scale_map.reshape(-1, 3)
    ids = ids if ids.stride(1) == 1 else ids.contiguous()
    scale = scale if scale.stride(1) == 1 else scale.contiguous()
    table = _aligned16(img_embed.contiguous())
    return x, table, ids, scale


def _args(x, table, ids, scale):
    return (_ptr(x), _ptr(table), int(table.dtype == torch.float16), table.shape[0],
            x.shape[1], _ptr(ids), ids.stride(0), _ptr(scale), scale.stride(0), x.shape[0])


_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
             + [ctypes.c_void_p, ctypes.c_int64] * 2 + [ctypes.c_int64])


def supervision_forward(raw, img_embed, seg_sml, scale_map) -> torch.Tensor:
    """J6 forward: the masked per-pixel L1 of raw's rows L2-normalised
    against the blended GT map, shape raw.shape[:-1]."""
    x, table, ids, scale = _inputs(raw, img_embed, seg_sml, scale_map)
    l1 = torch.empty((x.shape[0],), dtype=torch.float32, device=x.device)
    lib = _kernels.load(SUPERVISION_SRC)
    fn = lib.gags_supervision_forward
    fn.argtypes = _ARGTYPES + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    err = fn(*_args(x, table, ids, scale), _ptr(l1), _stream(x))
    _kernels.check(lib, err, "supervision_forward")
    launch_counts["supervision_forward"] += 1
    return l1.reshape(raw.shape[:-1])


def supervision_backward(raw, img_embed, seg_sml, scale_map, g):
    """J6 backward: (d_raw like raw, d_scale like scale_map) from the
    per-pixel loss's gradient `g` (raw.shape[:-1])."""
    x, table, ids, scale = _inputs(raw, img_embed, seg_sml, scale_map)
    if g.device != x.device or g.dtype != torch.float32 or g.numel() != x.shape[0]:
        raise ValueError(f"J6: g, {x.shape[0]} float32 values on {x.device}, got {g.dtype} "
                         f"{tuple(g.shape)} on {g.device}")
    g = g.reshape(-1).contiguous()
    d_x = torch.empty_like(x)
    d_scale = torch.empty((x.shape[0], 3), dtype=torch.float32, device=x.device)
    lib = _kernels.load(SUPERVISION_SRC)
    fn = lib.gags_supervision_backward
    fn.argtypes = _ARGTYPES + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    err = fn(*_args(x, table, ids, scale), _ptr(g), _ptr(d_x), _ptr(d_scale), _stream(x))
    _kernels.check(lib, err, "supervision_backward")
    launch_counts["supervision_backward"] += 1
    return d_x.reshape(raw.shape), d_scale.reshape(scale_map.shape)


def supervision_backward_plain(raw, img_embed, seg_sml, scale_map, g):
    """J6's backward as closed forms in torch, in raw's dtype (its plain
    version): with y the normalised rows, r = rsqrt(max(sum raw^2, 1e-24)),
    sgn = sign(y - gt) and gm = g / D where the mask is on (0 elsewhere),
    d_raw = r gm (sgn - y <sgn, y>) (the inner product dropped where the
    clamp holds) and d_scale_k = -<sgn, T[id_k]> gm."""
    from gags_torch.gad.supervision import _gather_terms

    d = raw.shape[-1]
    x = raw.reshape(-1, d)
    ids, scale = seg_sml.reshape(-1, 3), scale_map.reshape(-1, 3).to(raw.dtype)
    table = img_embed.to(raw.dtype)
    mask = torch.all(ids != -1, dim=-1)[:, None]
    ss = torch.sum(x * x, dim=-1, keepdim=True)
    r = torch.rsqrt(torch.clamp_min(ss, 1e-24))
    y = x * r
    sgn = torch.where(mask, torch.sign(y - _gather_terms(table, ids, scale)), 0)
    gm = g.reshape(-1, 1).to(raw.dtype) / d
    sy = torch.where(ss >= 1e-24, torch.sum(sgn * y, dim=-1, keepdim=True), 0)
    d_x = r * gm * (sgn - y * sy)
    rows = torch.remainder(ids, table.shape[0]).long()
    d_scale = torch.stack([-torch.sum(sgn * table[rows[:, k]], dim=-1) for k in range(3)],
                          dim=-1) * gm
    return d_x.reshape(raw.shape), d_scale.reshape(scale_map.shape)


class _SupervisionL1(torch.autograd.Function):
    """J6's two launches as one function differentiable in the rows and the
    scale map; its saved tensors are its inputs."""

    @staticmethod
    def forward(ctx, raw, img_embed, seg_sml, scale_map):
        ctx.save_for_backward(raw, img_embed, seg_sml, scale_map)
        return supervision_forward(raw, img_embed, seg_sml, scale_map)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        raw, img_embed, seg_sml, scale_map = ctx.saved_tensors
        d_raw, d_scale = supervision_backward(raw, img_embed, seg_sml, scale_map, g)
        return d_raw, None, None, d_scale if ctx.needs_input_grad[3] else None


def supervision_l1(raw, img_embed, seg_sml, scale_map) -> torch.Tensor:
    """J6, differentiable in raw and scale_map (CUDA tensors only)."""
    return _SupervisionL1.apply(raw, img_embed, seg_sml, scale_map)
