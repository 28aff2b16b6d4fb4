"""GT supervision: gather and blend CLIP features per pixel (port of
gags_tpu.gad.supervision).

Layouts: seg_map (H, W, 4) int with levels [default, s, m, l] and -1 for
"no mask"; img_embed (M, D) padded to a static M; scale_map (H, W, 3).
"""

from __future__ import annotations

from typing import Tuple

import torch

from gags_torch.gad import losses
from gags_torch.utils.image import mean_smooth, resize_bilinear_align_corners, resize_nearest


def segment_median(values: torch.Tensor, seg: torch.Tensor, num_segments: int):
    """Per-segment lower median (torch.median semantics) of flat `values`.

    seg < 0 entries are excluded. Returns (medians (S,), counts (S,));
    empty segments get median 0. One (seg, value) lexicographic order and
    run boundaries by searchsorted."""
    s = torch.where(seg < 0, num_segments, seg).long()
    by_value = torch.argsort(values, stable=True)
    order = by_value[torch.argsort(s[by_value], stable=True)]
    s_sorted, v_sorted = s[order], values[order]
    bounds = torch.arange(num_segments + 1, device=values.device)
    starts = torch.searchsorted(s_sorted, bounds)
    counts = starts[1:] - starts[:-1]
    pos = starts[:-1] + torch.div(torch.clamp_min(counts - 1, 0), 2, rounding_mode="floor")
    med = v_sorted[torch.clamp_max(pos, values.shape[0] - 1)]
    return torch.where(counts > 0, med, 0.0), counts


def mixed_seg_map(seg_map: torch.Tensor, scale_map: torch.Tensor) -> torch.Tensor:
    """One (H, W) id map: per pixel, the s/m/l id of the argmax granularity
    of the k=5 box-smoothed scale map."""
    sm = mean_smooth(scale_map, 5)
    sel = torch.argmax(sm, dim=-1)  # (H, W) in {0, 1, 2}
    return torch.gather(seg_map[..., 1:4], -1, sel[..., None])[..., 0]


def _gather_terms(table: torch.Tensor, seg2: torch.Tensor, scale2: torch.Tensor) -> torch.Tensor:
    """sum_g table[seg2[:, g] mod M] * scale2[:, g] for the three levels;
    index -1 wraps to the last row."""
    m = table.shape[0]
    out = None
    for g in range(3):
        term = table[torch.remainder(seg2[:, g], m).long()] * scale2[:, g:g + 1]
        out = term if out is None else out + term
    return out


class _FusedSupervisionL1(torch.autograd.Function):
    """Masked per-pixel L1 against the blended GT map whose only saved
    tensors are its raw inputs: the backward recomputes the gathered rows
    and contracts them against sign(diff) straight into the scale-map
    cotangent. img_embed and the seg ids get no gradient."""

    @staticmethod
    def forward(ctx, decoded, img_embed, seg_sml, scale_map):
        lead, d = decoded.shape[:-1], decoded.shape[-1]
        seg2 = seg_sml.reshape(-1, 3)
        scale2 = scale_map.reshape(-1, 3)
        maskf = torch.all(seg2 != -1, dim=-1).to(torch.float32)[:, None]
        gt = _gather_terms(img_embed.to(torch.float32), seg2, scale2)
        dec2 = decoded.reshape(-1, d)
        ctx.save_for_backward(decoded, img_embed, seg_sml, scale_map)
        return losses.channel_mean(torch.abs(dec2 * maskf - gt * maskf)).reshape(lead)

    @staticmethod
    def backward(ctx, g):
        decoded, img_embed, seg_sml, scale_map = ctx.saved_tensors
        lead, d = decoded.shape[:-1], decoded.shape[-1]
        seg2 = seg_sml.reshape(-1, 3)
        scale2 = scale_map.reshape(-1, 3)
        table = img_embed.to(torch.float32)
        maskf = torch.all(seg2 != -1, dim=-1).to(torch.float32)[:, None]
        gt = _gather_terms(table, seg2, scale2)
        dec2 = decoded.reshape(-1, d)
        sgn = torch.sign(dec2 * maskf - gt * maskf)  # (P, D)
        gm = (g.reshape(-1) / d)[:, None] * maskf  # (P, 1)
        d_decoded = (gm * sgn).reshape(decoded.shape)
        m = table.shape[0]
        d_scale = torch.stack(
            [-torch.sum(sgn * table[torch.remainder(seg2[:, k], m).long()], dim=-1) * gm[:, 0]
             for k in range(3)], dim=-1,
        ).reshape(lead + (3,))
        return d_decoded, None, None, d_scale


def fused_supervision_l1(decoded, img_embed, seg_sml, scale_map) -> torch.Tensor:
    """Equals l1_map(decoded * mask, gt * mask) for the same-resolution,
    default-mode `blend_gt_feature_map`. decoded (..., D), img_embed (M, D),
    seg_sml (..., 3) the s/m/l ids, scale_map (..., 3); returns (...)."""
    return _FusedSupervisionL1.apply(decoded, img_embed, seg_sml, scale_map)


def blend_gt_feature_map(
    img_embed: torch.Tensor,  # (M, D) per-mask CLIP embeddings
    seg_map: torch.Tensor,  # (H, W, 4)
    scale_map: torch.Tensor,  # (h, w, 3) granularity weights at render res
    max_mode: bool = False,
    median_mode: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel GT CLIP map blended across granularities; returns
    (feature_map (h, w, D), mask (h, w, 1) bool).

    A seg id of -1 gathers the LAST embedding row (python negative
    indexing, as the reference does); where seg and render resolutions
    differ, that row bleeds into mask-valid pixels through the
    align_corners bilinear resize, and this reproduces it. Feature maps
    are bilinear-resized with align_corners=True and masks nearest-resized
    when the resolutions differ. median_mode gives every pixel of an
    s-level segment that segment's per-channel median scale weights,
    normalised to sum 1."""
    h_out, w_out = scale_map.shape[0], scale_map.shape[1]
    seg_sml = seg_map[..., 1:4]
    valid = seg_sml != -1

    if (h_out, w_out) == tuple(seg_map.shape[:2]) and not max_mode and not median_mode:
        mask = torch.all(valid, dim=-1)[..., None]
        gt = _gather_terms(img_embed.to(torch.float32), seg_sml.reshape(-1, 3),
                           scale_map.reshape(-1, 3))
        return gt.reshape(h_out, w_out, -1), mask

    idx = torch.remainder(seg_sml, img_embed.shape[0]).long()  # -1 → last row
    feats = img_embed[idx].to(torch.float32)  # (H, W, 3, D)
    mask_all = torch.all(valid, dim=-1).to(torch.float32)[..., None]
    mask = resize_nearest(mask_all, (h_out, w_out)).bool()
    fs = resize_bilinear_align_corners(feats[..., 0, :], (h_out, w_out))
    fm = resize_bilinear_align_corners(feats[..., 1, :], (h_out, w_out))
    fl = resize_bilinear_align_corners(feats[..., 2, :], (h_out, w_out))

    if max_mode:
        ms = resize_nearest(valid[..., 0].to(torch.float32), (h_out, w_out))
        mm = resize_nearest(valid[..., 1].to(torch.float32), (h_out, w_out))
        ml = resize_nearest(valid[..., 2].to(torch.float32), (h_out, w_out))
        sel = torch.argmax(scale_map, dim=-1)
        one_hot = torch.eye(3, dtype=scale_map.dtype, device=scale_map.device)[sel]
        fmap = (fs * (one_hot[..., 0] * ms)[..., None]
                + fm * (one_hot[..., 1] * mm)[..., None]
                + fl * (one_hot[..., 2] * ml)[..., None])
        mask = fmap[..., 0:1] != 0.0
    elif median_mode:
        num_segments = img_embed.shape[0]
        seg_r = resize_nearest(seg_map.to(torch.float32), (h_out, w_out)).to(torch.int32)
        flat = seg_r[..., 1].reshape(-1)  # the s-granularity segments
        med = torch.stack(
            [segment_median(scale_map[..., ch].reshape(-1), flat, num_segments)[0]
             for ch in range(3)], dim=-1,
        )  # (S, 3)
        # absent segments have all-zero medians; guard the 0/0
        med = med / torch.clamp_min(torch.sum(med, dim=-1, keepdim=True), 1e-12)
        balanced = med[torch.clamp_min(flat, 0).long()].reshape(h_out, w_out, 3)
        scale_bal = torch.where((seg_r[..., 1] != -1)[..., None], balanced, scale_map)
        fmap = fs * scale_bal[..., 0:1] + fm * scale_bal[..., 1:2] + fl * scale_bal[..., 2:3]
    else:
        fmap = fs * scale_map[..., 0:1] + fm * scale_map[..., 1:2] + fl * scale_map[..., 2:3]
    return fmap, mask
