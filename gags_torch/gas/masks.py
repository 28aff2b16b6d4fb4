"""Mask post-processing for GAS: NMS, granularity packing, crop extraction;
a copy of gags_tpu.gas.masks (numpy on the host).

Counterparts of `preprocess.py`'s mask pipeline, vectorised:

  * `mask_nms` — the reference computes an O(M^2) IoU matrix with nested
    python loops over individual masks (preprocess.py:403-415); here the
    whole matrix is one (M, HW) @ (HW, M) boolean-as-float matmul.
  * `pack_granularities` — per-level id maps with cumulative offsets and a
    single concatenated embedding table (preprocess.py:303-319).
  * `extract_mask_crops` — zero the background, crop the bbox, pad to
    square, resize to 224 (preprocess.py:356-371,476-489), batched.

These run on the host.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def mask_iou_matrices(masks: np.ndarray):
    """masks: (M, H, W) bool. Returns (iou (M,M), inter (M,M), areas (M,))."""
    m = masks.reshape(masks.shape[0], -1).astype(np.float32)
    inter = m @ m.T
    areas = m.sum(axis=1)
    union = areas[:, None] + areas[None, :] - inter
    iou = inter / np.maximum(union, 1e-9)
    return iou, inter, areas


def mask_nms(
    masks: np.ndarray,
    scores: np.ndarray,
    iou_thr: float = 0.8,
    score_thr: float = 0.7,
    inner_thr: float = 0.5,
) -> np.ndarray:
    """Score-ordered mask NMS with the reference's inner-overlap rule.

    Returns indices (into the original order) of kept masks. Matches
    `preprocess.py:380-447` including the top-3 fallbacks.
    """
    order = np.argsort(-scores, kind="stable")
    s = scores[order]
    m = masks[order]
    n = len(order)

    iou, inter, areas = mask_iou_matrices(m)

    ai = inter / np.maximum(areas[:, None], 1e-9)  # intersection / area_i
    aj = inter / np.maximum(areas[None, :], 1e-9)  # intersection / area_j
    inner = np.zeros((n, n), np.float32)
    # pair (i, j), i<j in score order ONLY (the reference loops j >= i;
    # evaluating the full matrix would hit each pair twice — cond_l[j, i]
    # is the same predicate as cond_u[i, j] — and double-write the value)
    iu = np.triu(np.ones((n, n), bool), k=1)
    cond_u = (ai < 0.5) & (aj >= 0.85) & iu
    cond_l = (ai >= 0.85) & (aj < 0.5) & iu
    val = 1.0 - aj * ai
    inner[cond_u] = val[cond_u]
    inner_l = np.zeros((n, n), np.float32)
    inner_l[cond_l] = val[cond_l]
    inner = inner + inner_l.T  # reference writes [j, i] for the second case

    iou_u = np.triu(iou, k=1)
    iou_max = iou_u.max(axis=0) if n else np.zeros(0)
    inner_u = np.triu(inner, k=1)
    inner_l_t = np.tril(inner, k=1)
    inner_max_u = inner_u.max(axis=0) if n else np.zeros(0)
    inner_max_l = inner_l_t.max(axis=0) if n else np.zeros(0)

    keep = iou_max <= iou_thr
    keep_conf = s > score_thr
    keep_iu = inner_max_u <= 1 - inner_thr
    keep_il = inner_max_l <= 1 - inner_thr

    def fallback(k):
        if k.sum() == 0 and n:
            k = k.copy()
            k[np.argsort(-s)[: min(3, n)]] = True
        return k

    keep_conf = fallback(keep_conf)
    keep_iu = fallback(keep_iu)
    keep_il = fallback(keep_il)

    keep = keep & keep_conf & keep_iu & keep_il
    return order[keep]


def filter_masks(
    masks: Sequence[dict],
    iou_thr: float = 0.8,
    score_thr: float = 0.7,
    inner_thr: float = 0.5,
) -> List[dict]:
    """NMS over SAM-style mask dicts, score = stability * predicted_iou."""
    if not masks:
        return []
    seg = np.stack([m["segmentation"] for m in masks], 0)
    score = np.array(
        [m["stability_score"] * m["predicted_iou"] for m in masks], np.float32
    )
    keep = set(mask_nms(seg, score, iou_thr, score_thr, inner_thr).tolist())
    return [m for i, m in enumerate(masks) if i in keep]


def masks_to_seg_map(masks: Sequence[dict], hw: Tuple[int, int]) -> np.ndarray:
    """(H, W) int32 id map; later masks overwrite earlier (reference order)."""
    seg = -np.ones(hw, np.int32)
    for i, m in enumerate(masks):
        seg[m["segmentation"]] = i
    return seg


def pack_granularities(
    level_embeds: Dict[str, np.ndarray],
    level_seg_maps: Dict[str, np.ndarray],
) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenate per-level embeddings; offset each level's seg ids by the
    cumulative count of earlier levels — except level 0 ('default'), whose
    ids stay unshifted (preprocess.py:311-317).

    Returns (img_embed (total, D), seg_maps (4, H, W) int32).
    """
    order = ["default", "s", "m", "l"]
    lengths = [len(level_embeds[k]) for k in order if k in level_embeds]
    keys = [k for k in order if k in level_embeds]
    if not keys:
        raise ValueError("pack_granularities: no levels present")
    embed = np.concatenate([level_embeds[k] for k in keys], axis=0)
    cum = np.cumsum(lengths)
    shape = next(iter(level_seg_maps.values())).shape
    segs = []
    j = 0
    for k in order:
        if k not in level_embeds:
            # a level can come out empty (every mask failed the quality
            # thresholds or the NMS) — the (4, H, W) contract must hold
            # regardless: downstream reads seg_map[1:4] as [s, m, l] by
            # POSITION, so a missing level is an all -1 channel, never a
            # dropped one
            segs.append(np.full(shape, -1, np.int32))
            continue
        v = level_seg_maps[k].astype(np.int32).copy()
        if j > 0:
            v[v != -1] += cum[j - 1]
        segs.append(v)
        j += 1
    return embed, np.stack(segs, axis=0)


def pad_to_square(img: np.ndarray) -> np.ndarray:
    """Zero-pad (h, w, 3) to (l, l, 3), centred (preprocess.py:363-371)."""
    h, w = img.shape[:2]
    l = max(h, w)
    out = np.zeros((l, l, img.shape[2]), img.dtype)
    if h > w:
        off = (h - w) // 2
        out[:, off : off + w] = img
    else:
        off = (w - h) // 2
        out[off : off + h, :] = img
    return out


def _resize_bilinear_np(img: np.ndarray, size: int) -> np.ndarray:
    """cv2.resize-style bilinear (half-pixel centres) in numpy."""
    h, w = img.shape[:2]
    ys = (np.arange(size) + 0.5) * (h / size) - 0.5
    xs = (np.arange(size) + 0.5) * (w / size) - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None, None]
    wx = np.clip(xs - x0, 0, 1)[None, :, None]
    img = img.astype(np.float32)
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def extract_mask_crops(
    masks: Sequence[dict], image: np.ndarray, size: int = 224
) -> np.ndarray:
    """(M, size, size, 3) float32 in [0, 1]: background-zeroed bbox crops,
    square-padded, resized — the CLIP input tiles."""
    crops = []
    for m in masks:
        img = image.copy()
        img[~m["segmentation"].astype(bool)] = 0
        x, y, w, h = (int(v) for v in m["bbox"])
        crop = img[y : y + h, x : x + w]
        if crop.size == 0:
            crop = np.zeros((1, 1, 3), image.dtype)
        crops.append(_resize_bilinear_np(pad_to_square(crop), size) / 255.0)
    if not crops:
        return np.zeros((0, size, size, 3), np.float32)
    return np.stack(crops, 0).astype(np.float32)
