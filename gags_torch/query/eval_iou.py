"""Open-vocabulary IoU and localisation evaluation, the LERF-OVS protocol
(port of gags_tpu.query.eval_iou):

  * labelme-style ground truth, one frame_*.json per evaluated frame →
    per-label merged masks and boxes (`load_lerf_gt`), polygons filled
    exactly as Pillow's ImageDraw.polygon fills them (`polygon_to_mask`,
    no PIL needed);
  * per prompt: relevancy map → 30x30 box filter average → min/max
    normalise → threshold → majority smoothing → IoU (`eval_frame_iou`);
  * localisation: every argmax pixel of the box-filtered relevancy tested
    against the label's boxes (`eval_frame_localization`).

The relevancy chain runs on the decoded map's device; masks, IoUs and
boxes are numpy on the host.
"""

from __future__ import annotations

import glob
import json
import math
import os
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np
import torch

from gags_torch.query.relevancy import (
    box_filter_reflect101,
    heatmap_to_mask,
    iou,
    majority_smooth,
    max_across_levels,
)

_F32 = np.float32


def _roundf(v) -> float:
    """C roundf: half away from zero."""
    v = float(v)
    return math.floor(v + 0.5) if v >= 0 else -math.floor(-v + 0.5)


def _round_up(f) -> int:
    """Pillow's ROUND_UP of a float: floor(f + 0.5f), the sum in float32."""
    f = _F32(f)
    if f >= 0:
        return int(math.floor(_F32(f + _F32(0.5))))
    return -int(math.floor(_F32(abs(f) + _F32(0.5))))


def _round_down(f) -> int:
    """Pillow's ROUND_DOWN of a float: ceil(f - 0.5f), the difference in float32."""
    f = _F32(f)
    if f >= 0:
        return int(math.ceil(_F32(f - _F32(0.5))))
    return -int(math.ceil(_F32(abs(f) - _F32(0.5))))


def _polygon_edges(xy: np.ndarray) -> np.ndarray:
    """Pillow's edge list of an integer polygon (closed implicitly): rows of
    [xmin, xmax, ymin, ymax, x0, y0, x1, y1]; a horizontal edge that
    continues a horizontal edge in the same x direction extends it."""
    count = len(xy)
    edges = []
    for i in range(count - 1):
        (x0, y0), (x1, y1) = xy[i], xy[i + 1]
        if y0 == y1 and i != 0 and y0 == xy[i - 1][1]:
            if x1 > x0 > xy[i - 1][0]:
                edges[-1][1] = x1
                continue
            if x1 < x0 < xy[i - 1][0]:
                edges[-1][0] = x1
                continue
        edges.append([min(x0, x1), max(x0, x1), min(y0, y1), max(y0, y1), x0, y0, x1, y1])
    (x0, y0), (x1, y1) = xy[-1], xy[0]
    if (x0, y0) != (x1, y1):
        edges.append([min(x0, x1), max(x0, x1), min(y0, y1), max(y0, y1), x0, y0, x1, y1])
    return np.asarray(edges, np.int64).reshape(-1, 8)


def polygon_to_mask(img_shape: Tuple[int, int], points) -> np.ndarray:
    """(H, W) uint8 mask of a polygon, the pixels Pillow 12's
    ImageDraw.polygon(points, fill=1, outline=1) sets (the outline of the
    same ink adds none), without PIL.

    Pillow's rule: vertices truncated toward zero; horizontal edges drawn
    as runs; for every other row, each edge crossing it gives
    x = (y - y0) * dx + x0 in float32 (twice on its last row, unless that
    is the polygon's last), where two edges meet in a tip at a vertex
    row the later one's x moves to one pixel short of the adjacent row's
    span, the crossings are sorted and each pair (a, b) fills round_up(a) ..
    round_down(b). Held to PIL bit for bit in tests/test_torch_eval_iou.py
    on seeded convex, concave, star and self-intersecting polygons and on
    polygons that fold back on themselves.
    """
    h, w = int(img_shape[0]), int(img_shape[1])
    out = np.zeros((h, w), np.uint8)
    pts = np.asarray(points, np.float64).reshape(-1, 2)
    if len(pts) == 0:
        return out
    xy = [(int(x), int(y)) for x, y in np.trunc(pts)]
    e = _polygon_edges(xy)
    if len(e) == 0:
        return out

    def hline(xa: int, y: int, xb: int) -> None:
        if 0 <= y < h and xa < w and xb >= 0:
            out[y, max(xa, 0):min(xb, w - 1) + 1] = 1

    flat = e[:, 2] == e[:, 3]
    for xa, xb, y in e[flat][:, [0, 1, 2]]:
        hline(int(xa), int(y), int(xb))
    ymin = max(min(h - 1, int(e[:, 2].min())), 0)
    ymax = min(max(0, int(e[:, 3].max())), h)
    t = e[~flat]
    if len(t) == 0:
        return out
    t_ymin, t_ymax, t_y0 = t[:, 2], t[:, 3], t[:, 5]
    dx = (t[:, 6] - t[:, 4]).astype(_F32) / (t[:, 7] - t[:, 5]).astype(_F32)
    x0 = t[:, 4].astype(_F32)

    def x_at(y: int, k) -> np.ndarray:
        return ((_F32(y) - t_y0[k].astype(_F32)) * dx[k] + x0[k]).astype(_F32)

    for y in range(ymin, ymax + 1):
        act = np.nonzero((t_ymin <= y) & (y <= t_ymax))[0]
        if len(act) == 0:
            continue
        xs = x_at(y, act)
        dup = (t_ymax[act] == y) & (y < ymax)
        at_vertex = (t_ymin[act] == y) | (t_ymax[act] == y)
        xs0 = xs.copy()
        for c in np.nonzero(~dup & at_vertex & (dx[act] != 0))[0]:
            # a tip: the first earlier sloped edge through the same vertex
            # that reaches the adjacent row decides, on either side (edges
            # that part there, or retrace this one, leave x as it is)
            cur = act[c]
            for o in np.nonzero(at_vertex[:c])[0]:
                k = act[o]
                if dx[k] == 0:
                    continue
                if _roundf(xs0[c]) != _roundf(xs0[o]):
                    continue
                off = -1 if y == t_ymax[cur] else 1
                if not t_ymin[k] <= y + off <= t_ymax[k]:
                    continue
                a1, a2 = x_at(y + off, cur), x_at(y + off, k)
                if xs[c] > _F32(a1 + 1) and xs[c] > _F32(a2 + 1):
                    xs[c] = _F32(_roundf(max(a1, a2)) + 1)
                elif xs[c] < _F32(a1 - 1) and xs[c] < _F32(a2 - 1):
                    xs[c] = _F32(_roundf(min(a1, a2)) - 1)
                break
        xx = np.sort(np.concatenate([xs, xs[dup]]))
        for q in range(1, len(xx), 2):
            xa, xb = _round_up(xx[q - 1]), _round_down(xx[q])
            if xb >= xa:
                hline(xa, y, xb)
    return out


def load_lerf_gt(json_folder: str) -> Tuple[Dict, Tuple[int, int], List[str]]:
    """Parse frame_*.json labelme annotations → ({frame index: {label:
    {'bboxes': (k, 4) or (4,), 'mask': (H, W) uint8}}}, (H, W), the
    folder's frame_*.jpg paths)."""
    gt_paths = sorted(glob.glob(os.path.join(json_folder, "frame_*.json")))
    img_paths = sorted(glob.glob(os.path.join(json_folder, "frame_*.jpg")))
    gt_ann = {}
    h = w = 0
    for path in gt_paths:
        with open(path) as f:
            data = json.load(f)
        h, w = data["info"]["height"], data["info"]["width"]
        idx = int(data["info"]["name"].split("_")[-1].split(".jpg")[0]) - 1
        ann = defaultdict(dict)
        for obj in data["objects"]:
            label = obj["category"]
            box = np.asarray(obj["bbox"]).reshape(-1)
            mask = polygon_to_mask((h, w), obj["segmentation"])
            if ann[label].get("mask") is not None:
                merged = ann[label]["mask"].copy()
                merged[mask != 0] = 1
                mask = merged
                ann[label]["bboxes"] = np.concatenate(
                    [ann[label]["bboxes"].reshape(-1, 4), box.reshape(-1, 4)], axis=0)
            else:
                ann[label]["bboxes"] = box
            ann[label]["mask"] = mask
        gt_ann[str(idx)] = dict(ann)
    return gt_ann, (h, w), img_paths


def frame_relevancy(decoded, pos_embeds, neg_embeds) -> torch.Tensor:
    """(P, H, W) relevancy of an (H, W, D) decoded map, on its device."""
    d = torch.as_tensor(decoded)
    pos = torch.as_tensor(np.asarray(pos_embeds, np.float32), device=d.device)
    neg = torch.as_tensor(np.asarray(neg_embeds, np.float32), device=d.device)
    return max_across_levels(d[None], pos, neg)[0]


def eval_frame_iou(decoded, pos_embeds, neg_embeds, img_ann: Dict, labels: List[str],
                   thresh: float = 0.4, rel: torch.Tensor | None = None) -> List[float]:
    """Per-prompt IoU for one frame; `decoded` (H, W, D) tensor or array,
    `pos_embeds` (P, D) one per label in order. `rel` reuses a (P, H, W)
    relevancy already computed from them."""
    rel = frame_relevancy(decoded, pos_embeds, neg_embeds) if rel is None else rel
    ious = []
    for k, label in enumerate(labels):
        mask_pred, _ = heatmap_to_mask(rel[k], thresh)
        mask_pred = majority_smooth(mask_pred).cpu().numpy()
        ious.append(iou(mask_pred.astype(bool), img_ann[label]["mask"].astype(bool)))
    return ious


def eval_frame_localization(decoded, pos_embeds, neg_embeds, img_ann: Dict,
                            labels: List[str], rel: torch.Tensor | None = None) -> int:
    """Number of prompts whose box-filtered relevancy argmax (any of its
    tied pixels) falls in one of the label's boxes."""
    rel = frame_relevancy(decoded, pos_embeds, neg_embeds) if rel is None else rel
    acc = 0
    for k, label in enumerate(labels):
        filt = box_filter_reflect101(rel[k], 30).cpu().numpy()
        ys, xs = np.nonzero(filt == filt.max())
        coords = np.stack([xs, ys], -1)
        for box in np.asarray(img_ann[label]["bboxes"]).reshape(-1, 4):
            x1, y1, x2, y2 = box
            x_min, x_max = min(x1, x2), max(x1, x2)
            y_min, y_max = min(y1, y2), max(y1, y2)
            inside = ((coords[:, 0] >= x_min) & (coords[:, 0] <= x_max)
                      & (coords[:, 1] >= y_min) & (coords[:, 1] <= y_max))
            if inside.any():
                acc += 1
                break
    return acc
