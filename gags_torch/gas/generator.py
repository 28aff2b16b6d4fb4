"""Automatic mask generation with granularity bucketing (GAS stage C core;
port of gags_tpu.gas.generator).

For every point prompt SAM's three multimask outputs are kept and
bucketed by token, subpart (s) / part (m) / whole (l), plus a
score-selected "default" set; each bucket is filtered by predicted IoU,
stability score and box NMS, then cleaned of small islands and holes,
before the GAGS mask NMS (`gags_torch.gas.masks`).

Prompts run in batches of `points_per_batch` through the mask decoder on
the model's device; the decode of batch k+1 is queued before the host
takes batch k's records. The low-res logits are upscaled to the image in
slices of `upscale_slice` prompts, and the stability scores, areas and
thresholded masks are computed there; only the scores come to the host,
and then only the masks of the records that pass, in one copy.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gags_torch.models.sam import SAM, preprocess_sam_image, resize_geometry
from gags_torch.utils.image import resize_like_jax


@dataclasses.dataclass(frozen=True)
class GeneratorConfig:
    points_per_batch: int = 256
    pred_iou_thresh: float = 0.7
    stability_score_thresh: float = 0.85
    stability_offset: float = 1.0
    box_nms_thresh: float = 0.7
    min_mask_region_area: int = 100
    mask_threshold: float = 0.0
    # prompts whose low-res logits are upscaled to full image size at once:
    # the (B, 4, S, S) f32 upscale costs B*4*S^2*4 bytes (4.3 GB at B=256,
    # S=1024); slices of 32 bound it to ~0.5 GB
    upscale_slice: int = 32


def stability_score(mask_logits: torch.Tensor, thresh: float, offset: float) -> torch.Tensor:
    """IoU between the mask at (thresh + offset) and at (thresh - offset)."""
    hi = (mask_logits > thresh + offset).sum((-2, -1)).to(torch.float32)
    lo = (mask_logits > thresh - offset).sum((-2, -1)).to(torch.float32)
    return hi / lo.clamp_min(1.0)


def mask_to_box(mask: np.ndarray) -> Tuple[int, int, int, int]:
    """XYWH bbox of a binary mask (0, 0, 0, 0 when empty)."""
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return (0, 0, 0, 0)
    return (int(xs.min()), int(ys.min()), int(xs.max() - xs.min() + 1), int(ys.max() - ys.min() + 1))


def box_nms(boxes: np.ndarray, scores: np.ndarray, thresh: float) -> List[int]:
    """Greedy IoU NMS over XYXY boxes (torchvision.batched_nms semantics)."""
    order = np.argsort(-scores, kind="stable")
    keep: List[int] = []
    sup = np.zeros(len(boxes), bool)
    areas = (boxes[:, 2] - boxes[:, 0]).clip(0) * (boxes[:, 3] - boxes[:, 1]).clip(0)
    for i in order:
        if sup[i]:
            continue
        keep.append(int(i))
        x1 = np.maximum(boxes[i, 0], boxes[:, 0])
        y1 = np.maximum(boxes[i, 1], boxes[:, 1])
        x2 = np.minimum(boxes[i, 2], boxes[:, 2])
        y2 = np.minimum(boxes[i, 3], boxes[:, 3])
        inter = (x2 - x1).clip(0) * (y2 - y1).clip(0)
        iou = inter / np.maximum(areas[i] + areas - inter, 1e-9)
        sup |= iou > thresh
    return keep


def remove_small_regions(mask: np.ndarray, area_thresh: float, mode: str) -> Tuple[np.ndarray, bool]:
    """Remove small disconnected regions ('islands') or fill small 'holes'
    (segment-anything's utils.amg.remove_small_regions): 8-connected
    components of the mask (islands) or of its complement (holes) below
    `area_thresh` are flipped; if removing islands would empty the mask,
    the largest island is kept. Components come from scipy.ndimage.label;
    the kept set does not depend on how they are numbered. Returns (mask,
    changed)."""
    from scipy import ndimage

    assert mode in ("holes", "islands")
    correct_holes = mode == "holes"
    working = (correct_holes ^ mask).astype(np.uint8)
    regions, n_comp = ndimage.label(working, structure=np.ones((3, 3)))
    n_labels = n_comp + 1
    sizes = np.bincount(regions.reshape(-1), minlength=n_labels)[1:]
    small = [i + 1 for i, s in enumerate(sizes) if s < area_thresh]
    if not small:
        return mask, False
    fill = [0] + small
    if not correct_holes:
        fill = [i for i in range(n_labels) if i not in fill]
        if not fill:  # every island is small: keep the largest
            fill = [int(np.argmax(sizes)) + 1]
    return np.isin(regions, fill), True


def postprocess_small_regions(recs: List[dict], min_area: int, nms_thresh: float) -> List[dict]:
    """Per-mask island/hole cleanup + dedup NMS, preferring unchanged masks
    (SamAutomaticMaskGenerator.postprocess_small_regions): fill holes below
    min_area, drop islands below min_area, recompute boxes, then box-NMS
    with score 1.0 for untouched masks and 0.0 for modified ones."""
    if not recs or min_area <= 0:
        return recs
    cleaned, scores = [], []
    for r in recs:
        m = r["segmentation"]
        m, ch1 = remove_small_regions(m, min_area, "holes")
        m, ch2 = remove_small_regions(m, min_area, "islands")
        cleaned.append(m)
        scores.append(0.0 if (ch1 or ch2) else 1.0)
    boxes = np.array([(lambda b: [b[0], b[1], b[0] + b[2], b[1] + b[3]])(mask_to_box(m))
                      for m in cleaned], np.float32)
    keep = box_nms(boxes, np.array(scores, np.float32), nms_thresh)
    out = []
    for i in sorted(keep):
        r = recs[i]
        if scores[i] == 0.0:  # changed: rewrite segmentation/area/bbox
            r = dict(r)
            r["segmentation"] = cleaned[i]
            r["area"] = int(cleaned[i].sum())
            r["bbox"] = mask_to_box(cleaned[i])
        out.append(r)
    return out


def upscale_masks(masks_lr: torch.Tensor, size: int, nh: int, nw: int, h: int, w: int) -> torch.Tensor:
    """(B, 4, 4g, 4g) low-res logits → (B, 4, h, w): up to the model's
    input size, crop the resized image's (nh, nw), then to the image's
    (h, w), both as jax.image.resize (antialiased where it shrinks)."""
    ms = resize_like_jax(masks_lr, (size, size))[..., :nh, :nw]
    return resize_like_jax(ms, (h, w))


class AutomaticMaskGenerator:
    """Four-granularity automatic mask generator over a SAM on its device."""

    def __init__(self, sam: SAM, gen_cfg: GeneratorConfig = GeneratorConfig()):
        self.model = sam.eval()
        self.sam_cfg = sam.cfg
        self.cfg = gen_cfg
        self.device = next(sam.parameters()).device

    @torch.no_grad()
    def encode_images(self, images: Sequence[np.ndarray]) -> List[torch.Tensor]:
        """Encode several uint8 (H, W, 3) images in one ViT batch; returns
        one (1, d, g, g) embedding each, for `generate(..., embed=...)`."""
        if not images:
            return []
        batch = torch.cat([preprocess_sam_image(img, self.sam_cfg.image_size, self.device)[0]
                           for img in images])
        embeds = self.model.encode_image(batch)
        return [embeds[i:i + 1] for i in range(len(images))]

    @torch.no_grad()
    def generate(self, image: np.ndarray, point_grid: np.ndarray,
                 embed: Optional[torch.Tensor] = None
                 ) -> Tuple[List[dict], List[dict], List[dict], List[dict]]:
        """image uint8 (H, W, 3); point_grid (P, 2) normalised to [0, 1];
        `embed` an optional (1, d, g, g) embedding from `encode_images`.

        Returns (masks_default, masks_s, masks_m, masks_l): SAM-style dicts
        with segmentation/area/bbox/predicted_iou/stability_score."""
        h, w = image.shape[:2]
        size = self.sam_cfg.image_size
        nh, nw = resize_geometry(h, w, size)
        if embed is None:
            embed = self.encode_images([image])[0]
        cfg = self.cfg
        pb = cfg.points_per_batch
        # prompt coords live in the resized-padded frame, normalised by size
        coords = point_grid * np.array([[nw, nh]]) / size
        buckets: Dict[str, List[dict]] = {"default": [], "s": [], "m": [], "l": []}
        levels = ["s", "m", "l"]

        def dispatch(start):
            pts = torch.as_tensor(coords[start:start + pb, None, :], dtype=torch.float32,
                                  device=self.device)
            lbl = torch.ones(pts.shape[:2], dtype=torch.long, device=self.device)
            return self.model.decode(embed, pts, lbl)

        def consume(masks_lr, iou):
            segs, stabs, areas = [], [], []
            for s0 in range(0, masks_lr.shape[0], cfg.upscale_slice):
                ms = upscale_masks(masks_lr[s0:s0 + cfg.upscale_slice], size, nh, nw, h, w)
                stabs.append(stability_score(ms, cfg.mask_threshold, cfg.stability_offset))
                seg = ms > cfg.mask_threshold
                areas.append(seg.sum((-2, -1)))
                segs.append(seg)
                del ms
            segs = torch.cat(segs)
            stab_np = torch.cat(stabs).cpu().numpy()
            area_np = torch.cat(areas).cpu().numpy()
            iou_np = iou.cpu().numpy()
            # compared in float64, as the reference compares Python floats
            passes = ((iou_np.astype(np.float64) >= cfg.pred_iou_thresh)
                      & (stab_np.astype(np.float64) >= cfg.stability_score_thresh)
                      & (area_np >= 1))
            passes[:, 0] = False  # channel 0 (single-mask output) is not bucketed
            want = np.argwhere(passes)
            if not len(want):
                return
            seg_np = segs[torch.as_tensor(want[:, 0], device=segs.device),
                          torch.as_tensor(want[:, 1], device=segs.device)].cpu().numpy()
            recs = {}
            for (i, ch), seg in zip(want.tolist(), seg_np):
                recs[i, ch] = dict(segmentation=seg, area=int(area_np[i, ch]),
                                   bbox=mask_to_box(seg), predicted_iou=float(iou_np[i, ch]),
                                   stability_score=float(stab_np[i, ch]))
            for i in range(len(iou_np)):
                cand = [ch for ch in range(1, 4) if area_np[i, ch] >= 1]
                for ch in cand:
                    if (i, ch) in recs:
                        buckets[levels[ch - 1]].append(recs[i, ch])
                if cand:
                    # the candidate of highest predicted IoU (the first on a
                    # tie) is the default pick, kept where it passes
                    best = max(cand, key=lambda ch: float(iou_np[i, ch]))
                    if (i, best) in recs:
                        buckets["default"].append(recs[i, best])

        pending = None
        for start in range(0, len(point_grid), pb):
            nxt = dispatch(start)
            if pending is not None:
                consume(*pending)
            pending = nxt
        if pending is not None:
            consume(*pending)

        out = []
        for k in ["default", "s", "m", "l"]:
            recs = buckets[k]
            if recs:
                boxes = np.array([[r["bbox"][0], r["bbox"][1], r["bbox"][0] + r["bbox"][2],
                                   r["bbox"][1] + r["bbox"][3]] for r in recs], np.float32)
                scores = np.array([r["predicted_iou"] for r in recs], np.float32)
                recs = [recs[i] for i in box_nms(boxes, scores, cfg.box_nms_thresh)]
                recs = postprocess_small_regions(recs, cfg.min_mask_region_area,
                                                 cfg.box_nms_thresh)
            out.append(recs)
        return tuple(out)
