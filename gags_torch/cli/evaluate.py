"""IoU / localisation evaluation CLI, the LERF-OVS protocol (port of
gags_tpu.cli.evaluate, the reference `evaluate_iou_loc.py`).

Needs a model dir (read by `cli.relevancy.load_query_model`), the scene,
a labelme ground-truth folder (frame_*.json; the user's own, none ships
with the repository) and text embeddings: an encode_text npz
(--text_embeds) or a CLIP checkpoint and its BPE merges (--clip_ckpt
--bpe), whose text tower is loaded once for the run. Each labelled frame
is rendered at the labels' resolution, decoded, and scored per label;
the summary (mIoU, localisation accuracy, per-frame results) goes to
<model>/iou_loc_<iteration>.json.

  python -m gags_torch.cli.evaluate -m <model> -s <scene> --gt_json <labels> \
      --iteration 30000 [--mask_thresh 0.4] \
      (--text_embeds e.npz | --clip_ckpt open_clip.pt --bpe vocab.txt.gz) [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from gags_torch import resolve_device
from gags_torch.cli.relevancy import inference_config, load_query_model
from gags_torch.models.clip import CLIPConfig
from gags_torch.query.eval_iou import (
    eval_frame_iou,
    eval_frame_localization,
    frame_relevancy,
    load_lerf_gt,
)
from gags_torch.query.grounding import decode_map_rows
from gags_torch.query.relevancy import DEFAULT_NEGATIVES
from gags_torch.scene.dataset import camera_from_info, detect_and_load
from gags_torch.splat.render import render


class TextEmbeds:
    """Unit-norm text embeddings by label: from an encode_text npz, or
    from a CLIP checkpoint's text tower, loaded once and run once per new
    label."""

    def __init__(self, text_embeds: Optional[str] = None, clip_ckpt: Optional[str] = None,
                 bpe: Optional[str] = None, clip_cfg: Optional[CLIPConfig] = None,
                 device="cuda"):
        self._cache: dict = {}
        if text_embeds:
            data = np.load(text_embeds)
            for label, e in zip(data["labels"], data["pos"]):
                self._cache[str(label)] = e
            self.neg = data["neg"]
            self._encode = None
            return
        if not clip_ckpt:
            raise ValueError("text embeddings need --text_embeds or --clip_ckpt")
        from gags_torch.models.clip import load_openclip_checkpoint
        from gags_torch.models.tokenizer import ClipTokenizer

        model, _ = load_openclip_checkpoint(clip_ckpt, clip_cfg, device=device)
        tok = ClipTokenizer(bpe or None)

        @torch.no_grad()
        def encode(texts):
            e = model.encode_text(torch.as_tensor(tok(list(texts)), device=device)).cpu().numpy()
            return e / np.linalg.norm(e, axis=-1, keepdims=True)

        self._encode = encode
        self.neg = encode(DEFAULT_NEGATIVES)

    def pos(self, labels) -> np.ndarray:
        missing = [l for l in labels if l not in self._cache]
        if missing and self._encode is None:
            raise KeyError(f"labels not in the text embeddings: {missing}")
        if missing:
            self._cache.update(zip(missing, self._encode(missing)))
        return np.stack([self._cache[l] for l in labels])


def run(model_path: str, source_path: str, gt_json: str, iteration: int = 30000, *,
        mask_thresh: float = 0.4, text_embeds: Optional[str] = None,
        clip_ckpt: Optional[str] = None, bpe: Optional[str] = None,
        clip_cfg: Optional[CLIPConfig] = None, device="cuda",
        on_frame: Optional[Callable] = None) -> dict:
    """Evaluate every labelled frame; returns {miou, loc_acc, frames:
    {index: {labels, ious, loc_hits}}, seconds_per_frame} and writes it.
    `on_frame(index, decoded, result)` sees each frame's decoded map (its
    time is not counted in seconds_per_frame)."""
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False  # decode and relevancy in full float32
    gt_ann, (gh, gw), _ = load_lerf_gt(gt_json)
    info = detect_and_load(source_path, foundation_model="none")
    scene, decoder = load_query_model(model_path, iteration, dev)
    raster = inference_config(model_path)
    text = TextEmbeds(text_embeds, clip_ckpt, bpe, clip_cfg, dev)
    ious, loc_hits, loc_total, results = [], 0, 0, {}
    t0, callback_s = time.perf_counter(), 0.0
    for frame_idx, ann in sorted(gt_ann.items(), key=lambda kv: int(kv[0])):
        cam = camera_from_info(info.train_cameras[int(frame_idx)], -1).resized(gw, gh)
        with torch.no_grad():
            out = render(cam, means=scene.means, quats=scene.quats, scales=scene.scales,
                         opacities=scene.opacities, semantic_features=scene.semantic_features,
                         feature_mode=True, bg_color=torch.zeros((3,), device=dev),
                         config=raster, device=dev)
            decoded = decode_map_rows(decoder, out.render)
        labels = list(ann.keys())
        pos = text.pos(labels)
        rel = frame_relevancy(decoded, pos, text.neg)
        frame_ious = eval_frame_iou(decoded, pos, text.neg, ann, labels, mask_thresh, rel=rel)
        hits = eval_frame_localization(decoded, pos, text.neg, ann, labels, rel=rel)
        ious.extend(frame_ious)
        loc_hits += hits
        loc_total += len(labels)
        results[frame_idx] = dict(labels=labels, ious=frame_ious, loc_hits=hits)
        print(f"frame {frame_idx}: mIoU {np.mean(frame_ious):.4f} loc {hits}/{len(labels)}",
              flush=True)
        if on_frame is not None:
            t1 = time.perf_counter()
            on_frame(frame_idx, decoded, results[frame_idx])
            callback_s += time.perf_counter() - t1
    seconds = time.perf_counter() - t0 - callback_s
    summary = dict(miou=float(np.mean(ious)) if ious else 0.0,
                   loc_acc=loc_hits / max(loc_total, 1), frames=results,
                   seconds_per_frame=seconds / max(len(results), 1))
    with open(os.path.join(model_path, f"iou_loc_{iteration}.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-m", "--model_path", required=True)
    p.add_argument("-s", "--source_path", required=True)
    p.add_argument("--gt_json", required=True)
    p.add_argument("--iteration", type=int, default=30000)
    p.add_argument("--mask_thresh", type=float, default=0.4)
    p.add_argument("--text_embeds", default="")
    p.add_argument("--clip_ckpt", default="")
    p.add_argument("--bpe", default="")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    s = run(a.model_path, a.source_path, a.gt_json, a.iteration, mask_thresh=a.mask_thresh,
            text_embeds=a.text_embeds or None, clip_ckpt=a.clip_ckpt or None,
            bpe=a.bpe or None, device=a.device)
    print(f"mIoU: {s['miou']:.4f}  localization acc: {s['loc_acc']:.4f}")


if __name__ == "__main__":
    main()
