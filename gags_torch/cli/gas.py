"""GAS stage C CLI: SAM masks + CLIP mask embeddings → language features
(port of gags_tpu.cli.gas, the reference `preprocess.py --mindepth_mode`).

Per image: depth-adaptive point prompts from the rendered depth and the
min-depth samples, the four-granularity automatic mask generator, the GAGS
mask NMS, CLIP embeddings of every mask crop, and
`language_features/<img>_{f,s}.npy` in the scene dir, the files
`gags_torch.cli.train_gad` reads.

Checkpoints are the user's (none ships with the repository):
  --sam_ckpt sam_vit_h_4b8939.pth   --clip_ckpt open_clip ViT-B-16 .pt/.bin

  python -m gags_torch.cli.gas -s <scene> -m <model_dir> --iteration 30000 \
      --sam_ckpt ... --clip_ckpt ... [--encoder_batch 4] [--bf16] [--device cpu]

Images (JPEG or 8-bit PNG) are decoded without PIL on the device
(utils.image.read_rgb) and downscaled past 1080 rows with PIL's bilinear
filter computed without PIL (utils.image.resize_uint8_bilinear).
`--bf16` rounds the SAM and CLIP weights to bfloat16 and computes in
float32, which is what the JAX package's flag computes (its bf16
parameters meet float32 inputs, and every op promotes to float32).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import numpy as np
import torch

from gags_torch import resolve_device
from gags_torch.gas import masks as gm
from gags_torch.gas.data_utils import resize_map
from gags_torch.gas.generator import AutomaticMaskGenerator, GeneratorConfig
from gags_torch.gas.prompts import build_all_layer_mindepth_point_grids
from gags_torch.models.clip import CLIPConfig, load_openclip_checkpoint, preprocess_images
from gags_torch.models.sam import SAMConfig
from gags_torch.models.sam_weights import load_sam_checkpoint
from gags_torch.scene.dataset import detect_and_load
from gags_torch.utils.image import read_rgb, resize_uint8_bilinear

LEVELS = ("default", "s", "m", "l")
FILTER_THRESHOLDS = dict(iou_thr=0.8, score_thr=0.7, inner_thr=0.5)  # filter_masks in the CLI
CROP_BATCH = 256  # mask crops per CLIP batch


def load_image_1080p(path: str, device="cuda") -> np.ndarray:
    """An image as uint8 (H, W, 3) on the host, decoded and downscaled to
    1080 rows when taller (the reference caps GAS input at 1080p) on
    `device`, as PIL's convert("RGB") and BILINEAR resize give it."""
    img = read_rgb(path, device)
    h, w = img.shape[:2]
    if h > 1080:
        img = resize_uint8_bilinear(img, (1080, int(round(w * 1080 / h))))
    return np.ascontiguousarray(img.cpu().numpy())


def round_weights_bf16(module: torch.nn.Module) -> torch.nn.Module:
    """Round every float32 parameter and buffer to bfloat16 and back."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            if t.dtype == torch.float32:
                t.copy_(t.to(torch.bfloat16).to(torch.float32))
    return module


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def embed_masks(clip, recs, image: np.ndarray, image_size: int, dev) -> np.ndarray:
    """Unit-norm CLIP embeddings (M, D) float32 of the records' mask crops."""
    crops = gm.extract_mask_crops(recs, image)  # (M, 224, 224, 3) in [0, 1]
    out = []
    with torch.no_grad():
        for c0 in range(0, len(crops), CROP_BATCH):
            x = preprocess_images(torch.as_tensor(crops[c0:c0 + CROP_BATCH], device=dev),
                                  image_size)
            out.append(clip.encode_image(x).cpu().numpy())
    e = np.concatenate(out, 0)
    return e / np.linalg.norm(e, axis=-1, keepdims=True)


def run(source_path: str, model_path: str, iteration: int = 30000, *, sam_ckpt: str,
        clip_ckpt: str, seed: int = 42, encoder_batch: int = 1, bf16: bool = False,
        gen_cfg: Optional[GeneratorConfig] = None, filter_thresholds: Optional[dict] = None,
        sam_cfg: Optional[SAMConfig] = None, clip_cfg: Optional[CLIPConfig] = None,
        device="cuda") -> dict:
    """Write `language_features/<img>_{f,s}.npy` for the scene's training
    cameras. `gen_cfg` (default: the CLI's GeneratorConfig()) and
    `filter_thresholds` (default FILTER_THRESHOLDS) may be lowered, as
    random weights need; `sam_cfg` defaults to ViT-H, `clip_cfg` to
    ViT-B/16.

    Returns {images: {name: {level: masks kept}}, written, seconds, and the
    stage times encode_s, generate_s, clip_s (the card synchronised at each
    stage's end)}."""
    dev = resolve_device(device)
    # true float32 on the card, as the parity tests hold the CPU to the JAX package
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sam, sam_cfg = load_sam_checkpoint(sam_ckpt, sam_cfg or SAMConfig.vit_h(), device=dev)
    clip, clip_cfg = load_openclip_checkpoint(clip_ckpt, clip_cfg, device=dev)
    if bf16:
        round_weights_bf16(sam)
        round_weights_bf16(clip)
    gen = AutomaticMaskGenerator(sam, gen_cfg or GeneratorConfig())
    thresholds = filter_thresholds or FILTER_THRESHOLDS

    info = detect_and_load(source_path, foundation_model="none")
    depth_dir = os.path.join(model_path, "train", f"ours_{iteration}", "depth")
    sample_dir = os.path.join(source_path, "depths_sample")
    out_dir = os.path.join(source_path, "language_features")
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    cams = list(info.train_cameras)
    report = dict(images={}, written=0, encode_s=0.0, generate_s=0.0, clip_s=0.0)
    t_start = time.perf_counter()
    eb = max(1, encoder_batch)
    for g0 in range(0, len(cams), eb):
        work = []
        for ci in cams[g0:g0 + eb]:
            name = os.path.splitext(ci.name)[0]
            image = load_image_1080p(ci.image_path, dev)
            h, w = image.shape[:2]
            # the depth maps may be at another resolution than the image
            depth = resize_map(np.load(os.path.join(depth_dir, name + "_depth.npy")), (h, w))
            sample = resize_map(np.load(os.path.join(sample_dir, name + "_depth_sample.npy")),
                                (h, w), nearest=True)
            grids = build_all_layer_mindepth_point_grids(
                n_per_side=8, n_layers=0, scale_per_layer=1, nsample_min_distance=4,
                depth_map=depth, depth_sample=sample, rng=rng)
            work.append((name, image, grids))
        t0 = time.perf_counter()
        # one ViT batch per group of encoder_batch images
        embeds = gen.encode_images([wk[1] for wk in work])
        _sync(dev)
        report["encode_s"] += time.perf_counter() - t0
        for (name, image, grids), emb in zip(work, embeds):
            h, w = image.shape[:2]
            t0 = time.perf_counter()
            levels = gen.generate(image, grids[0], embed=emb)
            levels = [gm.filter_masks(lvl, **thresholds) for lvl in levels]
            t1 = time.perf_counter()
            embed_lv, segs = {}, {}
            for lname, lvl in zip(LEVELS, levels):
                if lvl:
                    e = embed_masks(clip, lvl, image, clip_cfg.image_size, dev)
                    embed_lv[lname] = e.astype(np.float16)
                    segs[lname] = gm.masks_to_seg_map(lvl, (h, w))
            t2 = time.perf_counter()
            report["generate_s"] += t1 - t0
            report["clip_s"] += t2 - t1
            report["images"][name] = {k: len(v) for k, v in zip(LEVELS, levels)}
            if not embed_lv:
                print(f"{name}: no masks survived, skipping", flush=True)
                continue
            img_embed, seg_maps = gm.pack_granularities(embed_lv, segs)
            np.save(os.path.join(out_dir, name + "_f.npy"), img_embed)
            np.save(os.path.join(out_dir, name + "_s.npy"), seg_maps.astype(np.float32))
            report["written"] += 1
            print(f"{name}: {img_embed.shape[0]} masks", flush=True)
    report["seconds"] = time.perf_counter() - t_start
    return report


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-s", "--source_path", required=True)
    p.add_argument("-m", "--model_path", required=True)
    p.add_argument("--iteration", type=int, default=30000)
    p.add_argument("--sam_ckpt", required=True)
    p.add_argument("--clip_ckpt", required=True)
    p.add_argument("--sam_arch", default="vit_h", choices=["vit_h", "vit_l", "vit_b"])
    p.add_argument("--points_per_batch", type=int, default=256)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--encoder_batch", type=int, default=1,
                   help="images per ViT-encoder batch (the mask generator stays per image)")
    p.add_argument("--bf16", action="store_true",
                   help="round the SAM and CLIP weights to bfloat16 (compute stays float32)")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    r = run(a.source_path, a.model_path, a.iteration, sam_ckpt=a.sam_ckpt,
            clip_ckpt=a.clip_ckpt, seed=a.seed, encoder_batch=a.encoder_batch, bf16=a.bf16,
            gen_cfg=GeneratorConfig(points_per_batch=a.points_per_batch),
            sam_cfg=getattr(SAMConfig, a.sam_arch)(), device=a.device)
    print(f"{r['written']} of {len(r['images'])} images written in {r['seconds']:.1f} s")


if __name__ == "__main__":
    main()
