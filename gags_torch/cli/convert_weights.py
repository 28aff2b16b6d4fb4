"""Real-checkpoint self-check (port of gags_tpu.cli.convert_weights).

Given the upstream files the reference pipeline loads
(`sam_vit_h_4b8939.pth`; OpenCLIP ViT-B-16 laion2b_s34b_b88k; AlphaCLIP
ViT-L/14@336), this tool

  1. diffs the file's key/shape inventory against the expected real layout
     (`models/ckpt_inventory.py`);
  2. loads the file into the port's module with `load_state_dict(strict=
     True)` (the modules carry the upstream names), fp16 files into
     float32 modules;
  3. with --forward, runs one forward pass and, for SAM where the
     HF-transformers package imports, compares the image encoder with
     transformers' SamVisionModel on the same weights.

Usage:
  python -m gags_torch.cli.convert_weights --sam ckpts/sam_vit_h_4b8939.pth \
      --openclip ckpts/open_clip_pytorch_model.bin [--forward] [--device cpu]
"""

from __future__ import annotations

import argparse
import re
import sys
from typing import Optional

import numpy as np
import torch

from gags_torch import resolve_device
from gags_torch.models import ckpt_inventory as inv
from gags_torch.models.clip import (CLIPConfig, load_alphaclip_state_dict,
                                    load_openclip_state_dict)
from gags_torch.models.sam import SAMConfig
from gags_torch.models.sam_weights import load_sam_state_dict

SAM_BY_DIM = {768: SAMConfig.vit_b, 1024: SAMConfig.vit_l, 1280: SAMConfig.vit_h}


def _load(path: str, wrapper: str) -> dict:
    sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    if isinstance(sd, dict) and wrapper in sd:
        sd = sd[wrapper]
    return {k.replace("module.", ""): v for k, v in sd.items()}


def _inventory_diff(name: str, shapes: dict, expected: dict) -> bool:
    missing = sorted(set(expected) - set(shapes))
    extra = sorted(set(shapes) - set(expected))
    mismatched = sorted(k for k in set(expected) & set(shapes)
                        if tuple(expected[k]) != tuple(shapes[k]))
    print(f"[{name}] inventory: {len(shapes)} keys; missing={len(missing)} "
          f"extra={len(extra)} mismatched={len(mismatched)}")
    for k in missing[:5]:
        print(f"  missing from file: {k} {tuple(expected[k])}")
    for k in mismatched[:5]:
        print(f"  shape mismatch: {k} file={shapes[k]} expected={tuple(expected[k])}")
    for k in extra[:5]:
        print(f"  extra in file: {k} {shapes[k]}")
    return not (missing or mismatched or extra)


def _strict_load(name: str, fn, *args):
    try:
        model = fn(*args)
    except RuntimeError as e:  # load_state_dict(strict=True) names every bad key
        print(f"[{name}] strict load FAILED: {str(e).splitlines()[0]}")
        return None
    n = sum(p.numel() for p in model.parameters())
    print(f"[{name}] loaded strictly: {n} parameters, float32")
    return model


def _hf_sam_vision(sd: dict, cfg: SAMConfig):
    """transformers' SamVisionModel holding the same image-encoder weights."""
    from transformers import SamVisionConfig, SamVisionModel

    vc = SamVisionConfig(hidden_size=cfg.encoder_dim, num_hidden_layers=cfg.encoder_depth,
                         num_attention_heads=cfg.encoder_heads, image_size=cfg.image_size,
                         patch_size=cfg.patch_size, window_size=cfg.window_size,
                         global_attn_indexes=list(cfg.global_attn_idx),
                         output_channels=cfg.prompt_dim, mlp_ratio=4.0,
                         num_pos_feats=cfg.prompt_dim // 2, hidden_act="gelu")
    rename = [(r"^image_encoder\.patch_embed\.proj\.", "patch_embed.projection."),
              (r"^image_encoder\.blocks\.(\d+)\.norm(\d)\.", r"layers.\1.layer_norm\2."),
              (r"^image_encoder\.blocks\.", "layers."),
              (r"^image_encoder\.neck\.0\.", "neck.conv1."),
              (r"^image_encoder\.neck\.1\.", "neck.layer_norm1."),
              (r"^image_encoder\.neck\.2\.", "neck.conv2."),
              (r"^image_encoder\.neck\.3\.", "neck.layer_norm2."),
              (r"^image_encoder\.", "")]
    state = {}
    for k, v in sd.items():
        if k.startswith("image_encoder."):
            for pat, rep in rename:
                k2 = re.sub(pat, rep, k)
                if k2 != k:
                    break
            state["vision_encoder." + k2] = v.float()
    hf = SamVisionModel(vc).eval()
    hf.load_state_dict(state, strict=True)
    return hf


def check_sam(path: str, forward: bool, device, cfg: Optional[SAMConfig] = None) -> bool:
    sd = _load(path, "model")
    shapes = {k: tuple(v.shape) for k, v in sd.items()}
    if cfg is None:
        dim = shapes.get("image_encoder.patch_embed.proj.weight", (0,))[0]
        if dim not in SAM_BY_DIM:
            print(f"[sam] encoder width {dim} is none of ViT-B/L/H")
            return False
        cfg = SAM_BY_DIM[dim]()
        print(f"[sam] detected encoder_dim={dim}")
    ok = _inventory_diff("sam", shapes, inv.sam_inventory(cfg))
    model = _strict_load("sam", load_sam_state_dict, sd, cfg, device)
    if model is None:
        return False
    if forward:
        x = torch.as_tensor(np.random.default_rng(0).uniform(
            -1, 1, (1, 3, cfg.image_size, cfg.image_size)).astype(np.float32), device=device)
        with torch.no_grad():
            emb = model.encode_image(x)
        print(f"[sam] forward ok: image embedding {tuple(emb.shape)}, "
              f"|emb| mean {float(emb.abs().mean()):.4f}")
        try:
            hf = _hf_sam_vision(sd, cfg)
        except ImportError as e:
            print(f"[sam] transformers comparison skipped: {e}")
        else:
            with torch.no_grad():
                ref = hf(pixel_values=x.cpu()).last_hidden_state
            err = float((emb.cpu() - ref).abs().max())
            print(f"[sam] encoder vs transformers' SamVisionModel: max|diff|={err:.2e}")
            ok &= err < 5e-3
    return ok


def check_openclip(path: str, forward: bool, device, cfg: Optional[CLIPConfig] = None) -> bool:
    cfg = cfg or CLIPConfig.vit_b_16()
    state = _load(path, "state_dict")
    ok = _inventory_diff("openclip", {k: tuple(v.shape) for k, v in state.items()},
                         inv.openclip_inventory(cfg))
    model = _strict_load("openclip", load_openclip_state_dict, state, cfg, device)
    if model is None:
        return False
    if forward:
        x = torch.as_tensor(np.random.default_rng(0).uniform(
            -1, 1, (1, 3, cfg.image_size, cfg.image_size)).astype(np.float32), device=device)
        with torch.no_grad():
            emb = model.encode_image(x)
        print(f"[openclip] forward ok: {tuple(emb.shape)}, norm {float(emb.norm()):.4f}")
    return ok


def check_alphaclip(path: str, forward: bool, device, cfg: Optional[CLIPConfig] = None) -> bool:
    cfg = cfg or CLIPConfig.vit_l_14_336()
    state = _load(path, "state_dict")
    shapes = {k: tuple(v.shape) for k, v in state.items() if k.startswith("visual.")}
    ok = _inventory_diff("alphaclip", shapes, inv.alphaclip_visual_inventory(cfg))
    model = _strict_load("alphaclip", load_alphaclip_state_dict, state, cfg, device)
    if model is None:
        return False
    if forward:
        s = cfg.image_size
        x = torch.as_tensor(np.random.default_rng(0).uniform(-1, 1, (1, 3, s, s)).astype(
            np.float32), device=device)
        with torch.no_grad():
            emb = model(x, torch.ones((1, 1, s, s), device=device))
        print(f"[alphaclip] forward ok: {tuple(emb.shape)}")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sam", help="path to sam_vit_{b,l,h}*.pth")
    ap.add_argument("--openclip", help="path to an open_clip ViT-B-16 checkpoint")
    ap.add_argument("--alphaclip", help="path to an alpha_clip ViT-L/14@336 checkpoint")
    ap.add_argument("--forward", action="store_true",
                    help="also run a forward pass (and the transformers comparison for SAM)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not (args.sam or args.openclip or args.alphaclip):
        ap.error("supply at least one of --sam/--openclip/--alphaclip")
    dev = resolve_device(args.device)
    ok = True
    if args.sam:
        ok &= check_sam(args.sam, args.forward, dev)
    if args.openclip:
        ok &= check_openclip(args.openclip, args.forward, dev)
    if args.alphaclip:
        ok &= check_alphaclip(args.alphaclip, args.forward, dev)
    print("ALL OK" if ok else "FAILURES: see above")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
