"""Image-quality metrics CLI (port of gags_tpu.cli.metrics), the reference's
`metrics.py`.

Walks `<model>/<split>/ours_<iter>/{renders,gt}`, computes PSNR and SSIM
per view (and LPIPS when a backbone features checkpoint and the LPIPS
linear heads are given) on the device, and writes `results.json` (each
method's means) and `per_view.json` in the reference's format.

  python -m gags_torch.cli.metrics -m <model_dir> [<model_dir> ...] \\
      [--split test] [--vgg_ckpt <features.pth> --lpips_lin_ckpt <lin.pth>
      [--lpips_net vgg|alex|squeeze]] [--device cpu]

Images (JPEG or 8-bit PNG) are decoded by `utils/image.read_rgb` on the
device, without PIL. Convolutions run in float32 (TF32 off).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from gags_torch import resolve_device
from gags_torch.utils.image import read_rgb
from gags_torch.utils.metrics import psnr, ssim


def _load(path: str, device) -> torch.Tensor:
    return read_rgb(path, device).to(torch.float32) / 255.0


@torch.no_grad()
def evaluate_dir(method_dir: str, lpips_fn: Optional[Callable] = None, device="cuda"):
    """(summary {metric: mean}, per_view {metric: {image name: value}}) of
    one `ours_<iter>` directory; LPIPS only with `lpips_fn`."""
    dev = resolve_device(device)
    renders_dir = os.path.join(method_dir, "renders")
    gt_dir = os.path.join(method_dir, "gt")
    per_view: Dict[str, Dict[str, float]] = {"PSNR": {}, "SSIM": {}, "LPIPS": {}}
    for name in sorted(os.listdir(renders_dir)):
        r = _load(os.path.join(renders_dir, name), dev)
        g = _load(os.path.join(gt_dir, name), dev)
        per_view["PSNR"][name] = float(psnr(r, g))
        per_view["SSIM"][name] = float(ssim(r, g))
        if lpips_fn is not None:
            per_view["LPIPS"][name] = float(lpips_fn(r, g))
    summary = {k: float(np.mean(list(v.values()))) for k, v in per_view.items() if v}
    return summary, per_view


def run(model_paths: Sequence[str], split: str = "test", vgg_ckpt: str = "",
        lpips_lin_ckpt: str = "", lpips_net: str = "vgg", device="cuda") -> dict:
    """Evaluate every method dir of each model's split and write its
    results.json and per_view.json; returns {model dir: (results, per_view)}."""
    dev = resolve_device(device)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # SSIM's and LPIPS's convolutions in float32
    try:
        lpips_fn = None
        if vgg_ckpt and lpips_lin_ckpt:
            from gags_torch.utils.lpips import lpips_from_checkpoints

            lpips_fn = lpips_from_checkpoints(vgg_ckpt, lpips_lin_ckpt, net_type=lpips_net,
                                              device=dev)
        out = {}
        for model_dir in model_paths:
            results, per_view_all = {}, {}
            split_dir = os.path.join(model_dir, split)
            for method in sorted(os.listdir(split_dir)):
                method_dir = os.path.join(split_dir, method)
                if not os.path.isdir(os.path.join(method_dir, "renders")):
                    continue
                summary, per_view = evaluate_dir(method_dir, lpips_fn, dev)
                results[method] = summary
                per_view_all[method] = per_view
                print(f"{model_dir} {method}: "
                      + "  ".join(f"{k} {v:.4f}" for k, v in summary.items()))
            with open(os.path.join(model_dir, "results.json"), "w") as f:
                json.dump(results, f, indent=2)
            with open(os.path.join(model_dir, "per_view.json"), "w") as f:
                json.dump(per_view_all, f, indent=2)
            out[model_dir] = (results, per_view_all)
        return out
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-m", "--model_paths", nargs="+", required=True)
    p.add_argument("--split", default="test")
    p.add_argument("--vgg_ckpt", default="", help="backbone features checkpoint")
    p.add_argument("--lpips_lin_ckpt", default="")
    p.add_argument("--lpips_net", default="vgg", choices=["vgg", "alex", "squeeze"])
    p.add_argument("--device", default="cuda")
    run(**vars(p.parse_args(argv)))


if __name__ == "__main__":
    main()
