"""Visual self-test of the depth-adaptive SAM prompting of the GAS stage
(port of gags_tpu.cli.visualize_prompts).

Counterpart of the reference's `utils/SAM_utils.py:390-622` __main__
harness, the regression tool for the prompt builders: for each image it
saves a 2x2 panel of (image + prompt points), (rendered depth), (depth
samples), (prompts per cell). Needs matplotlib (imported when it runs);
reads the render CLI's `_depth.npy` maps and depth_sample's maps.

  python -m gags_torch.cli.visualize_prompts -s <scene> -m <model_dir> \\
      --iteration 30000 [-n 4] [-o prompts_vis/]
"""

from __future__ import annotations

import argparse
import os
from typing import List

import numpy as np

from gags_torch.gas.data_utils import resize_map
from gags_torch.gas.prompts import build_mindepth_point_grid
from gags_torch.scene.dataset import detect_and_load
from gags_torch.utils.image import read_rgb


def run(source_path: str, model_path: str, iteration: int = 30000, num_images: int = 4,
        output: str = "", seed: int = 42) -> List[str]:
    """Write one `<image>_prompts.png` panel per image; returns their paths."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out_dir = output or os.path.join(model_path, "prompts_vis")
    os.makedirs(out_dir, exist_ok=True)
    info = detect_and_load(source_path, foundation_model="none")
    depth_dir = os.path.join(model_path, "train", f"ours_{iteration}", "depth")
    sample_dir = os.path.join(source_path, "depths_sample")
    rng = np.random.default_rng(seed)
    written = []
    for ci in info.train_cameras[:num_images]:
        name = os.path.splitext(ci.name)[0]
        img = read_rgb(ci.image_path)
        h, w = img.shape[:2]
        depth = resize_map(np.load(os.path.join(depth_dir, name + "_depth.npy")), (h, w))
        sample = resize_map(np.load(os.path.join(sample_dir, name + "_depth_sample.npy")),
                            (h, w), nearest=True)
        pts, _boxes = build_mindepth_point_grid(8, depth, sample, 4, rng)

        fig, ax = plt.subplots(2, 2, figsize=(14, 8))
        ax[0, 0].imshow(img)
        ax[0, 0].scatter(pts[:, 0] * w, pts[:, 1] * h, s=1, c="red")
        ax[0, 0].set_title(f"{name}: {len(pts)} prompts")
        ax[0, 1].imshow(depth, cmap="viridis")
        ax[0, 1].set_title("rendered depth")
        ax[1, 0].imshow(np.where(sample > 0, sample, np.nan), cmap="viridis")
        ax[1, 0].set_title("min-depth samples")
        hx = np.zeros((8, 8))  # prompts per cell of an 8x8 grid
        cx = np.clip((pts[:, 0] * 8).astype(int), 0, 7)
        cy = np.clip((pts[:, 1] * 8).astype(int), 0, 7)
        np.add.at(hx, (cy, cx), 1)
        im = ax[1, 1].imshow(hx, cmap="magma")
        ax[1, 1].set_title("prompts per 8x8 cell")
        fig.colorbar(im, ax=ax[1, 1])
        for a in ax.flat:
            a.axis("off")
        fig.tight_layout()
        path = os.path.join(out_dir, name + "_prompts.png")
        fig.savefig(path, dpi=110)
        plt.close(fig)
        written.append(path)
        print(f"{name}: {len(pts)} prompts")
    return written


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-s", "--source_path", required=True)
    p.add_argument("-m", "--model_path", required=True)
    p.add_argument("--iteration", type=int, default=30000)
    p.add_argument("-n", "--num_images", type=int, default=4)
    p.add_argument("-o", "--output", default="")
    p.add_argument("--seed", type=int, default=42)
    run(**vars(p.parse_args(argv)))


if __name__ == "__main__":
    main()
