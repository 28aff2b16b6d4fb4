"""The pair counts of a render's own inputs, from the plain reference
rasterizer: the (pixel, instance) pairs walked, near and blended, the
instances and the Gaussians seen. Plain PyTorch, run after the window."""

from __future__ import annotations

import torch

from benchmark.reference import raster


@torch.no_grad()
def count(means, quats, scales, opacities, viewmat, K, width: int, height: int) -> dict:
    proj = raster.project(means, quats, scales, opacities, viewmat, K, width, height)
    lists = raster.tile_lists(proj, width, height)
    w = raster.walk(proj, opacities, lists, width, height, want_pairs=False)
    return dict(walked=w.walked, near=w.near, blended=w.blended, instances=w.instances,
                visible=w.visible, tiles=lists.tiles_x * lists.tiles_y, pixels=width * height)
