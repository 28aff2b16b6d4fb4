"""Adaptive density control as functions of a GaussianScene: clone, split,
prune, opacity reset (port of gags_tpu.scene.densify).

Functional counterparts of the reference's in-place optimizer surgery
(`scene/gaussian_model.py:336-468`): each op returns a new GaussianScene.
The RGB trainer keeps a fixed-capacity state instead, but its
`rgb.train.densify_step` and `reset_opacity_step` take the arithmetic
from here: which Gaussians clone and which split (`densify_masks`), where
a split's children go (`split_means`, `split_scales_raw`) and the reset
opacity (`reset_opacity_raw`). GAD keeps geometry frozen and never calls
them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from gags_torch.core.transforms import inverse_sigmoid, quat_to_rotmat
from gags_torch.scene.gaussian_data import GaussianScene

_FIELDS = ("means", "sh", "opacities_raw", "scales_raw", "quats", "semantic_features")


def _concat_scene(a: GaussianScene, b: GaussianScene) -> GaussianScene:
    return dataclasses.replace(a, **{
        f: None if getattr(a, f) is None else torch.cat([getattr(a, f), getattr(b, f)])
        for f in _FIELDS})


def _subset(scene: GaussianScene, mask) -> GaussianScene:
    idx = torch.nonzero(torch.as_tensor(mask, device=scene.means.device))[:, 0]
    return dataclasses.replace(scene, **{
        f: None if getattr(scene, f) is None else getattr(scene, f)[idx] for f in _FIELDS})


def densify_masks(grads: torch.Tensor, max_scale: torch.Tensor, grad_threshold: float,
                  scene_extent: float, percent_dense: float = 0.01):
    """(clone, split) masks: the under-reconstructed Gaussians (mean
    positional gradient norm at least `grad_threshold`), the small ones
    cloned, the large ones split."""
    sel = grads >= grad_threshold
    small = max_scale <= percent_dense * scene_extent
    return sel & small, sel & ~small


def split_means(means, quats, scales, samples) -> torch.Tensor:
    """Children's means drawn from each parent Gaussian: means + R (samples
    * scales), with unit normal `samples` (k, 3), computed in the samples'
    dtype and returned in the means'."""
    dt = samples.dtype
    R = quat_to_rotmat(quats).to(dt)
    return (means.to(dt) + torch.einsum("nij,nj->ni", R, samples * scales.to(dt))).to(means.dtype)


def split_scales_raw(scales_raw: torch.Tensor, n_split: int) -> torch.Tensor:
    """Log scales of a split's children: the parent's divided by 0.8 n."""
    return scales_raw - math.log(0.8 * n_split)


def reset_opacity_raw(opacities: torch.Tensor, ceiling: float = 0.01) -> torch.Tensor:
    """Opacity logits clamped down to `ceiling`."""
    return inverse_sigmoid(torch.clamp(torch.clamp_max(opacities, ceiling), 1e-6, 1 - 1e-6))


def _masks(scene: GaussianScene, grads, grad_threshold, scene_extent, percent_dense):
    grads = torch.as_tensor(np.asarray(grads), device=scene.means.device)
    return densify_masks(grads, scene.scales.max(dim=1).values, grad_threshold, scene_extent,
                         percent_dense)


def densify_and_clone(scene: GaussianScene, grads, grad_threshold: float,
                      scene_extent: float, percent_dense: float = 0.01) -> GaussianScene:
    """Duplicate small under-reconstructed Gaussians in place
    (gaussian_model.py:440-454). `grads` (N,) is the mean view-space
    positional gradient norm."""
    sel = _masks(scene, grads, grad_threshold, scene_extent, percent_dense)[0]
    if not sel.any():
        return scene
    return _concat_scene(scene, _subset(scene, sel))


def densify_and_split(scene: GaussianScene, grads, grad_threshold: float,
                      scene_extent: float, percent_dense: float = 0.01, n_split: int = 2,
                      rng: Optional[torch.Generator] = None,
                      noise: Optional[Sequence] = None) -> GaussianScene:
    """Split large over-reconstructed Gaussians into n smaller samples
    (gaussian_model.py:415-438): children are drawn from the parent
    Gaussian, scales divided by 0.8 n, the parent removed.

    The unit normal samples come from `rng` (a torch.Generator, seeded 0
    when absent), or from `noise`: n_split arrays of shape (k, 3) for the
    k selected parents, so that a caller can replay another package's
    numbers. As in the JAX package, the children's means are computed in
    float64 and stored in float32."""
    sel = _masks(scene, grads, grad_threshold, scene_extent, percent_dense)[1]
    if not sel.any():
        return scene
    parent = _subset(scene, sel)
    k = parent.num_gaussians
    if noise is None:
        rng = rng if rng is not None else torch.Generator().manual_seed(0)
        noise = [torch.randn((k, 3), generator=rng, dtype=torch.float64) for _ in range(n_split)]
    out = _subset(scene, ~sel)
    for samples in noise:
        samples = torch.as_tensor(np.asarray(samples), dtype=torch.float64).to(scene.means.device)
        child = dataclasses.replace(
            parent, means=split_means(parent.means, parent.quats, parent.scales, samples),
            scales_raw=split_scales_raw(parent.scales_raw, n_split))
        out = _concat_scene(out, child)
    return out


def prune(scene: GaussianScene, min_opacity: float = 0.005,
          scene_extent: Optional[float] = None, max_radii2d=None,
          max_screen_size: Optional[float] = None) -> Tuple[GaussianScene, torch.Tensor]:
    """Drop transparent or oversized Gaussians (gaussian_model.py:456-468).
    Returns (scene, kept mask)."""
    bad = scene.opacities < min_opacity
    if max_screen_size is not None and max_radii2d is not None:
        bad |= torch.as_tensor(np.asarray(max_radii2d), device=bad.device) > max_screen_size
        if scene_extent is not None:
            bad |= scene.scales.max(dim=1).values > 0.1 * scene_extent
    return _subset(scene, ~bad), ~bad


def reset_opacity(scene: GaussianScene, ceiling: float = 0.01) -> GaussianScene:
    """Clamp opacities down to `ceiling` (gaussian_model.py:261-264)."""
    return dataclasses.replace(scene, opacities_raw=reset_opacity_raw(scene.opacities, ceiling))
