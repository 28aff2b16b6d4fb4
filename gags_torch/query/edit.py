"""Scene editing: recolour, delete or extract the Gaussians a text query
selects (port of gags_tpu.query.edit).

The reference ships YAML edit configs (`configs/edit_{color,deletion,
extraction}.yaml`): a list of objects, the targets among them, a
threshold (none: argmax over the objects) and the operation. Gaussians
are selected by cosine similarity of their decoded features to the
objects' text embeddings, then

  * color_func: the config's colour lambda on the selected Gaussians'
    SH dc colour (their higher-order SH zeroed, so the recolour is exact),
  * deletion: the selected Gaussians removed,
  * extraction: only the selected Gaussians kept.

The colour lambda gets the (N, 3) RGB as a numpy array, in a namespace
with `np` and `torch`, so a config written for the JAX package (which
offers `np` and `jnp`) works here when it uses `np`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from gags_torch.core.sh import rgb_to_sh, sh_to_rgb
from gags_torch.scene.gaussian_data import GaussianScene


@dataclasses.dataclass
class EditConfig:
    objects: List[str]
    operation: str  # "color_func" | "deletion" | "extraction"
    targets: List[str]
    threshold: Optional[float] = None  # None → argmax over objects
    color_func: Optional[str] = None  # python lambda source over (N, 3) rgb

    @staticmethod
    def from_yaml(path: str) -> "EditConfig":
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f)["edit"]
        targets = data.get("targets", [])
        if isinstance(targets, str):
            targets = [targets]
        ops = data.get("operations", "color_func")
        if isinstance(ops, (list, tuple)):
            ops = ops[0]
        return EditConfig(
            objects=list(data["objects"]),
            operation=str(ops),
            targets=targets,
            threshold=data.get("threshold"),
            color_func=data.get("colorFunc"),
        )


def select_by_text(decoded: torch.Tensor, object_embeds: torch.Tensor,
                   target_ids: Sequence[int], threshold: Optional[float]) -> torch.Tensor:
    """(N,) bool: Gaussians assigned to any target object. Without a
    threshold a Gaussian belongs to the object of highest cosine
    similarity; with one, its similarity to a target must exceed it."""
    d = decoded / torch.clamp_min(torch.linalg.norm(decoded, dim=-1, keepdim=True), 1e-9)
    e = object_embeds / torch.clamp_min(
        torch.linalg.norm(object_embeds, dim=-1, keepdim=True), 1e-9)
    sims = d @ e.T  # (N, L)
    tid = torch.as_tensor(list(target_ids), dtype=torch.long, device=decoded.device)
    if threshold is None:
        return torch.isin(torch.argmax(sims, dim=-1), tid)
    return torch.any(sims[:, tid] > threshold, dim=-1)


def _subset(scene: GaussianScene, mask: torch.Tensor) -> GaussianScene:
    idx = torch.nonzero(mask.to(scene.means.device), as_tuple=True)[0]
    return GaussianScene(
        means=scene.means[idx],
        sh=scene.sh[idx],
        opacities_raw=scene.opacities_raw[idx],
        scales_raw=scene.scales_raw[idx],
        quats=scene.quats[idx],
        semantic_features=(None if scene.semantic_features is None
                           else scene.semantic_features[idx]),
        max_sh_degree=scene.max_sh_degree,
    )


def apply_edit(scene: GaussianScene, mask: torch.Tensor, operation: str,
               color_func: Optional[Callable] = None) -> GaussianScene:
    """The edited scene (the input is not changed)."""
    if operation == "deletion":
        return _subset(scene, ~mask)
    if operation == "extraction":
        return _subset(scene, mask)
    if operation == "color_func":
        if color_func is None:
            raise ValueError("color_func edit needs a colour function")
        sel = mask.to(scene.means.device)
        rgb = sh_to_rgb(scene.sh[:, 0, :])
        new_rgb = torch.as_tensor(np.asarray(color_func(rgb.detach().cpu().numpy()), np.float32),
                                  device=rgb.device)
        dc = torch.where(sel[:, None], rgb_to_sh(new_rgb), scene.sh[:, 0, :])
        # zero higher-order SH on edited gaussians so the recolour is exact
        rest = torch.where(sel[:, None, None], torch.zeros_like(scene.sh[:, 1:, :]),
                           scene.sh[:, 1:, :])
        return dataclasses.replace(scene, sh=torch.cat([dc[:, None, :], rest], dim=1))
    raise ValueError(f"unknown edit operation {operation!r}")


def parse_color_func(src: str) -> Callable:
    """Compile the config's colour lambda in a namespace of `np` and
    `torch` only, no builtins."""
    allowed = {"np": np, "torch": torch, "__builtins__": {}}
    fn = eval(src, allowed)  # noqa: S307 — user-authored config, restricted namespace
    if not callable(fn):
        raise ValueError("colorFunc must be a lambda/callable")
    return fn
