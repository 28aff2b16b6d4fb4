"""Checkpoint / resume for GAD training (port of gags_tpu.gad.checkpoints).

A checkpoint is `chkpnt<N>/state.pt` (torch.save of the features, both
decoders' state dicts and the three Adam states), so the `chkpnt<digits>`
directory scan of `latest_checkpoint_step` is the JAX package's. The
renderable snapshot is `point_cloud/iteration_N/point_cloud.ply` with
`semantic_*` fields, in the reference's directory convention.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from gags_torch.gad.train import TrainState
from gags_torch.scene.gaussian_data import GaussianScene

STATE_FILE = "state.pt"


def save_checkpoint(model_dir: str, state: TrainState, step: int) -> str:
    path = os.path.abspath(os.path.join(model_dir, f"chkpnt{step}"))
    os.makedirs(path, exist_ok=True)
    torch.save(
        dict(
            step=state.step,
            features=state.features.detach().cpu(),
            decoder=state.decoder.state_dict(),
            scale_decoder=state.scale_decoder.state_dict(),
            opt_feat=state.opt_feat.state_dict(),
            opt_dec=state.opt_dec.state_dict(),
            opt_scale=state.opt_scale.state_dict(),
        ),
        os.path.join(path, STATE_FILE),
    )
    return path


def load_checkpoint(model_dir: str, step: int, template: TrainState) -> TrainState:
    """Restore checkpoint `step` into `template` (in place) and return it."""
    path = os.path.join(model_dir, f"chkpnt{step}", STATE_FILE)
    blob = torch.load(path, map_location=template.device, weights_only=True)
    with torch.no_grad():
        template.features.copy_(blob["features"])
    template.decoder.load_state_dict(blob["decoder"])
    template.scale_decoder.load_state_dict(blob["scale_decoder"])
    template.opt_feat.load_state_dict(blob["opt_feat"])
    template.opt_dec.load_state_dict(blob["opt_dec"])
    template.opt_scale.load_state_dict(blob["opt_scale"])
    template.step = int(blob["step"])
    return template


def latest_checkpoint_step(model_dir: str) -> Optional[int]:
    """N of the newest `chkpnt<N>/` in `model_dir`, None where there is none.

    Raises ValueError when that directory holds no `state.pt` (an orbax
    checkpoint of the JAX package, say): skipping it would serve an older
    checkpoint's features as the newest."""
    if not os.path.isdir(model_dir):
        return None
    steps = [int(name[6:]) for name in os.listdir(model_dir)
             if name.startswith("chkpnt") and name[6:].isdigit()]
    if not steps:
        return None
    path = os.path.join(model_dir, f"chkpnt{max(steps)}")
    if not os.path.isfile(os.path.join(path, STATE_FILE)):
        raise ValueError(
            f"{path} is not a gags_torch checkpoint: it has no {STATE_FILE}. The port "
            f"reads chkpnt<N>/{STATE_FILE} and decoders.pt, which its own train_gad writes")
    return max(steps)


def export_ply(model_dir: str, scene: GaussianScene, state: TrainState, step: int) -> str:
    """Renderable snapshot with the trained features as semantic_* fields."""
    out = os.path.join(model_dir, "point_cloud", f"iteration_{step}", "point_cloud.ply")
    scene.with_features(state.features.detach()).save_ply(out)
    return out
