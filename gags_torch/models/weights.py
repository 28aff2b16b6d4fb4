"""Carry parameters into the port: flax decoder parameters (as numpy
arrays) → torch state dicts, raw Gaussian arrays → GaussianScene
(`scene_from_arrays`, defined beside GaussianScene), and the
`decoders.pt` file that `cli.serve.load_server` reads."""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from gags_torch.scene.gaussian_data import scene_from_arrays

__all__ = ["decoder_state_from_flax", "scene_from_arrays", "save_decoders",
           "load_decoder_state"]


def decoder_state_from_flax(params: Mapping[str, Mapping[str, np.ndarray]]) -> dict:
    """Flax Dense parameters {"d0": {"kernel": (in, out), "bias": (out,)},
    ...} (optionally wrapped in {"params": ...}) → an nn.Linear state dict
    {"d0.weight": (out, in), "d0.bias": (out,), ...}."""
    if set(params) == {"params"}:
        params = params["params"]
    state = {}
    for name, p in params.items():
        kernel = np.asarray(p["kernel"], np.float32)
        state[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(kernel.T))
        state[f"{name}.bias"] = torch.from_numpy(np.asarray(p["bias"], np.float32).copy())
    return state


def save_decoders(path: str, feature_decoder: torch.nn.Module,
                  scale_decoder: Optional[torch.nn.Module] = None) -> None:
    """Write `decoders.pt`: {"feature_decoder": state dict[, "scale_decoder": ...]}."""
    blob = {"feature_decoder": {k: v.cpu() for k, v in feature_decoder.state_dict().items()}}
    if scale_decoder is not None:
        blob["scale_decoder"] = {k: v.cpu() for k, v in scale_decoder.state_dict().items()}
    torch.save(blob, path)


def load_decoder_state(path: str) -> dict:
    """Read `decoders.pt` (tensors only) and return its dict of state dicts."""
    return torch.load(path, map_location="cpu", weights_only=True)
