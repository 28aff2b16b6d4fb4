"""Interop with the reference's torch checkpoints (port of gags_tpu.gad.interop).

Loads the reference's `chkpnt<N>.pth`, the 12- or 13-tuple of
`gaussian_model.capture()` (train.py:232) saved as `(model_args,
iteration)`, into a GaussianScene (and its semantic features where the
tuple has them), so a scene pretrained with the original PyTorch / gsplat
stack drops straight into the GAD trainer. A 12-tuple (RGB only) starts
feature training at iteration 0, as train.py:83-84 does. The reference's
decoder checkpoints (`decoder_chkpnt<N>.pth`, `scale_decoder_chkpnt<N>.pth`)
hold 1x1 Conv2d stacks; they map onto the port's nn.Linear decoders.

Every file is read with `torch.load(weights_only=True)`. The tuple holds
tensors (nn.Parameter included), Python numbers, the optimizer's
`state_dict()` and one numpy scalar: `spatial_lr_scale` is getNerfppNorm's
`np.max(dist) * 1.1`, a numpy.float64. The restricted unpickler takes all
but that one by default, so the load allowlists numpy's scalar
reconstructor (under numpy 1's module name and numpy 2's) and dtypes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gags_torch import resolve_device
from gags_torch.scene.gaussian_data import GaussianScene


def _f32(t, device) -> torch.Tensor:
    return torch.as_tensor(t).detach().to(device=device, dtype=torch.float32)


def _numpy_scalar_globals() -> list:
    """What a pickled numpy scalar needs beyond the default allowlist."""
    scalar = np._core.multiarray.scalar if hasattr(np, "_core") else np.core.multiarray.scalar
    return [np.dtype, (scalar, "numpy.core.multiarray.scalar"),
            (scalar, "numpy._core.multiarray.scalar"),
            *(type(np.dtype(t)) for t in ("f8", "f4", "i8", "i4", "?"))]


def load_reference_checkpoint(path: str, device="cuda"
                              ) -> Tuple[GaussianScene, int, Optional[torch.Tensor]]:
    """(scene on `device`, start iteration, semantic features or None)."""
    device = resolve_device(device)
    with torch.serialization.safe_globals(_numpy_scalar_globals()):
        model_args, iteration = torch.load(path, map_location="cpu", weights_only=True)
    if len(model_args) == 13:
        (_active_sh, xyz, f_dc, f_rest, scaling, rotation, opacity,
         _max_radii, _grad_accum, _denom, _opt, _lr_scale, semantic) = model_args
        feats = _f32(semantic, device)
    elif len(model_args) == 12:
        (_active_sh, xyz, f_dc, f_rest, scaling, rotation, opacity,
         _max_radii, _grad_accum, _denom, _opt, _lr_scale) = model_args
        feats = None
        iteration = 0  # an RGB-only checkpoint: feature training from scratch
    else:
        raise ValueError(f"{path}: unexpected checkpoint tuple length {len(model_args)}")
    sh = torch.cat([_f32(f_dc, device), _f32(f_rest, device)], dim=1)  # (N, K, 3)
    scene = GaussianScene(
        means=_f32(xyz, device),
        sh=sh,
        opacities_raw=_f32(opacity, device).reshape(-1),
        scales_raw=_f32(scaling, device),
        quats=_f32(rotation, device),
        semantic_features=feats,
        max_sh_degree=int(round(sh.shape[1] ** 0.5)) - 1,
    )
    return scene, int(iteration), feats


def _conv_state(path: str, layers: int) -> dict:
    """1x1-conv `decoder.{2i}` weights (out, in, 1, 1) and biases of a
    reference decoder file → the port's `d{i}.weight` (out, in) / `d{i}.bias`."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    sd = payload.get("module_state_dict", payload)
    state = {}
    for i in range(layers):
        w = sd[f"decoder.{2 * i}.weight"]
        state[f"d{i}.weight"] = w.detach().to(torch.float32)[:, :, 0, 0].contiguous()
        state[f"d{i}.bias"] = sd[f"decoder.{2 * i}.bias"].detach().to(torch.float32).clone()
    return state


def load_reference_decoder(path: str) -> dict:
    """`decoder_chkpnt<N>.pth` ({"module_state_dict", "optimizer_state_dict"},
    train.py:235-238; convs at decoder.{0,2,...,16}, networks.py:126-194) →
    a FeatureDecoder state dict (d0..d8). The optimizer's moments are not
    carried over: Adam restarts, as in the JAX package."""
    return _conv_state(path, 9)


def load_reference_scale_decoder(path: str) -> dict:
    """`scale_decoder_chkpnt<N>.pth` (convs at decoder.{0,2,...,10},
    networks.py:225-241) → a ScaleDecoder state dict (d0..d5)."""
    return _conv_state(path, 6)
