"""Load a segment-anything `sam_vit_*.pth` checkpoint into the port's SAM
(port of gags_tpu.models.sam_weights).

The port's modules carry the checkpoint's own names (models/sam.py), so
loading is `load_state_dict(strict=True)`: a missing, extra or misshapen
key raises. Half-precision files load into float32 modules. No weights
ship with the repository; pass a user-supplied file.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gags_torch import resolve_device
from gags_torch.models.sam import SAM, SAMConfig


def _as_state(sd) -> dict:
    """Unwrap {"model": ...} and turn numpy values into tensors."""
    if isinstance(sd, dict) and "model" in sd:
        sd = sd["model"]
    return {k: v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v)) for k, v in sd.items()}


def load_sam_state_dict(sd, cfg: SAMConfig, device="cuda") -> SAM:
    """A segment-anything state dict (torch tensors or numpy arrays, fp16
    or f32) → a float32 SAM on `device`, loaded strictly."""
    model = SAM(cfg, device="meta").to_empty(device=resolve_device(device))
    model.load_state_dict(_as_state(sd), strict=True)
    return model.eval()


def load_sam_checkpoint(path: str, cfg: Optional[SAMConfig] = None,
                        device="cuda") -> Tuple[SAM, SAMConfig]:
    """Read a `sam_vit_*.pth` file (memory-mapped) into a SAM of `cfg`
    (ViT-H by default) on `device`; returns (model, cfg)."""
    cfg = cfg or SAMConfig.vit_h()
    sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    return load_sam_state_dict(sd, cfg, device), cfg
