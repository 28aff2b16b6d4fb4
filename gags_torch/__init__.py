"""gags_torch — PyTorch / CUDA port of gags_tpu for NVIDIA Hopper.

The package mirrors gags_tpu's sub-packages (core, scene, splat, models,
query, utils, cli). It imports torch, numpy and the standard library only,
never JAX and nothing of gags_tpu. Entry points default to
``device="cuda"`` and raise when no CUDA device is present; the CPU runs
only when a caller asks for it with ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    """Turn a device spec into a torch.device, refusing absent CUDA.

    There is no silent fallback: asking for "cuda" on a machine without a
    CUDA device raises, so a run never measures the CPU by mistake.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gags_torch: CUDA device requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"gags_torch: unsupported device {dev}")
    return dev


__all__ = ["resolve_device"]
