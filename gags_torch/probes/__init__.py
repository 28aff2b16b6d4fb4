"""Hopper ports of the repo's two TPU micro-probes (scripts/vpu_probe.py and
scripts/slab_probe.py): each elementwise chain as a hand-written CUDA
kernel (``csrc/*.cu``) beside its plain PyTorch version.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. `launch_counts` counts kernel launches
only.
"""

from __future__ import annotations

from pathlib import Path

from gags_torch import _kernels

CSRC = Path(__file__).resolve().parent / "csrc"
VPU_CHAIN_SRC = CSRC / "vpu_chain.cu"
SLAB_CHAIN_SRC = CSRC / "slab_chain.cu"
SOURCES = (VPU_CHAIN_SRC, SLAB_CHAIN_SRC)

launch_counts = {"vpu_chain": 0, "slab_chain": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def build_all() -> dict[str, str]:
    """Compile both probe kernels not built yet (all nvcc processes at
    once); returns each source's compiler log."""
    return _kernels.build(list(SOURCES))
