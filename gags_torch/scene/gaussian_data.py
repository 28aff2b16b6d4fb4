"""GaussianScene: the Gaussian field as torch tensors (port of
gags_tpu.scene.gaussian_data).

Raw (pre-activation) parameters are stored; activations (sigmoid opacity,
exp scale) are applied at use sites. The serving path reads the distilled
per-Gaussian features from `semantic_features`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gags_torch.scene import ply as ply_io


@dataclasses.dataclass(frozen=True)
class GaussianScene:
    means: torch.Tensor  # (N, 3)
    sh: torch.Tensor  # (N, K, 3) SH coefficients, dc first
    opacities_raw: torch.Tensor  # (N,) pre-sigmoid
    scales_raw: torch.Tensor  # (N, 3) pre-exp
    quats: torch.Tensor  # (N, 4) unnormalised wxyz
    semantic_features: Optional[torch.Tensor] = None  # (N, F)
    max_sh_degree: int = 3

    @property
    def num_gaussians(self) -> int:
        return self.means.shape[0]

    @property
    def opacities(self) -> torch.Tensor:
        return torch.sigmoid(self.opacities_raw)

    @property
    def scales(self) -> torch.Tensor:
        return torch.exp(self.scales_raw)

    def to(self, device) -> "GaussianScene":
        moved = {
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        }
        return dataclasses.replace(self, **moved)

    @staticmethod
    def from_ply(path: str, max_sh_degree: int = 3, device="cpu") -> "GaussianScene":
        raw = ply_io.read_gaussian_ply(path, max_sh_degree)
        return scene_from_arrays(**raw, max_sh_degree=max_sh_degree, device=device)

    def save_ply(self, path: str) -> None:
        def host(t):
            return None if t is None else t.detach().cpu().numpy()

        ply_io.write_gaussian_ply(
            path, host(self.means), host(self.sh), host(self.opacities_raw),
            host(self.scales_raw), host(self.quats), host(self.semantic_features),
        )


def scene_from_arrays(means, quats, scales_raw, opacities_raw, sh,
                      semantic_features=None, max_sh_degree: int = 3,
                      device="cpu") -> GaussianScene:
    """GaussianScene from raw (pre-activation) arrays, e.g. numpy arrays
    carried over from the JAX package or read by `ply.read_gaussian_ply`."""

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return GaussianScene(
        means=t(means),
        sh=t(sh),
        opacities_raw=t(opacities_raw),
        scales_raw=t(scales_raw),
        quats=t(quats),
        semantic_features=None if semantic_features is None else t(semantic_features),
        max_sh_degree=max_sh_degree,
    )
