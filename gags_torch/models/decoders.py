"""Feature / granularity decoders (port of gags_tpu.models.decoders).

Every layer of the reference's decoders is a 1x1 convolution, i.e. a
per-pixel MLP, so both are `nn.Linear` stacks over the last dimension.

  FeatureDecoder: 16→256, 7 x 256→256 with two additive skips, 256→512,
    L2-normalised over channels with a rsqrt(max(sq, 1e-24)) guard
    (`l2_normalise`; `unnormalised` gives the rows before it).
  ScaleDecoder: 16→64→128→64→32→16→3, ReLU between, softmax over the
    three granularities.

Layers are named d0..d8 / d0..d5 like the flax modules, so
`weights.decoder_state_from_flax` maps parameters one to one.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def _linear(fan_in: int, fan_out: int, generator: Optional[torch.Generator], device) -> nn.Linear:
    """nn.Linear with U(±1/sqrt(fan_in)) weights AND biases (torch's conv /
    linear default). Zero biases would make the decoder output exactly zero
    at step 0 (features start at zero) and block every ReLU gradient."""
    lin = nn.Linear(fan_in, fan_out, device=device)
    bound = (1.0 / fan_in) ** 0.5
    with torch.no_grad():
        lin.weight.uniform_(-bound, bound, generator=generator)
        lin.bias.uniform_(-bound, bound, generator=generator)
    return lin


def l2_normalise(x: torch.Tensor) -> torch.Tensor:
    """x over its L2 norm on the last dim, with the rsqrt(max(sq, 1e-24))
    guard: FeatureDecoder's last step."""
    sq = torch.sum(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(torch.clamp_min(sq, 1e-24))


class FeatureDecoder(nn.Module):
    """(..., in_dim) distilled features → (..., output_dim) unit-norm CLIP space."""

    def __init__(self, in_dim: int = 16, hidden: int = 256, output_dim: int = 512,
                 generator: Optional[torch.Generator] = None, device="cpu"):
        super().__init__()
        dims = [(in_dim, hidden)] + [(hidden, hidden)] * 7 + [(hidden, output_dim)]
        for i, (a, b) in enumerate(dims):
            self.add_module(f"d{i}", _linear(a, b, generator, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return l2_normalise(self.unnormalised(x))

    def unnormalised(self, x: torch.Tensor) -> torch.Tensor:
        """The last layer's output before the normalisation, as float32."""
        relu = F.relu
        x1 = relu(self.d0(x))
        x2 = relu(self.d1(x1))
        x2 = relu(self.d2(x2))
        x3 = relu(self.d3(x1 + x2))
        x4 = relu(self.d4(x3))
        x4 = relu(self.d5(x4))
        x5 = relu(self.d6(x3 + x4))
        x5 = relu(self.d7(x5))
        return self.d8(x5).float()


class ScaleDecoder(nn.Module):
    """(..., in_dim) features → (..., 3) granularity softmax."""

    def __init__(self, in_dim: int = 16, output_dim: int = 3,
                 generator: Optional[torch.Generator] = None, device="cpu"):
        super().__init__()
        widths = [in_dim, 64, 128, 64, 32, 16, output_dim]
        for i in range(len(widths) - 1):
            self.add_module(f"d{i}", _linear(widths[i], widths[i + 1], generator, device))
        self.n_layers = len(widths) - 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers - 1):
            x = F.relu(getattr(self, f"d{i}")(x))
        x = getattr(self, f"d{self.n_layers - 1}")(x)
        return torch.softmax(x.float(), dim=-1)


def feature_decoder_from_state(state: dict, device="cpu") -> FeatureDecoder:
    """A FeatureDecoder of the widths a d0..d8 state dict carries, loaded
    from it, on `device`, in eval mode."""
    dec = FeatureDecoder(in_dim=state["d0.weight"].shape[1], hidden=state["d0.weight"].shape[0],
                         output_dim=state["d8.weight"].shape[0], device=device)
    dec.load_state_dict(state)
    return dec.eval()
