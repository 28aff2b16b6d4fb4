"""LPIPS perceptual metric (port of gags_tpu.utils.lpips): VGG16, AlexNet and
SqueezeNet 1.1 feature towers.

Counterpart of the reference's vendored `lpipsPyTorch/` (backbones and
linear probes, `modules/networks.py:12-96`): each tower is torchvision's
`features` stack, layer for layer and index for index, so a torchvision
`features` state dict loads as it is; the taps are the reference's
target layers. Kept as the reference has them: the z-score quirk (the
[0, 1] images are z-scored with constants built for [-1, 1] inputs,
`modules/networks.py:40-42` + `metrics.py:74`), the additive-eps
activation normalisation (`modules/utils.py:6-8`), raw (not abs) linear
head weights and SqueezeNet's ceil_mode pooling.

On a CUDA device a float32 convolution runs through cuDNN in TF32 unless
`torch.backends.cudnn.allow_tf32` is False (~1e-3 off float32 here): the
forward turns it off for its own convolutions and restores it after.

No pretrained weights ship with the repository: build the metric with
`lpips_from_checkpoints(feat_path, lin_path, net_type=...)` from the
user's files; the `metrics` CLI reports PSNR and SSIM without them.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import torch
from torch import nn

# torchvision VGG16 feature plan; LPIPS taps after the ReLU before each of
# the 5 pooling stages (reference target_layers [4, 9, 16, 23, 30], 1-based)
_VGG_PLAN = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"]
LPIPS_CHANNELS = {
    "vgg": [64, 128, 256, 512, 512],
    "alex": [64, 192, 384, 256, 256],
    "squeeze": [64, 128, 256, 384, 384, 512, 512],
}
# 0-based indices into `features` after which a tap is taken
_TAPS = {"vgg": [3, 8, 15, 22, 29], "alex": [1, 4, 7, 9, 11],
         "squeeze": [1, 4, 7, 9, 10, 11, 12]}

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _vgg_features() -> nn.Sequential:
    layers, in_c = [], 3
    for v in _VGG_PLAN:
        if v == "M":
            layers.append(nn.MaxPool2d(2, 2))
        else:
            layers += [nn.Conv2d(in_c, v, 3, padding=1), nn.ReLU()]
            in_c = v
    return nn.Sequential(*layers)


def _alex_features() -> nn.Sequential:
    return nn.Sequential(
        nn.Conv2d(3, 64, 11, stride=4, padding=2), nn.ReLU(), nn.MaxPool2d(3, 2),
        nn.Conv2d(64, 192, 5, padding=2), nn.ReLU(), nn.MaxPool2d(3, 2),
        nn.Conv2d(192, 384, 3, padding=1), nn.ReLU(),
        nn.Conv2d(384, 256, 3, padding=1), nn.ReLU(),
        nn.Conv2d(256, 256, 3, padding=1), nn.ReLU(), nn.MaxPool2d(3, 2),
    )


class Fire(nn.Module):
    """SqueezeNet Fire: 1x1 squeeze → ReLU → (1x1 ‖ 3x3) expand → ReLU,
    torchvision's submodule names."""

    def __init__(self, in_c: int, squeeze: int, expand: int):
        super().__init__()
        self.squeeze = nn.Conv2d(in_c, squeeze, 1)
        self.squeeze_activation = nn.ReLU()
        self.expand1x1 = nn.Conv2d(squeeze, expand, 1)
        self.expand1x1_activation = nn.ReLU()
        self.expand3x3 = nn.Conv2d(squeeze, expand, 3, padding=1)
        self.expand3x3_activation = nn.ReLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.squeeze_activation(self.squeeze(x))
        return torch.cat([self.expand1x1_activation(self.expand1x1(s)),
                          self.expand3x3_activation(self.expand3x3(s))], 1)


def _squeeze_features() -> nn.Sequential:
    return nn.Sequential(
        nn.Conv2d(3, 64, 3, stride=2), nn.ReLU(), nn.MaxPool2d(3, 2, ceil_mode=True),
        Fire(64, 16, 64), Fire(128, 16, 64), nn.MaxPool2d(3, 2, ceil_mode=True),
        Fire(128, 32, 128), Fire(256, 32, 128), nn.MaxPool2d(3, 2, ceil_mode=True),
        Fire(256, 48, 192), Fire(384, 48, 192), Fire(384, 64, 256), Fire(512, 64, 256),
    )


_TOWERS = {"vgg": _vgg_features, "alex": _alex_features, "squeeze": _squeeze_features}


class LPIPS(nn.Module):
    """lpips(a, b): two (H, W, 3) images in [0, 1] → a scalar distance."""

    def __init__(self, net_type: str = "vgg"):
        super().__init__()
        if net_type not in _TOWERS:
            raise ValueError(f"unknown net_type {net_type!r}")
        self.net_type = net_type
        self.features = _TOWERS[net_type]()
        self.taps = _TAPS[net_type]
        for i, c in enumerate(LPIPS_CHANNELS[net_type]):
            self.register_parameter(f"lin{i}", nn.Parameter(torch.ones(c)))
        self.register_buffer("shift", torch.tensor(_SHIFT).reshape(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).reshape(1, 3, 1, 1), persistent=False)

    def _tower(self, img: torch.Tensor) -> List[torch.Tensor]:
        h = (img.permute(2, 0, 1)[None] - self.shift) / self.scale
        out = []
        for i, layer in enumerate(self.features):
            h = layer(h)
            if i in self.taps:
                out.append(h)
                if len(out) == len(self.taps):
                    break
        return out

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        with _no_tf32():
            fa, fb = self._tower(a), self._tower(b)
        total = a.new_zeros(())
        for i, (xa, xb) in enumerate(zip(fa, fb)):
            # normalize_activation (modules/utils.py): additive eps
            xa = xa / (torch.sqrt(torch.sum(xa ** 2, dim=1, keepdim=True)) + 1e-10)
            xb = xb / (torch.sqrt(torch.sum(xb ** 2, dim=1, keepdim=True)) + 1e-10)
            w = getattr(self, f"lin{i}")
            total = total + torch.mean(torch.sum((xa - xb) ** 2 * w[None, :, None, None], dim=1))
        return total


def convert_lpips_weights(feat_state: Dict, lin_state: Dict, net_type: str = "vgg") -> Dict:
    """torchvision `features` state dict (features.{idx}.weight / bias, with
    .squeeze / .expand1x1 / .expand3x3 inside SqueezeNet's Fire modules)
    plus the LPIPS linear heads (lin{i}.model.1.weight, (1, C, 1, 1)) →
    an `LPIPS(net_type)` state dict."""
    if net_type not in _TOWERS:
        raise ValueError(f"unknown net_type {net_type!r}")
    state = {k: torch.as_tensor(v).to(torch.float32) for k, v in feat_state.items()
             if k.startswith("features.")}
    for i in range(len(LPIPS_CHANNELS[net_type])):
        w = torch.as_tensor(lin_state[f"lin{i}.model.1.weight"]).to(torch.float32)
        state[f"lin{i}"] = w.reshape(-1)
    return state


def lpips_from_checkpoints(feat_path: str, lin_path: str, net_type: str = "vgg",
                           device="cpu") -> LPIPS:
    """An eval-mode LPIPS on `device` from the user's torchvision features
    file and LPIPS linear-head file (both tensors-only state dicts)."""
    feat_state = torch.load(feat_path, map_location="cpu", weights_only=True)
    lin_state = torch.load(lin_path, map_location="cpu", weights_only=True)
    model = LPIPS(net_type)
    model.load_state_dict(convert_lpips_weights(feat_state, lin_state, net_type))
    return model.to(device).eval()
