"""Image quality metrics, PSNR and SSIM (port of gags_tpu.utils.metrics).

Counterparts of the reference's `utils/image_utils.py:14-19` (psnr) and
`utils/loss_utils.py:158-198` (ssim: 11-tap Gaussian window, sigma 1.5,
C1 = 0.01^2, C2 = 0.03^2, zero "same" padding, separable per channel,
mean over all). Channel-last (H, W, C) in [0, 1].

The separable filter is two depthwise `conv2d` calls. On a CUDA device a
float32 convolution runs through cuDNN in TF32 unless
`torch.backends.cudnn.allow_tf32` is False; the RGB trainer sets it so
(`rgb.train.make_rgb_step`), and so must any caller that needs float32.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((img1 - img2) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp_min(mse, 1e-20)))


def _gaussian_window(size: int = 11, sigma: float = 1.5, device="cpu") -> torch.Tensor:
    """The window's taps, computed on the CPU whatever `device` is: a CUDA
    exp can differ from the CPU's in the last bit, and one ulp in a tap
    moves a 720p SSIM by ~3e-6 (the variances are small differences of
    large terms). Cached per device, so a training step copies nothing."""
    return _window_on(size, float(sigma), torch.device(device))


@functools.lru_cache(maxsize=None)
def _window_on(size: int, sigma: float, device: torch.device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32) - size // 2
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return (g / torch.sum(g)).to(device)


def _filter2d_same(img: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Separable depthwise filter with zero 'same' padding (conv2d with
    padding k//2). img (H, W, C), win (k,) symmetric."""
    k = win.shape[0]
    c = img.shape[-1]
    x = img.permute(2, 0, 1)[None]  # (1, C, H, W)
    x = F.conv2d(x, win.reshape(1, 1, k, 1).expand(c, 1, k, 1), padding=(k // 2, 0), groups=c)
    x = F.conv2d(x, win.reshape(1, 1, 1, k).expand(c, 1, 1, k), padding=(0, k // 2), groups=c)
    return x[0].permute(1, 2, 0)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    win = _gaussian_window(window_size, device=img1.device)
    c = img1.shape[-1]
    # the five filtered maps in one pass over a (H, W, 5C) stack
    stack = torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2], dim=-1)
    mu1, mu2, f11, f22, f12 = torch.split(_filter2d_same(stack, win), c, dim=-1)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = f11 - mu1_sq
    s2 = f22 - mu2_sq
    s12 = f12 - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu12 + c1) * (2 * s12 + c2)) / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return torch.mean(m)
