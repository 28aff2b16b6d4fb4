"""Wrappers of the RGB step's kernels, each beside its plain version:

  J4 photometric_loss   (1 - lam) L1 + lam (1 - SSIM) of a rendered image
                        against its target, and its gradient
  J5 adam_update        Adam on every parameter group, the parking of dead
                        slots' means and the densification statistics,
                        one launch

(J3, the SH colours, lives beside its eager chain in `core/sh.py`.)

Neither has a TPU counterpart: the JAX package leaves both chains to XLA,
which fuses them; PyTorch runs them eagerly, ~80 and ~100 launches a step.
On CPU tensors `photometric_loss` runs the eager chain (autograd is its
backward) and `rgb.train` the eager update; given CUDA tensors the
wrappers launch the kernels (``csrc/*.cu``, built with nvcc at first use
and bound through ctypes) or raise. `launch_counts` counts kernel launches
only.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from gags_torch import _kernels
from gags_torch.splat.kernels import _dispatch, _ptr, _stream
from gags_torch.utils.metrics import _filter2d_same, _gaussian_window, ssim

CSRC = Path(__file__).resolve().parent / "csrc"
LOSS_SRC = CSRC / "photometric_loss.cu"
ADAM_SRC = CSRC / "adam.cu"
SOURCES = (LOSS_SRC, ADAM_SRC)
SSIM_C1, SSIM_C2 = 0.01 ** 2, 0.03 ** 2
_FLOATS = ctypes.POINTER(ctypes.c_float)
ADAM_GROUPS = 6  # csrc/adam.cu kMaxGroups: the RGB step's six groups
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-15  # rgb.train._adam_update's

launch_counts = {"loss_forward": 0, "loss_backward": 0, "adam_update": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _cuda_f32(name: str, t: torch.Tensor, shape=None) -> torch.Tensor:
    if t.device.type != "cuda" or t.dtype != torch.float32:
        raise ValueError(f"{name}: a CUDA float32 tensor, got {t.dtype} on {t.device}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    return t.contiguous()


# --------------------------------------------------------------------------
# J4: photometric_loss
# --------------------------------------------------------------------------


def photometric_loss_plain(img: torch.Tensor, gt: torch.Tensor, lam: float) -> torch.Tensor:
    """(1 - lam) mean |img - gt| + lam (1 - SSIM(img, gt)) as the eager
    chain (J4's plain version), differentiable by autograd."""
    l1 = torch.mean(torch.abs(img - gt))
    return (1 - lam) * l1 + lam * (1.0 - ssim(img, gt))


def photometric_loss_backward_plain(img: torch.Tensor, gt: torch.Tensor, lam: float,
                                    g_loss) -> torch.Tensor:
    """J4's backward as closed forms in torch, in the inputs' dtype: the
    gradient of the loss with respect to img (H, W, 3) given the loss's
    gradient `g_loss`. The SSIM term's derivatives with respect to its
    filtered maps (P1: mu1, P11: img^2, P12: img gt), filtered again by the
    same zero-bordered window (its own adjoint), plus the L1 term's sign."""
    win = _gaussian_window(11, device=img.device).to(img.dtype)
    c = img.shape[-1]
    n = img.numel()
    stack = torch.cat([img, gt, img * img, gt * gt, img * gt], dim=-1)
    mu1, mu2, f11, f22, f12 = torch.split(_filter2d_same(stack, win), c, dim=-1)
    a = 2 * mu1 * mu2 + SSIM_C1
    b = 2 * (f12 - mu1 * mu2) + SSIM_C2
    cc = mu1 * mu1 + mu2 * mu2 + SSIM_C1
    d = (f11 - mu1 * mu1) + (f22 - mu2 * mu2) + SSIM_C2
    m = a * b / (cc * d)
    g_m = -lam * g_loss / n
    p1 = g_m * 2 * (mu2 * (b - a) - m * mu1 * (d - cc)) / (cc * d)
    p11 = -g_m * m / d
    p12 = g_m * 2 * a / (cc * d)
    f1, g11, g12 = torch.split(_filter2d_same(torch.cat([p1, p11, p12], dim=-1), win), c, dim=-1)
    return f1 + 2 * img * g11 + gt * g12 + (1 - lam) * g_loss / n * torch.sign(img - gt)


@functools.lru_cache(maxsize=None)
def _taps() -> ctypes.Array:
    """The window's float32 taps as `utils.metrics.ssim` computes them (on
    the CPU), for the kernel's by-value argument."""
    return (ctypes.c_float * 11)(*_gaussian_window(11).tolist())


@functools.lru_cache(maxsize=None)
def _ticket(device: torch.device, stream: int) -> torch.Tensor:
    """J4 forward's block counter for one stream of `device`: zeroed once,
    and left zeroed by every launch (its last block resets it). Launches on
    one stream run in turn, so each stream has a counter of its own."""
    return torch.zeros((1,), dtype=torch.int32, device=device)


def _loss_inputs(img, gt):
    img = _cuda_f32("img", img)
    gt = _cuda_f32("gt", gt, img.shape)
    if img.dim() != 3 or img.shape[-1] != 3 or img.device != gt.device:
        raise ValueError(f"J4: img and gt (H, W, 3) on one device, got {tuple(img.shape)}")
    return img, gt


def loss_forward(img: torch.Tensor, gt: torch.Tensor, lam: float) -> torch.Tensor:
    """J4 forward: the loss, a 0-dim float32 tensor on the device."""
    img, gt = _loss_inputs(img, gt)
    h, w, _ = img.shape
    lib = _kernels.load(LOSS_SRC)
    fn = lib.gags_loss_blocks
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    partials = torch.empty((2 * fn(h, w),), dtype=torch.float64, device=img.device)
    loss = torch.empty((), dtype=torch.float32, device=img.device)
    fn = lib.gags_loss_forward
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [_FLOATS, ctypes.c_double]
                   + [ctypes.c_void_p] * 4)
    fn.restype = ctypes.c_int
    stream = _stream(img)
    err = fn(_ptr(img), _ptr(gt), h, w, _taps(), lam, _ptr(partials),
             _ptr(_ticket(img.device, stream.value)), _ptr(loss), stream)
    _kernels.check(lib, err, "loss_forward")
    launch_counts["loss_forward"] += 1
    return loss


def loss_backward(img: torch.Tensor, gt: torch.Tensor, lam: float,
                  g_loss: torch.Tensor) -> torch.Tensor:
    """J4 backward: dLoss/dimg (H, W, 3) from the loss's gradient, a
    one-element float32 tensor on the device (read there: no host sync)."""
    img, gt = _loss_inputs(img, gt)
    g_loss = _cuda_f32("g_loss", g_loss.reshape(1))
    h, w, _ = img.shape
    g_img = torch.empty_like(img)
    lib = _kernels.load(LOSS_SRC)
    fn = lib.gags_loss_backward
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [_FLOATS, ctypes.c_double]
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    err = fn(_ptr(img), _ptr(gt), h, w, _taps(), lam, _ptr(g_loss), _ptr(g_img), _stream(img))
    _kernels.check(lib, err, "loss_backward")
    launch_counts["loss_backward"] += 1
    return g_img


class _PhotometricLoss(torch.autograd.Function):
    """J4's two launches as one function differentiable in img."""

    @staticmethod
    def forward(ctx, img, gt, lam):
        ctx.lam = lam
        ctx.save_for_backward(img, gt)
        return loss_forward(img, gt, lam)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_loss):
        img, gt = ctx.saved_tensors
        return loss_backward(img, gt, ctx.lam, g_loss), None, None


def photometric_loss(img: torch.Tensor, gt: torch.Tensor, lam: float) -> torch.Tensor:
    """The RGB step's loss (1 - lam) L1 + lam (1 - SSIM) of img against gt,
    both (H, W, 3); differentiable in img. CUDA tensors: J4, one launch
    each way (gt takes no gradient there); CPU tensors: the eager chain."""
    if not _dispatch(img):
        return photometric_loss_plain(img, gt, lam)
    if torch.is_grad_enabled() and gt.requires_grad:
        raise ValueError("photometric_loss: no gradient for the target on CUDA")
    return _PhotometricLoss.apply(img, gt, lam)


# --------------------------------------------------------------------------
# J5: adam_update
# --------------------------------------------------------------------------


def adam_scalars(step: int):
    """The float32 scalars of `rgb.train._adam_update` at `step` as the card
    rounds them: b1, 1 - b1, b2, 1 - b2, the bias corrections' float32
    reciprocals (a CUDA tensor divided by a host scalar is its product
    with the reciprocal) and eps."""
    f, b1, b2 = np.float32, ADAM_B1, ADAM_B2
    t = f(step + 1.0)
    c1 = f(1) - f(b1) ** t
    c2 = f(1) - f(b2) ** t
    return dict(b1=f(b1), omb1=f(1 - b1), b2=f(b2), omb2=f(1 - b2), rc1=f(1) / f(c1),
                rc2=f(1) / f(c2), c1=f(c1), c2=f(c2), eps=f(ADAM_EPS))


def _sqrt(x: torch.Tensor, on_card: bool) -> torch.Tensor:
    # the card's float32 square root is correctly rounded; PyTorch's
    # vectorised CPU one is not always
    return torch.sqrt(x.double()).float() if on_card else torch.sqrt(x)


def adam_plain(p, g, mu, nu, lr: float, step: int, *, on_card: bool = True):
    """J5's Adam arithmetic on one group of float32 CPU tensors, operation
    by operation as `csrc/adam.cu` writes it (its plain version). Returns
    the new (p, mu, nu). `on_card`: the bias corrections divide as on the
    card (a product with the float32 reciprocal) and the square root is
    correctly rounded; without it, as PyTorch computes them on the CPU."""
    s = {k: float(v) for k, v in adam_scalars(step).items()}
    mu = s["b1"] * mu + s["omb1"] * g
    nu = s["b2"] * nu + (s["omb2"] * g) * g
    if on_card:
        mh, vh = mu * s["rc1"], nu * s["rc2"]
    else:
        mh, vh = mu / s["c1"], nu / s["c2"]
    return p - (lr * mh) / (_sqrt(vh, on_card) + s["eps"]), mu, nu


def stats_plain(g2d, radii, width: int, height: int, grad_accum, denom, max_radii):
    """J5's densification statistics on CPU tensors, as `csrc/adam.cu`
    writes them (the norm's square root correctly rounded, as on the
    card): returns the new (grad_accum, denom, max_radii)."""
    gx, gy = g2d[:, 0] * (width * 0.5), g2d[:, 1] * (height * 0.5)
    norm = _sqrt(gx * gx + gy * gy, on_card=True)
    vis = radii > 0
    return (grad_accum + torch.where(vis, norm, torch.zeros_like(norm)),
            denom + vis.to(torch.float32), torch.maximum(max_radii, radii.to(torch.float32)))


def adam_update(params, grads, moments, lrs, step: int, alive: torch.Tensor, dead_z: float,
                stats) -> None:
    """J5: Adam on every group in one launch, in place, bit for bit
    `rgb.train._adam_update` on the card: params, grads (lists of CUDA
    float32 tensors, a group each), moments (a {"mu", "nu"} dict a group),
    lrs (a float a group), the global step. The first group's rows of 3
    (the means) of slots not `alive` (a bool a slot) become (0, 0, dead_z)
    after the update. `stats` = (g2d (slots, 2), radii (slots,) int32,
    width, height, grad_accum, denom, max_radii): the densification
    statistics, updated in place as `rgb.train` does."""
    groups = len(params)
    if not 1 <= groups <= ADAM_GROUPS or not len(grads) == len(moments) == len(lrs) == groups:
        raise ValueError(f"J5: 1 to {ADAM_GROUPS} groups, each with a gradient, moments and "
                         f"a rate")
    dev = params[0].device
    ptrs = {k: (ctypes.c_void_p * groups)() for k in ("p", "g", "mu", "nu")}
    sizes = (ctypes.c_int64 * groups)()
    rates = (ctypes.c_float * groups)()
    keep = []
    for i, (p, g, m) in enumerate(zip(params, grads, moments)):
        for name, t in (("p", p), ("mu", m["mu"]), ("nu", m["nu"])):
            if not t.is_contiguous() or t.device != dev:
                raise ValueError(f"J5: group {i}'s {name} must be contiguous on {dev}")
            _cuda_f32(f"group {i} {name}", t, p.shape)
        if g is None:
            raise ValueError(f"J5: group {i} has no gradient")
        g = _cuda_f32(f"group {i} gradient", g, p.shape)
        keep.append(g)
        for name, t in (("p", p), ("g", g), ("mu", m["mu"]), ("nu", m["nu"])):
            ptrs[name][i] = t.data_ptr()
        sizes[i] = p.numel()
        rates[i] = lrs[i]
    if alive.dtype != torch.bool or alive.device != dev or \
            params[0].shape != (alive.shape[0], 3) or not alive.is_contiguous():
        raise ValueError("J5: alive, a contiguous bool a row of the first group (N, 3)")
    g2d, radii, width, height, *outs = stats
    slots = radii.shape[0]
    g2d = _cuda_f32("g2d", g2d, (slots, 2))
    if radii.dtype != torch.int32 or radii.device != dev or not radii.is_contiguous():
        raise ValueError("J5: radii, a contiguous int32 CUDA tensor")
    for t in outs:
        if not t.is_contiguous():
            raise ValueError("J5: the statistics must be contiguous")
        _cuda_f32("statistics", t, (slots,))
    s = adam_scalars(step)
    lib = _kernels.load(ADAM_SRC)
    fn = lib.gags_adam_update
    fn.argtypes = ([ctypes.c_int] + [ctypes.POINTER(ctypes.c_void_p)] * 4
                   + [ctypes.POINTER(ctypes.c_int64), _FLOATS] + [ctypes.c_float] * 7
                   + [ctypes.c_void_p, ctypes.c_float] + [ctypes.c_void_p] * 2
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 3 + [ctypes.c_int64]
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(groups, ptrs["p"], ptrs["g"], ptrs["mu"], ptrs["nu"], sizes, rates,
             *(float(s[k]) for k in ("b1", "omb1", "b2", "omb2", "rc1", "rc2", "eps")),
             _ptr(alive), dead_z, _ptr(g2d), _ptr(radii), width * 0.5, height * 0.5,
             *map(_ptr, outs), slots, _stream(params[0]))
    _kernels.check(lib, err, "adam_update")
    launch_counts["adam_update"] += 1
