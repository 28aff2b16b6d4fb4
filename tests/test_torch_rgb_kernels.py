"""The plain versions of the RGB step's kernels J3 (SH colours), J4 (the
L1 + SSIM loss) and J5 (the six Adam groups, the parking and the
densification statistics) on the CPU: each closed form against autograd
in float64, and J5's arithmetic against the eager update it replaces.
The kernels themselves are held to these on the card by
tests/test_torch_rgb_kernels_cuda.py."""

import numpy as np
import pytest
import torch

from gags_torch.core import sh as sh_mod
from gags_torch.rgb import kernels as rk
from gags_torch.rgb import train as rt
from gags_torch.utils.metrics import _filter2d_same, _gaussian_window

F64 = torch.float64


def _sh_case(deg, n, k, seed):
    g = torch.Generator().manual_seed(seed)
    sh = torch.randn((n, k, 3), generator=g, dtype=F64) * 0.5
    means = torch.randn((n, 3), generator=g, dtype=F64) * 2.0
    campos = torch.randn((3,), generator=g, dtype=F64)
    g_colors = torch.randn((n, 3), generator=g, dtype=F64)
    return sh, means, campos, g_colors


def _autograd_sh(deg, sh, means, campos, g_colors):
    leaves = [t.clone().requires_grad_(True) for t in (sh, means)]
    colors = sh_mod.sh_colors_plain(deg, *leaves, campos)
    return torch.autograd.grad(colors, leaves, g_colors, allow_unused=True,
                               materialize_grads=True)


@pytest.mark.parametrize("deg,k", [(d, 16) for d in range(4)] + [(d, 25) for d in range(5)])
def test_sh_vjp_closed_form_matches_autograd(deg, k):
    """J3's closed-form VJP equals autograd through the eager chain in
    float64, within 1e-13 relative L2 (the two sum the same terms in
    another order: float64 rounding, ~1e-16 a term), with exact zeros for
    the coefficients above (deg + 1)^2 and clamped colours among the rows."""
    sh, means, campos, g_colors = _sh_case(deg, 400, k, seed=deg)
    want = _autograd_sh(deg, sh, means, campos, g_colors)
    got = sh_mod.sh_colors_backward_plain(deg, sh, means, campos, g_colors)
    pre = sh_mod._unclamped(deg, sh, means, campos)
    if deg > 0:
        assert (pre < 0).any() and (pre > 0).any()
    for a, b in zip(got, want):
        assert torch.linalg.vector_norm(a - b) <= 1e-13 * torch.linalg.vector_norm(b)
    assert torch.equal(got[0][:, (deg + 1) ** 2:], torch.zeros_like(got[0][:, (deg + 1) ** 2:]))


def test_sh_vjp_at_the_clamp_boundary():
    """A colour exactly 0 before the clamp passes its gradient (clamp_min's
    backward takes >= 0), one just below passes none: the closed form and
    autograd agree exactly on both rows, at degree 0 where the colour is
    C0 s + 0.5 alone."""
    c0 = torch.tensor(sh_mod.SH_C0, dtype=F64)
    s = -0.5 / c0
    while float(c0 * s + 0.5) != 0.0:  # the coefficient whose colour is exactly 0
        s = torch.nextafter(s, s + 1 if float(c0 * s + 0.5) < 0 else s - 1)
    below = torch.nextafter(s, s - 1)
    assert float(c0 * below + 0.5) < 0.0
    sh = torch.zeros((2, 16, 3), dtype=F64)
    sh[0, 0, :] = s
    sh[1, 0, :] = below
    means = torch.tensor([[1.0, 2.0, 3.0], [-1.0, 0.5, 2.0]], dtype=F64)
    campos = torch.zeros(3, dtype=F64)
    g_colors = torch.tensor([[1.0, -2.0, 3.0], [1.0, 1.0, 1.0]], dtype=F64)
    got = sh_mod.sh_colors_backward_plain(0, sh, means, campos, g_colors)
    want = _autograd_sh(0, sh, means, campos, g_colors)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(got[0][0, 0], g_colors[0] * sh_mod.SH_C0)
    assert not got[0][1].any()


def test_sh_vjp_at_the_camera_centre():
    """A Gaussian at the camera centre (zero direction): the norm's term
    drops as its backward drops it, and the closed form equals autograd."""
    sh, means, campos, g_colors = _sh_case(3, 8, 16, seed=11)
    means[3] = campos
    got = sh_mod.sh_colors_backward_plain(3, sh, means, campos, g_colors)
    want = _autograd_sh(3, sh, means, campos, g_colors)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert torch.allclose(a, b, rtol=1e-12, atol=0.0)


def test_sh_colors_cpu_is_the_eager_chain():
    """On CPU tensors sh_colors is the eager chain, with autograd."""
    sh, means, campos, _ = _sh_case(3, 50, 16, seed=2)
    sh32, m32, c32 = sh.float().requires_grad_(True), means.float(), campos.float()
    out = sh_mod.sh_colors(3, sh32, m32, c32)
    assert torch.equal(out, sh_mod.sh_colors_plain(3, sh32, m32, c32))
    assert out.grad_fn is not None


def _loss64(img, gt, lam):
    """utils.metrics.ssim's chain in float64 (its window in float64), with
    the L1 term: the float64 reference of J4."""
    win = _gaussian_window(11).to(F64)
    stack = torch.cat([img, gt, img * img, gt * gt, img * gt], dim=-1)
    mu1, mu2, f11, f22, f12 = torch.split(_filter2d_same(stack, win), 3, dim=-1)
    s1, s2, s12 = f11 - mu1 * mu1, f22 - mu2 * mu2, f12 - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / ((mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2))
    return (1 - lam) * torch.mean(torch.abs(img - gt)) + lam * (1.0 - torch.mean(m))


@pytest.mark.parametrize("h,w", [(1, 1), (4, 7), (11, 11), (13, 29), (31, 17)])
def test_loss_backward_closed_form_matches_autograd(h, w):
    """J4's closed-form image gradient (the SSIM term's derivatives by its
    filtered maps, filtered again, plus the L1 sign) equals autograd in
    float64 within 1e-13 relative L2 (float64 rounding in another order),
    on images smaller than the window and with borders on every side; a
    few pixels equal to the target give the L1 term's zero sign."""
    g = torch.Generator().manual_seed(h * 100 + w)
    img = torch.rand((h, w, 3), generator=g, dtype=F64)
    gt = torch.rand((h, w, 3), generator=g, dtype=F64)
    gt.view(-1)[::5] = img.view(-1)[::5]
    leaf = img.clone().requires_grad_(True)
    g_loss = 1.7
    want, = torch.autograd.grad(_loss64(leaf, gt, 0.2), leaf, torch.tensor(g_loss, dtype=F64))
    got = rk.photometric_loss_backward_plain(img, gt, 0.2, g_loss)
    assert torch.linalg.vector_norm(got - want) <= 1e-13 * torch.linalg.vector_norm(want)


def test_loss_cpu_is_the_eager_chain():
    """photometric_loss on CPU tensors is the eager float32 chain, with
    autograd; it equals the float64 reference within float32 rounding."""
    g = torch.Generator().manual_seed(5)
    img = torch.rand((20, 30, 3), generator=g).requires_grad_(True)
    gt = torch.rand((20, 30, 3), generator=g)
    loss = rk.photometric_loss(img, gt, 0.2)
    assert torch.equal(loss, rk.photometric_loss_plain(img, gt, 0.2))
    assert loss.grad_fn is not None
    assert abs(float(loss.detach()) - float(_loss64(img.detach().double(), gt.double(), 0.2))) < 1e-6


def _groups(seed, n=3000):
    rng = np.random.default_rng(seed)
    shapes = dict(means=(n, 3), sh_dc=(n, 1, 3), sh_rest=(n, 15, 3), opacities_raw=(n,),
                  scales_raw=(n, 3), quats=(n, 4))

    def arr(shape, scale=1.0):
        return torch.as_tensor((rng.standard_normal(shape) * scale).astype(np.float32))

    params = {k: arr(s) for k, s in shapes.items()}
    grads = {k: arr(s, 1e-3) for k, s in shapes.items()}
    grads["quats"][::7] = 0.0  # untouched rows
    opt = {k: dict(mu=arr(s, 1e-3), nu=torch.as_tensor(
        (rng.random(s) * 1e-6).astype(np.float32))) for k, s in shapes.items()}
    return params, grads, opt


@pytest.mark.parametrize("step", [0, 1, 7, 3000, 29_999])
def test_adam_plain_order_matches_adam_update(step):
    """J5's Adam arithmetic, written as the kernel writes it, equals
    rgb.train._adam_update on the CPU bit for bit in float32 when it divides
    and takes the square root as the CPU does: the same operations in the
    same order, each Python scalar rounded the same way. (On the card the
    kernel multiplies by the corrections' float32 reciprocals and rounds
    the square root correctly, as PyTorch does there; the card test holds
    it to _adam_update bit for bit.)"""
    params, grads, opt = _groups(step)
    lrs = dict(means=1.6e-4 * 3.3, sh_dc=2.5e-3, sh_rest=2.5e-3 / 20.0, opacities_raw=0.05,
               scales_raw=5e-3, quats=1e-3)
    for k in rt.GROUPS:
        p, mu, nu = rk.adam_plain(params[k], grads[k], opt[k]["mu"], opt[k]["nu"], lrs[k], step,
                                  on_card=False)
        m = {kk: v.clone() for kk, v in opt[k].items()}
        want = params[k].clone()
        rt._adam_update(want, grads[k], m, lrs[k], step)
        assert torch.equal(p, want) and torch.equal(mu, m["mu"]) and torch.equal(nu, m["nu"]), k


def test_adam_scalars_are_the_cards_rounding():
    """The kernel's scalars: each Python constant's float32 rounding, and
    the bias corrections' reciprocals computed in float32, as PyTorch
    divides a CUDA tensor by a host scalar."""
    s = rk.adam_scalars(4)
    f = np.float32
    assert s["omb1"] == f(1 - 0.9) and s["omb2"] == f(1 - 0.999)
    c1 = f(1) - f(0.9) ** f(5.0)
    assert s["c1"] == c1 and s["rc1"] == f(1) / c1
    assert s["eps"] == f(1e-15)


def test_stats_plain_matches_the_eager_statistics():
    """J5's densification statistics against rgb.train's eager chain on
    the CPU: denom and max_radii bit for bit; grad_accum within one float32
    ulp, because PyTorch's CPU norm of two elements sums the second square
    with an FMA, where the card's reduction rounds each square (the card
    test holds J5 to the eager chain there bit for bit)."""
    g = torch.Generator().manual_seed(3)
    n = 5000
    g2d = torch.randn((n, 2), generator=g) * 1e-5
    radii = torch.randint(-1, 6, (n,), generator=g, dtype=torch.int32)
    acc = torch.rand((n,), generator=g)
    denom = torch.randint(0, 9, (n,), generator=g).float()
    max_r = torch.randint(0, 5, (n,), generator=g).float()
    got = rk.stats_plain(g2d, radii, 1280, 720, acc, denom, max_r)
    state = rt.RgbState(step=0, params=dict(means=torch.zeros((n, 3))),
                        alive=torch.ones(n, dtype=torch.bool), grad_accum=acc.clone(),
                        denom=denom.clone(), max_radii=max_r.clone(), opt=dict(means=dict(
                            mu=torch.zeros((n, 3)), nu=torch.zeros((n, 3)))),
                        generator=torch.Generator())
    rt._update_plain(state, dict(means=torch.zeros((n, 3))), dict(means=0.0), g2d, radii,
                     1280, 720)
    assert torch.equal(got[1], state.denom) and torch.equal(got[2], state.max_radii)
    ulp = torch.nextafter(state.grad_accum, torch.full_like(acc, np.inf)) - state.grad_accum
    assert ((got[0] - state.grad_accum).abs() <= ulp).all()
    assert not torch.equal(got[0], acc)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers take CUDA tensors only: the CPU runs the eager
    chains through sh_colors, photometric_loss and rgb.train._update."""
    p = torch.zeros(6)
    with pytest.raises(ValueError):
        rk.adam_update([p.view(2, 3)], [p.view(2, 3)], [dict(mu=p.view(2, 3), nu=p.view(2, 3))],
                       [1e-3], 0, torch.ones(2, dtype=torch.bool), -1e9,
                       (torch.zeros((2, 2)), torch.zeros(2, dtype=torch.int32), 4, 4, p[:2],
                        p[2:4], p[4:]))
    with pytest.raises(ValueError):
        rk.loss_forward(torch.zeros((4, 4, 3)), torch.zeros((4, 4, 3)), 0.2)
