"""Kernels J3 (`core/csrc/sh.cu`, the SH colours), J4
(`rgb/csrc/photometric_loss.cu`, the L1 + SSIM loss) and J5
(`rgb/csrc/adam.cu`, the update) against the eager chains they replace
on the card, and one RGB step of the kernel path against the eager path.

Marked `cuda`: each test skips, with its reason, where no CUDA device is
present. On a machine with a card:
python -m pytest tests/test_torch_rgb_kernels_cuda.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from gags_torch.core import sh as sh_mod
from gags_torch.rgb import kernels as rk
from gags_torch.rgb import train as rt

pytestmark = pytest.mark.cuda
F64 = torch.float64


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (J3-J5 have no CPU mode)")
    return torch.device("cuda")


def _rel(a, b):
    b = b.double()
    return float(torch.linalg.vector_norm(a.double() - b) / torch.linalg.vector_norm(b))


def _sh_case(dev, deg, n, k, seed):
    g = torch.Generator().manual_seed(seed)
    sh = torch.randn((n, k, 3), generator=g) * 0.5
    sh[:, 0] += 1.0  # most colours above the clamp, some below
    means = torch.randn((n, 3), generator=g) * 2.0
    campos = torch.tensor([0.3, -0.2, -6.0])
    g_colors = torch.randn((n, 3), generator=g)
    return [t.to(dev) for t in (sh, means, campos, g_colors)]


SH_CASES = [(d, 16, 1000) for d in range(4)] + [(d, 25, 777) for d in range(5)] + [(3, 16, 129)]


@pytest.mark.parametrize("deg,k,n", SH_CASES)
def test_sh_forward_bit_for_bit(dev, deg, k, n):
    """J3's colours equal the eager chain's on the card bit for bit, at
    every degree, with more coefficients than the degree reads, and for a
    partly filled last block."""
    sh, means, campos, _ = _sh_case(dev, deg, n, k, seed=deg * 7 + k)
    got = sh_mod.sh_forward(deg, sh, means, campos)
    want = sh_mod.sh_colors_plain(deg, sh, means, campos)
    assert torch.equal(got, want)
    assert (want == 0).any() or deg == 0


def test_sh_forward_bit_for_bit_at_scale(dev):
    """At the RGB cell's size (400k slots, K = 16, degree 3) from a
    non-contiguous sh, as `torch.cat` of the two groups gives it after a
    transpose: the same bits as the eager chain."""
    sh, means, campos, _ = _sh_case(dev, 3, 400_000, 16, seed=1)
    strided = sh.transpose(1, 2).contiguous().transpose(1, 2)
    assert torch.equal(sh_mod.sh_forward(3, strided, means, campos),
                       sh_mod.sh_colors_plain(3, sh, means, campos))


@pytest.mark.parametrize("deg,k,n", SH_CASES)
def test_sh_backward_within_float64(dev, deg, k, n):
    """J3's backward against the closed form in float64 with the clamp's
    mask from the float32 forward (the CPU tests tie that closed form to
    float64 autograd): relative L2 at most 1e-6 for both gradients, the
    float32 rounding of float64 results (6e-8 a value); exact zeros above
    (deg + 1)^2; a second launch equal bit for bit."""
    sh, means, campos, g_colors = _sh_case(dev, deg, n, k, seed=deg * 5 + k)
    g_sh, g_means = sh_mod.sh_backward(deg, sh, means, campos, g_colors)
    again = sh_mod.sh_backward(deg, sh, means, campos, g_colors)
    want = sh_mod.sh_colors_backward_plain(deg, sh.double(), means.double(), campos.double(),
                                           g_colors.double(), mask_dtype=torch.float32)
    assert torch.equal(g_sh, again[0]) and torch.equal(g_means, again[1])
    assert _rel(g_sh, want[0]) <= 1e-6
    if deg > 0:
        assert _rel(g_means, want[1]) <= 1e-6
    else:
        assert not g_means.any()
    assert not g_sh[:, (deg + 1) ** 2:].any()


def test_sh_backward_at_the_clamp_boundary(dev):
    """A colour exactly 0 in float32 before the clamp passes its gradient,
    one an ulp of its coefficient below passes none."""
    c0 = np.float32(sh_mod.SH_C0)
    s = np.float32(-0.5) / c0
    step = np.float32(np.inf) if c0 * s + np.float32(0.5) < 0 else np.float32(-np.inf)
    while c0 * s + np.float32(0.5) != 0:
        s = np.nextafter(s, step)
    below = np.nextafter(s, np.float32(-np.inf))
    sh = torch.zeros((2, 16, 3), device=dev)
    sh[0, 0] = float(s)
    sh[1, 0] = float(below)
    means = torch.tensor([[1.0, 2.0, 3.0], [-1.0, 0.5, 2.0]], device=dev)
    campos = torch.zeros(3, device=dev)
    g = torch.tensor([[1.0, -2.0, 3.0], [1.0, 1.0, 1.0]], device=dev)
    assert torch.equal(sh_mod.sh_colors_plain(0, sh, means, campos), torch.zeros((2, 3), device=dev))
    g_sh, _ = sh_mod.sh_backward(0, sh, means, campos, g)
    assert torch.equal(g_sh[0, 0], (g[0].double() * sh_mod.SH_C0).float())
    assert not g_sh[1].any()


def test_sh_colors_dispatch_and_autograd(dev):
    """sh_colors on CUDA float32 tensors is J3: one launch each way, the
    gradients of sh and the means J3's backward, campos given none."""
    sh, means, campos, g_colors = _sh_case(dev, 3, 5000, 16, seed=9)
    leaves = [t.clone().requires_grad_(True) for t in (sh, means)]
    sh_mod.reset_launch_counts()
    out = sh_mod.sh_colors(3, *leaves, campos)
    out.backward(g_colors)
    assert sh_mod.launch_counts == {"sh_forward": 1, "sh_backward": 1}
    want = sh_mod.sh_backward(3, sh, means, campos, g_colors)
    assert torch.equal(leaves[0].grad, want[0]) and torch.equal(leaves[1].grad, want[1])


@pytest.mark.parametrize("which,dtype", [(0, F64), (0, torch.float16), (1, torch.bfloat16),
                                         (2, F64), (None, None)])
def test_sh_colors_raises_on_what_j3_does_not_take(dev, which, dtype):
    """sh_colors on CUDA tensors is J3 alone: another dtype than float32,
    or a campos that asks for a gradient, raises instead of running the
    eager chain on the card."""
    sh, means, campos, _ = _sh_case(dev, 3, 64, 16, seed=4)
    args = [sh, means, campos]
    if which is None:
        args[2] = campos.clone().requires_grad_(True)
    else:
        args[which] = args[which].to(dtype)
    sh_mod.reset_launch_counts()
    with pytest.raises(ValueError, match="sh_colors"):
        sh_mod.sh_colors(3, *args)
    assert sh_mod.launch_counts == {"sh_forward": 0, "sh_backward": 0}


def _loss64(img, gt, lam):
    from gags_torch.utils.metrics import _filter2d_same, _gaussian_window

    win = _gaussian_window(11, device=img.device).to(F64)
    stack = torch.cat([img, gt, img * img, gt * gt, img * gt], dim=-1)
    mu1, mu2, f11, f22, f12 = torch.split(_filter2d_same(stack, win), 3, dim=-1)
    s1, s2, s12 = f11 - mu1 * mu1, f22 - mu2 * mu2, f12 - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / ((mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2))
    return (1 - lam) * torch.mean(torch.abs(img - gt)) + lam * (1.0 - torch.mean(m))


def _images(dev, h, w, seed):
    g = torch.Generator().manual_seed(seed)
    gt = torch.rand((h, w, 3), generator=g)
    img = (gt + 0.1 * torch.randn((h, w, 3), generator=g)).clamp(0, 1)
    img.view(-1)[::97] = gt.view(-1)[::97]
    return img.to(dev), gt.to(dev)


LOSS_SHAPES = [(720, 1280), (360, 1280), (17, 23), (1, 1), (5, 300), (33, 16)]


@pytest.mark.parametrize("h,w", LOSS_SHAPES)
def test_loss_forward_within_float64(dev, h, w):
    """J4's loss against the chain in float64: relative gap at most 1e-6
    (float64 sums rounded once to float32, 6e-8); the float32 eager chain
    is held to the same float64 value by the same bound where it can; a
    second launch gives the same bits (the block sums are added in block
    order, and the block counter is left at zero)."""
    img, gt = _images(dev, h, w, seed=h + w)
    got = rk.loss_forward(img, gt, 0.2)
    again = rk.loss_forward(img, gt, 0.2)
    want = float(_loss64(img.double(), gt.double(), 0.2))
    assert torch.equal(got, again)
    assert abs(float(got) - want) <= 1e-6 * abs(want)
    assert int(rk._ticket(img.device, torch.cuda.current_stream(dev).cuda_stream)) == 0


@pytest.mark.parametrize("h,w", LOSS_SHAPES)
def test_loss_backward_within_float64(dev, h, w):
    """J4's image gradient against float64 autograd through the chain:
    relative L2 at most 1e-6 (float64 arithmetic rounded once to float32),
    and no worse than float32 autograd's own gap."""
    img, gt = _images(dev, h, w, seed=h * w)
    g_loss = torch.tensor([1.3], device=dev)
    got = rk.loss_backward(img, gt, 0.2, g_loss)
    leaf = img.double().requires_grad_(True)
    want, = torch.autograd.grad(_loss64(leaf, gt.double(), 0.2), leaf,
                                torch.tensor(1.3, dtype=F64, device=dev))
    leaf32 = img.clone().requires_grad_(True)
    eager, = torch.autograd.grad(rk.photometric_loss_plain(leaf32, gt, 0.2), leaf32,
                                 torch.tensor(1.3, device=dev))
    assert _rel(got, want) <= 1e-6
    assert _rel(got, want) <= max(_rel(eager, want), 1e-7)
    assert torch.equal(got, rk.loss_backward(img, gt, 0.2, g_loss))


def test_loss_dispatch_and_autograd(dev):
    """photometric_loss on CUDA is J4, one launch each way; the image's
    gradient is J4's backward of the loss's gradient."""
    img, gt = _images(dev, 64, 48, seed=4)
    leaf = img.clone().requires_grad_(True)
    rk.reset_launch_counts()
    loss = rk.photometric_loss(leaf, gt, 0.2)
    (2.0 * loss).backward()
    assert rk.launch_counts["loss_forward"] == 1 and rk.launch_counts["loss_backward"] == 1
    assert torch.equal(leaf.grad, rk.loss_backward(img, gt, 0.2, torch.tensor([2.0], device=dev)))


def test_loss_forward_on_two_streams(dev):
    """J4 forward's block counter is a stream's own: launches on two
    streams at once give each the loss one stream alone gives."""
    cases = [_images(dev, 720, 1280, seed=s) for s in (5, 6)]
    want = [rk.loss_forward(img, gt, 0.2) for img, gt in cases]
    streams = [torch.cuda.Stream(dev) for _ in cases]
    torch.cuda.synchronize(dev)
    got = [[], []]
    for _ in range(20):
        for i, ((img, gt), s) in enumerate(zip(cases, streams)):
            with torch.cuda.stream(s):
                got[i].append(rk.loss_forward(img, gt, 0.2))
    torch.cuda.synchronize(dev)
    for w, g in zip(want, got):
        assert all(torch.equal(x, w) for x in g)


def _state(dev, n, seed):
    g = torch.Generator().manual_seed(seed)
    shapes = dict(means=(n, 3), sh_dc=(n, 1, 3), sh_rest=(n, 15, 3), opacities_raw=(n,),
                  scales_raw=(n, 3), quats=(n, 4))

    def r(shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    params = {k: r(s) for k, s in shapes.items()}
    opt = {k: dict(mu=r(s, 1e-3), nu=(torch.rand(s, generator=g) * 1e-6).to(dev))
           for k, s in shapes.items()}
    grads = {k: r(s, 1e-3) for k, s in shapes.items()}
    grads["quats"][::5] = 0.0
    alive = (torch.rand((n,), generator=g) < 0.7).to(dev)
    state = rt.RgbState(step=0, params=params, alive=alive, grad_accum=r((n,)).abs(),
                        denom=torch.randint(0, 9, (n,), generator=g).float().to(dev),
                        max_radii=torch.randint(0, 9, (n,), generator=g).float().to(dev),
                        opt=opt, generator=torch.Generator(device=dev))
    g2d = r((n, 2), 1e-5)
    radii = torch.randint(-1, 12, (n,), generator=g, dtype=torch.int32).to(dev)
    return state, grads, g2d, radii


def _copy(state):
    return rt.RgbState(step=state.step, params={k: v.clone() for k, v in state.params.items()},
                       alive=state.alive.clone(), grad_accum=state.grad_accum.clone(),
                       denom=state.denom.clone(), max_radii=state.max_radii.clone(),
                       opt={k: {kk: vv.clone() for kk, vv in v.items()}
                            for k, v in state.opt.items()}, generator=state.generator)


def _same_state(a, b):
    for k in rt.GROUPS:
        assert torch.equal(a.params[k], b.params[k]), k
        assert torch.equal(a.opt[k]["mu"], b.opt[k]["mu"]), k
        assert torch.equal(a.opt[k]["nu"], b.opt[k]["nu"]), k
    for k in ("grad_accum", "denom", "max_radii"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k


@pytest.mark.parametrize("n,step", [(400_000, 0), (400_000, 3000), (1001, 7), (3, 29_999)])
def test_adam_update_bit_for_bit(dev, n, step):
    """J5 (rgb.train._update on the card) equals the eager chain it
    replaces, `_update_plain`, bit for bit: the six groups' parameters and
    moments, the parked means of dead slots and the three statistics; and
    its arithmetic is rk.adam_plain's (computed on the CPU as the card
    rounds)."""
    state, grads, g2d, radii = _state(dev, n, seed=n + step)
    state.step = step
    lrs = dict(means=1.6e-4 * 3.3, sh_dc=2.5e-3, sh_rest=2.5e-3 / 20.0, opacities_raw=0.05,
               scales_raw=5e-3, quats=1e-3)
    eager = _copy(state)
    before = _copy(state)
    rk.reset_launch_counts()
    rt._update(state, grads, lrs, g2d, radii, 1280, 720)
    assert rk.launch_counts["adam_update"] == 1
    rt._update_plain(eager, grads, lrs, g2d, radii, 1280, 720)
    _same_state(state, eager)
    for k in ("sh_rest", "quats"):
        p, mu, nu = rk.adam_plain(*(t.cpu() for t in (before.params[k], grads[k],
                                                      before.opt[k]["mu"], before.opt[k]["nu"])),
                                  lrs[k], step)
        assert torch.equal(mu, state.opt[k]["mu"].cpu()) and torch.equal(nu, state.opt[k]["nu"].cpu())
        assert torch.equal(p, state.params[k].cpu())
    acc, den, mr = rk.stats_plain(g2d.cpu(), radii.cpu(), 1280, 720, before.grad_accum.cpu(),
                                  before.denom.cpu(), before.max_radii.cpu())
    assert torch.equal(acc, state.grad_accum.cpu()) and torch.equal(den, state.denom.cpu())
    assert torch.equal(mr, state.max_radii.cpu())


def _scene(dev, n, w, h, seed):
    from gags_torch.scene.gaussian_data import GaussianScene
    from gags_torch.utils.synthetic import make_camera, make_scene

    raw = make_scene(n, seed=seed, extent=2.0)
    g = torch.Generator().manual_seed(seed)
    sh = torch.randn((n, 16, 3), generator=g) * 0.2
    scene = GaussianScene(
        means=torch.as_tensor(raw["means"]), sh=sh,
        opacities_raw=torch.logit(torch.as_tensor(raw["opacities"]).clamp(1e-4, 1 - 1e-4)),
        scales_raw=torch.log(torch.as_tensor(raw["scales"])), quats=torch.as_tensor(raw["quats"]),
        semantic_features=None, max_sh_degree=3)
    cam = make_camera(w, h, device=dev)
    return scene, cam


def test_rgb_step_kernels_against_eager(dev, monkeypatch):
    """Three RGB steps at SH degree 3 with J3-J5 against the same steps
    with the eager chains on the card, from one state: the rendered colours
    and so the image and radii are the same bits (J3 forward), the losses
    within 1e-6 relative (J4's float64 sums against cuDNN's float32), each
    group's gradient within 1e-5 relative L2 and each parameter's change
    within 1e-4 (float32 rounding of the image gradient, carried through K8
    and Adam), the densification statistics within 1e-4, the views counted
    and radii bit for bit; J3-J5 launched once a step each way."""
    w, h = 320, 192
    scene, cam = _scene(dev, 20_000, w, h, seed=5)
    cfg = rt.RgbConfig()
    g = torch.Generator().manual_seed(6)
    target = torch.rand((h, w, 3), generator=g).to(dev)
    batch = dict(viewmat=cam.viewmat, K=cam.K, image=target)

    def run(kernels: bool):
        state = rt.create_rgb_state(scene, cfg, seed=0, device=dev)
        init = {k: v.clone() for k, v in state.params.items()}
        step = rt.make_rgb_step(cfg, w, h, spatial_scale=1.0)
        with monkeypatch.context() as m:
            if not kernels:
                m.setattr(rt, "sh_colors", sh_mod.sh_colors_plain)
                m.setattr(rt, "photometric_loss", rk.photometric_loss_plain)
                m.setattr(rt, "_update", rt._update_plain)
            colors = rt.sh_colors(3, state.sh, state.means, -cam.viewmat[:3, :3].T @ cam.viewmat[:3, 3])
            sh_mod.reset_launch_counts()
            rk.reset_launch_counts()
            losses, grads = [], None
            for i in range(3):
                _, metrics = step(state, batch, 1e-4, 3)
                losses.append(float(metrics["loss"]))
                if i == 0:
                    grads = {k: state.opt[k]["mu"] / 0.1 for k in rt.GROUPS}
            launches = dict(sh_mod.launch_counts, **rk.launch_counts)
        change = {k: state.params[k] - init[k] for k in rt.GROUPS}
        return colors, losses, grads, change, state, launches

    c_k, l_k, g_k, d_k, s_k, n_k = run(True)
    c_e, l_e, g_e, d_e, s_e, n_e = run(False)
    assert torch.equal(c_k, c_e)
    assert n_k == {"sh_forward": 3, "sh_backward": 3, "loss_forward": 3, "loss_backward": 3,
                   "adam_update": 3}
    assert not any(n_e.values())
    for a, b in zip(l_k, l_e):
        assert abs(a - b) <= 1e-6 * abs(b)
    for k in rt.GROUPS:
        assert _rel(g_k[k], g_e[k]) <= 1e-5, k
        assert _rel(d_k[k], d_e[k]) <= 1e-4, k
    assert _rel(s_k.grad_accum, s_e.grad_accum) <= 1e-4
    assert torch.equal(s_k.denom, s_e.denom) and torch.equal(s_k.max_radii, s_e.max_radii)
