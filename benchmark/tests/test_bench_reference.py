"""The plain reference against the port's plain (CPU) path on the same
inputs, at tiny sizes. The port is imported here only; the reference
modules themselves import nothing of it."""

import numpy as np
import pytest
import torch

from benchmark.lib import fixtures
from benchmark.reference import raster
from benchmark.reference import rgb as ref_rgb
from benchmark.reference import serve as ref_serve

W, H = 80, 48


def _scene(n=1500, seed=5):
    s = fixtures.make_scene(n, seed, extent=2.0)
    t = {k: torch.as_tensor(v) for k, v in s.items()}
    vm = torch.as_tensor(fixtures.look_at((0.2, -0.1, -0.3), (0.0, 0.0, 6.0)).astype(np.float32))
    f = W / (2 * np.tan(np.radians(30.0)))
    K = torch.tensor([[f, 0.0, W / 2], [0.0, f, H / 2], [0.0, 0.0, 1.0]], dtype=torch.float32)
    return t, vm, K


def test_colour_render_matches_the_port():
    from gags_torch.splat.rasterizer import RasterizeConfig, rasterize

    t, vm, K = _scene()
    want = rasterize(t["means"], t["quats"], t["scales"], t["opacities"], t["features"], vm, K,
                     W, H, background=torch.zeros(16), config=RasterizeConfig(aligned=False),
                     device="cpu").image
    proj = raster.project(t["means"], t["quats"], t["scales"], t["opacities"], vm, K, W, H)
    walk = raster.walk(proj, t["opacities"], raster.tile_lists(proj, W, H), W, H)
    got = raster.render_colors(walk, t["features"], W, H)
    assert walk.blended > 1000
    torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-6)


def test_geometry_gradients_match_the_port():
    from gags_torch.splat.rasterizer import RasterizeConfig, rasterize

    t, vm, K = _scene(600, 6)
    g = torch.randn((H, W, 3), generator=torch.Generator().manual_seed(1))
    leaves = dict(means=t["means"], quats=t["quats"], log_s=torch.log(t["scales"]),
                  logit_o=torch.logit(t["opacities"]), cols=torch.rand((600, 3)))

    def grads(fn):
        lv = {k: v.clone().requires_grad_(True) for k, v in leaves.items()}
        img = fn(lv)
        (img * g).sum().backward()
        return {k: v.grad for k, v in lv.items()}

    def port(lv):
        return rasterize(lv["means"], lv["quats"], torch.exp(lv["log_s"]),
                         torch.sigmoid(lv["logit_o"]), lv["cols"], vm, K, W, H,
                         background=torch.zeros(3),
                         config=RasterizeConfig(geometry_grads=True), device="cpu").image

    def ref(lv):
        op = torch.sigmoid(lv["logit_o"])
        proj = raster.project(lv["means"], lv["quats"], torch.exp(lv["log_s"]), op, vm, K, W, H)
        walk = raster.walk(proj, op, raster.tile_lists(proj, W, H), W, H)
        return raster.composite(walk, proj, op, lv["cols"], W, H)[0]

    want, got = grads(port), grads(ref)
    for k in leaves:
        scale = want[k].abs().max()
        assert scale > 0, k
        torch.testing.assert_close(got[k], want[k], rtol=1e-3, atol=1e-4 * float(scale), msg=k)


def test_ssim_and_sh_match_the_port():
    from gags_torch.core.sh import sh_colors
    from gags_torch.utils.metrics import ssim

    gen = torch.Generator().manual_seed(2)
    a, b = torch.rand((H, W, 3), generator=gen), torch.rand((H, W, 3), generator=gen)
    torch.testing.assert_close(ref_rgb.ssim(a, b, ref_rgb.gaussian_window()), ssim(a, b),
                               rtol=1e-5, atol=1e-6)
    t, vm, _ = _scene(300, 7)
    campos = -vm[:3, :3].T @ vm[:3, 3]
    for deg in range(4):
        torch.testing.assert_close(ref_rgb.sh_colors(deg, t["sh"], t["means"], campos),
                                   sh_colors(deg, t["sh"], t["means"], campos))


def test_relevancy_chain_matches_the_port():
    from gags_torch.query.relevancy import heatmap_to_mask, majority_smooth
    from gags_torch.utils.colormaps import turbo

    rel = torch.rand((H, W), generator=torch.Generator().manual_seed(3)) ** 3
    m_ref, vm_ref = ref_serve.heatmap_to_mask(rel, 0.5)
    m_port, vm_port = heatmap_to_mask(rel, 0.5)
    torch.testing.assert_close(vm_ref, vm_port, rtol=1e-5, atol=1e-6)
    assert torch.equal(m_ref.to(torch.uint8), m_port)
    assert torch.equal(ref_serve.majority_smooth(m_ref).to(torch.uint8), majority_smooth(m_port))
    x = np.linspace(0, 1, 1001, dtype=np.float32)
    assert np.array_equal(ref_serve.turbo(x), turbo(x))


def test_densify_matches_the_port():
    import gags_torch.rgb.train as rt
    from gags_torch.scene.gaussian_data import GaussianScene

    n = 200
    gen = torch.Generator().manual_seed(4)
    scene = GaussianScene(means=torch.randn((n, 3), generator=gen),
                          sh=torch.randn((n, 16, 3), generator=gen) * 0.1,
                          opacities_raw=torch.randn((n,), generator=gen) * 3,
                          scales_raw=torch.randn((n, 3), generator=gen) - 3.0,
                          quats=torch.randn((n, 4), generator=gen), max_sh_degree=3)
    cfg = rt.RgbConfig(capacity_factor=2)
    state = rt.create_rgb_state(scene, cfg, device="cpu")
    state.grad_accum[:n] = torch.rand((n,), generator=gen) * 6e-4
    state.denom[:n] = 1.0
    before = {k: v.clone() for k, v in state.params.items()}
    alive, acc, den = state.alive.clone(), state.grad_accum.clone(), state.denom.clone()
    noise = [torch.randn((2 * n, 3), generator=gen) for _ in range(2)]
    rt.densify_step(state, 2e-4, 0.01, 3.0, 0.005, noise=noise)
    new, new_alive, _ = ref_rgb.densify(before, alive, acc, den, noise, dict(
        densify_grad_threshold=2e-4, percent_dense=0.01, min_opacity=0.005), 3.0)
    assert torch.equal(new_alive, state.alive)
    assert int(new_alive.sum()) != n
    for k, v in new.items():
        torch.testing.assert_close(state.params[k], v, rtol=1e-6, atol=1e-7, msg=k)


@pytest.mark.parametrize("seed", [0, 1])
def test_png_round_trip(seed):
    from gags_torch.utils.image import encode_png

    img = np.random.default_rng(seed).random((H, W, 3)).astype(np.float32)
    want = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    assert np.array_equal(fixtures.decode_png(encode_png(img)), want)
    assert np.array_equal(fixtures.decode_png(fixtures.encode_png(want)), want)
