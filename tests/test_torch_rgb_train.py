"""The port's RGB pretraining (gags_torch.rgb.train) against gags_tpu's on
the CPU: two steps from a carried JAX RgbState, densify_step with JAX's
own split noise, reset_opacity_step, to_scene and expon_lr; then the
trainer's mechanics (the loss falls, clone / split / prune counts)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gags_tpu.rgb import train as jrgb
from gags_tpu.scene.gaussian_data import GaussianScene as JScene
from gags_tpu.splat.rasterizer import RasterizeConfig as JRasterizeConfig
from gags_torch.models.weights import load_jax_rgb_state, scene_from_arrays
from gags_torch.rgb import train as trgb
from gags_torch.splat.rasterizer import RasterizeConfig
from gags_torch.splat.render import render
from gags_torch.utils.synthetic import make_camera, make_scene

W, H, N = 32, 16, 50
TILE = dict(tile_h=8, tile_w=16, chunk=8, budget_factor=8, geometry_grads=True)
JCFG = jrgb.RgbConfig(capacity_factor=2, raster=JRasterizeConfig(**TILE, interpret=True))
TCFG = trgb.RgbConfig(capacity_factor=2, raster=RasterizeConfig(**TILE))
XYZ_LR = 1.6e-4


def _raw_scene(seed):
    raw = make_scene(N, seed=seed)
    return dict(means=raw["means"], quats=raw["quats"], scales_raw=np.log(raw["scales"]),
                opacities_raw=np.log(raw["opacities"] / (1 - raw["opacities"])), sh=raw["sh"])


def _jscene(a):
    return JScene(**{k: jnp.asarray(v) for k, v in a.items()}, semantic_features=None)


def _tscene(a):
    return scene_from_arrays(**a)


def _gt_image(seed):
    a = _raw_scene(seed)
    s = _tscene(a)
    return render(make_camera(W, H), means=s.means, quats=s.quats, scales=s.scales,
                  opacities=s.opacities, sh=s.sh, sh_degree=3, bg_color=torch.zeros(3),
                  config=TCFG.raster, device="cpu").render.numpy()


def _np_state(st):
    """Every compared field of a state of either package, as numpy copies
    (the port updates its tensors in place)."""
    out = dict(step=int(np.asarray(st.step)))
    for k in ("means", "sh", "opacities_raw", "scales_raw", "quats", "alive", "grad_accum",
              "denom", "max_radii"):
        out[k] = np.array(getattr(st, k))
    for g in trgb.GROUPS:
        for k in ("mu", "nu"):
            out[f"{g}.{k}"] = np.array(st.opt[g][k])
    return out


# --------------------------------------------------------------------------
# two steps from a carried state
# --------------------------------------------------------------------------


def _sh4_scene(seed):
    """`_raw_scene` with degree-4 colours: coefficients 16-24 drawn from a
    seeded N(0, 0.1), so that the step reads and trains them."""
    a = _raw_scene(seed)
    extra = 0.1 * np.random.default_rng(seed).normal(size=(N, 9, 3))
    a["sh"] = np.concatenate([a["sh"], extra.astype(np.float32)], axis=1)
    return a


def _jax_steps(start, jcfg, sh_degree):
    gt = _gt_image(7)
    st0 = jrgb.create_rgb_state(_jscene(start), jcfg)
    cam = make_camera(W, H)
    batch = dict(viewmat=jnp.asarray(cam.viewmat.numpy()), K=jnp.asarray(cam.K.numpy()),
                 image=jnp.asarray(gt))
    step = jrgb.make_rgb_step(jcfg, W, H, spatial_scale=1.0)
    st1, m1 = step(st0, batch, jnp.float32(XYZ_LR), sh_degree)
    st2, m2 = step(st1, batch, jnp.float32(XYZ_LR), sh_degree)
    return dict(st0=st0, states=[_np_state(st1), _np_state(st2)],
                losses=[float(m1["loss"]), float(m2["loss"])], gt=gt, cam=cam, start=start)


@pytest.fixture(scope="module")
def jax_two_steps():
    return _jax_steps(_raw_scene(1), JCFG, 3)


def test_create_rgb_state_matches_jax(jax_two_steps):
    want = _np_state(jax_two_steps["st0"])
    got = _np_state(trgb.create_rgb_state(_tscene(jax_two_steps["start"]), TCFG, device="cpu"))
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)


def test_two_steps_match_jax(jax_two_steps):
    """Gradients tightly (the first moments after step 1 are 0.1 g); then
    every field after two steps. With eps = 1e-15 the first Adam step is
    +-lr sign(g): an element whose gradient is rounding noise may flip
    sign in one package, so elements with |g_jax| < 1e-6 max|g_jax| are
    held to 2 lr per step, the rest to float32 rounding."""
    _match_two_steps(jax_two_steps, TCFG, 3)


def test_two_steps_match_jax_sh_degree_4():
    """The same two steps at SH degree 4 (K = 25 coefficients a Gaussian,
    16-24 non-zero), from the same carried state in both packages."""
    jcfg = dataclasses.replace(JCFG, sh_degree=4)
    want = _jax_steps(_sh4_scene(1), jcfg, 4)
    assert want["states"][0]["sh"].shape[1] == 25
    _match_two_steps(want, dataclasses.replace(TCFG, sh_degree=4), 4)


def _match_two_steps(jax_two_steps, tcfg, sh_degree):
    cam, gt = jax_two_steps["cam"], torch.as_tensor(jax_two_steps["gt"])
    state = load_jax_rgb_state(jax_two_steps["st0"], device="cpu")
    step = trgb.make_rgb_step(tcfg, W, H, spatial_scale=1.0)
    batch = dict(viewmat=cam.viewmat, K=cam.K, image=gt)
    losses = []
    got = []
    for _ in range(2):
        state, m = step(state, batch, XYZ_LR, sh_degree)
        losses.append(float(m["loss"]))
        got.append(_np_state(state))
    np.testing.assert_allclose(losses, jax_two_steps["losses"], rtol=1e-5)
    want1, want2 = jax_two_steps["states"]

    # 1. the gradients: mu = 0.1 g after the first step, nu = 0.001 g^2,
    # and grad_accum holds the screen-space gradient norm
    noise = {}
    for g in trgb.GROUPS:
        mu_w, mu_g = want1[f"{g}.mu"], got[0][f"{g}.mu"]
        scale = np.abs(mu_w).max()
        assert scale > 0, g
        np.testing.assert_allclose(mu_g, mu_w, atol=2e-5 * scale, rtol=2e-3, err_msg=g)
        # exact zeros in both (dead and unseen slots) are held tightly
        noise[g] = (np.abs(mu_w) < 1e-6 * scale) & ((mu_w != 0) | (mu_g != 0))
    np.testing.assert_allclose(got[0]["grad_accum"], want1["grad_accum"],
                               atol=2e-5 * want1["grad_accum"].max(), rtol=2e-3)
    assert want1["grad_accum"].max() > 0

    # 2. the states after each step
    lrs = dict(means=XYZ_LR, sh_dc=tcfg.feature_lr, sh_rest=tcfg.feature_lr / 20,
               opacities_raw=tcfg.opacity_lr, scales_raw=tcfg.scaling_lr,
               quats=tcfg.rotation_lr)
    n_noise = 0
    for i, (g_st, w_st) in enumerate(zip(got, (want1, want2))):
        assert g_st["step"] == w_st["step"] == i + 1
        for k in ("alive", "denom", "max_radii"):
            np.testing.assert_array_equal(g_st[k], w_st[k], err_msg=k)
        sh_g = dict(sh_dc=g_st["sh"][:, :1], sh_rest=g_st["sh"][:, 1:])
        sh_w = dict(sh_dc=w_st["sh"][:, :1], sh_rest=w_st["sh"][:, 1:])
        for g in trgb.GROUPS:
            pg = sh_g[g] if g in sh_g else g_st[g]
            pw = sh_w[g] if g in sh_w else w_st[g]
            mask = noise[g]
            n_noise += int(mask.sum()) if i == 0 else 0
            np.testing.assert_allclose(pg[~mask], pw[~mask], atol=1e-6, rtol=1e-5, err_msg=g)
            assert np.all(np.abs(pg[mask] - pw[mask]) <= 2 * lrs[g] * (i + 1) + 1e-6), g
            for k in ("mu", "nu"):
                a, b = g_st[f"{g}.{k}"], w_st[f"{g}.{k}"]
                np.testing.assert_allclose(a, b, atol=2e-5 * np.abs(b).max(), rtol=2e-3,
                                           err_msg=f"{g}.{k}")
    # the rounding-noise elements are a small minority
    total = sum(want1[f"{g}.mu"].size for g in trgb.GROUPS)
    assert n_noise < 0.01 * total, (n_noise, total)


# --------------------------------------------------------------------------
# densify / reset / extract / schedule
# --------------------------------------------------------------------------


def _densify_case():
    """A JAX state with clones, splits and prunes all due: high gradients
    on 12 slots, 6 of them large; 5 transparent slots."""
    cfg = dataclasses.replace(JCFG, capacity_factor=3)
    st = jrgb.create_rgb_state(_jscene(_raw_scene(2)), cfg)
    scales = np.exp(np.asarray(st.scales_raw)).max(1)
    big = np.argsort(scales[:N])[-6:]
    small = np.argsort(scales[:N])[:6]
    accum = np.zeros(3 * N, np.float32)
    accum[np.concatenate([big, small])] = 10.0
    opac = np.asarray(st.opacities_raw).copy()
    opac[[20, 21, 22, 23, 24]] = -10.0
    extent = float(np.sort(scales[:N])[N // 2]) / 0.01  # the median splits
    return dataclasses.replace(st, grad_accum=jnp.asarray(accum),
                               denom=jnp.ones((3 * N,), jnp.float32),
                               opacities_raw=jnp.asarray(opac)), extent


def test_densify_step_matches_jax():
    st, extent = _densify_case()
    want = _np_state(jrgb.densify_step(st, 1.0, 0.01, extent, 0.005))
    _, k1, k2 = jax.random.split(st.rng, 3)
    noise = (np.array(jax.random.normal(k1, st.means.shape)),
             np.array(jax.random.normal(k2, st.means.shape)))
    ts = load_jax_rgb_state(st, device="cpu")
    # non-zero moments, so that zeroing the written slots shows
    for g in trgb.GROUPS:
        for m in ts.opt[g].values():
            m.fill_(0.5)
    got = _np_state(trgb.densify_step(ts, 1.0, 0.01, extent, 0.005, noise=noise))
    alive0 = np.asarray(st.alive)
    n_new = int(want["alive"].sum())
    assert n_new == int(alive0.sum()) + 6 + 2 * 6 - 6 - 5  # clones, children, parents, prunes
    np.testing.assert_array_equal(got["alive"], want["alive"])
    for k in ("means", "sh", "opacities_raw", "scales_raw", "quats"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)
    for k in ("grad_accum", "denom", "max_radii"):
        assert not got[k].any()
    written = want["alive"] & ~alive0
    assert written.sum() == 6 + 12
    for g in trgb.GROUPS:
        for k in ("mu", "nu"):
            m = got[f"{g}.{k}"]
            assert not m[written].any() and np.all(m[~written] == 0.5), (g, k)


def test_reset_opacity_and_to_scene_match_jax():
    st = jrgb.create_rgb_state(_jscene(_raw_scene(3)), JCFG)
    want = jrgb.reset_opacity_step(st)
    got = trgb.reset_opacity_step(load_jax_rgb_state(st, device="cpu"))
    np.testing.assert_allclose(got.opacities_raw.numpy(), np.asarray(want.opacities_raw),
                               rtol=1e-6, atol=1e-6)
    alive = np.asarray(st.alive)
    assert np.asarray(jax.nn.sigmoid(want.opacities_raw))[alive].max() <= 0.0101
    sj, stt = jrgb.to_scene(want, 3), trgb.to_scene(got, 3)
    assert stt.num_gaussians == sj.num_gaussians == N
    for k in ("means", "sh", "opacities_raw", "scales_raw", "quats", "semantic_features"):
        np.testing.assert_allclose(getattr(stt, k).numpy(), np.asarray(getattr(sj, k)),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("step", [0.0, 1.0, 500.0, 7000.0, 30000.0, 45000.0])
def test_expon_lr_matches_jax(step):
    args = (1.6e-4 * 3.3, 1.6e-6 * 3.3, 0.01, 30_000)
    want = float(jrgb.expon_lr(jnp.float32(step), *args))
    assert trgb.expon_lr(step, *args) == pytest.approx(want, rel=1e-6)


def test_create_rgb_state_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        trgb.create_rgb_state(_tscene(_raw_scene(0)), TCFG)


# --------------------------------------------------------------------------
# mechanics of the port alone (tests/test_rgb_training.py)
# --------------------------------------------------------------------------


def test_rgb_step_reduces_loss():
    """The dc colours of the same geometry perturbed by 0.8: 60 steps must
    take the loss down by at least 40%."""
    target = _raw_scene(7)
    gt = torch.as_tensor(_gt_image(7))
    start = dict(target, sh=target["sh"].copy())
    start["sh"][:, 0, :] += 0.8
    state = trgb.create_rgb_state(_tscene(start), TCFG, device="cpu")
    step = trgb.make_rgb_step(TCFG, W, H, spatial_scale=1.0)
    cam = make_camera(W, H)
    batch = dict(viewmat=cam.viewmat, K=cam.K, image=gt)
    losses = []
    for i in range(60):
        lr = trgb.expon_lr(float(i), TCFG.position_lr_init, TCFG.position_lr_final,
                           TCFG.position_lr_delay_mult, TCFG.position_lr_max_steps)
        state, m = step(state, batch, lr, 3)
        losses.append(float(m["loss"]))
    assert np.all(np.isfinite(losses))
    assert losses[-1] < losses[0] * 0.6, (losses[0], losses[-1])


def test_densify_clone_split_prune():
    cfg = dataclasses.replace(TCFG, capacity_factor=3)
    state = trgb.create_rgb_state(_tscene(_raw_scene(1)), cfg, device="cpu")
    n0 = int(state.alive.sum())

    def fabricated():
        st = trgb.create_rgb_state(_tscene(_raw_scene(1)), cfg, device="cpu")
        st.grad_accum[:4] = 10.0
        st.denom[:] = 1.0
        return st

    s1 = trgb.densify_step(fabricated(), 1.0, 0.01, 100.0, 0.005)  # all 4 small: cloned
    assert int(s1.alive.sum()) == n0 + 4
    new_idx = torch.nonzero(s1.alive & ~state.alive)[:, 0]
    np.testing.assert_allclose(np.sort(s1.means[new_idx][:, 0].numpy()),
                               np.sort(state.means[:4, 0].numpy()), rtol=1e-6)
    s2 = trgb.densify_step(fabricated(), 1.0, 0.01, 1e-9, 0.005)  # all 4 large: split
    assert int(s2.alive.sum()) == n0 - 4 + 8
    kid_idx = torch.nonzero(s2.alive & ~state.alive)[:, 0]
    assert len(kid_idx) == 8
    np.testing.assert_allclose(torch.exp(s2.scales_raw[kid_idx[0]]).numpy(),
                               torch.exp(state.scales_raw[0]).numpy() / 1.6, rtol=1e-5)
    st = trgb.create_rgb_state(_tscene(_raw_scene(1)), cfg, device="cpu")
    st.params["opacities_raw"].fill_(-10.0)
    s3 = trgb.densify_step(st, 1.0, 0.01, 100.0, 0.005)  # everything transparent dies
    assert int(s3.alive.sum()) == 0
    assert float(s3.means[:, 2].max()) < -1e8  # parked behind every camera
