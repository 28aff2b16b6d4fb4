"""The port's binned GAD train step vs gags_tpu's, from identical state.

The JAX state (after one warm-up step, so the Adam moments are non-zero)
is carried into the port with models.weights.load_jax_train_state; both
sides then take the same binned steps on the same batch."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gags_tpu.gad import train as jtrain
from gags_tpu.scene.gaussian_data import GaussianScene as JScene
from gags_tpu.splat.rasterizer import RasterizeConfig as JConfig
from gags_tpu.splat.rasterizer import prepare_binning as jprepare
from gags_torch.gad import train as ttrain
from gags_torch.models.weights import load_jax_train_state, scene_from_arrays
from gags_torch.splat.rasterizer import RasterizeConfig, prepare_binning
from gags_torch.utils.synthetic import make_camera, make_scene

W, H, N, F, CLIP, N_MASKS = 32, 16, 80, 8, 32, 6
TILE = dict(tile_h=8, tile_w=16, chunk=8)
METRICS = ("loss", "l1_feature", "entropy", "region_var")


def _inputs():
    raw = make_scene(N, seed=0)
    rng = np.random.default_rng(1)
    feats = (0.1 * rng.normal(size=(N, F))).astype(np.float32)
    embed = rng.normal(size=(N_MASKS, CLIP)).astype(np.float32)
    embed /= np.linalg.norm(embed, axis=1, keepdims=True)
    seg = np.full((H, W, 4), -1, np.int32)
    seg[..., 0] = 0
    seg[:, : W // 2, 1] = 0
    seg[:, W // 2:, 1] = 1
    seg[: H // 2, :, 2] = 2
    seg[H // 2:, :, 2] = 3
    seg[..., 3] = 4
    seg[0, 0, :] = -1  # an invalid pixel
    seg[H // 2:, W // 4: W // 2, 3] = 5
    return raw, feats, embed, seg


def _cfgs(**kw):
    # the default learning rates (features 1e-3, decoders 1e-4)
    jcfg = jtrain.GadConfig(feature_dim=F, clip_dim=CLIP, max_segments=16,
                            raster=JConfig(**TILE, interpret=True), **kw)
    tcfg = ttrain.GadConfig(feature_dim=F, clip_dim=CLIP, max_segments=16,
                            raster=RasterizeConfig(**TILE), **kw)
    return jcfg, tcfg


def _setup(**kw):
    p = _setup_parts(**kw)
    return p["jstate"], p["jstep"], p["tstate"], p["tstep"]


@functools.lru_cache(maxsize=None)
def _jax_parts(kw_items):
    """The JAX state after one warm-up step and its step, once per config:
    the state is immutable and the step pure, so every caller may share
    them (one interpret-mode compile instead of one per test)."""
    raw, feats, embed, seg = _inputs()
    jcfg, _ = _cfgs(**dict(kw_items))
    jscene = JScene(**{k: jnp.asarray(v) for k, v in _craw(raw).items()},
                    semantic_features=jnp.asarray(feats))
    cam = make_camera(W, H)
    vm, K = cam.viewmat.numpy(), cam.K.numpy()

    jstate, statics = jtrain.create_train_state(jscene, jax.random.PRNGKey(0), jcfg)
    jgeom = jtrain.frozen_geometry(jscene)
    jb = jprepare(jgeom["means"], jgeom["quats"], jgeom["scales"], jnp.asarray(vm),
                  jnp.asarray(K), W, H, jcfg.raster, opacities=jgeom["opacities"])
    jbatch = dict(viewmat=jnp.asarray(vm), K=jnp.asarray(K), img_embed=jnp.asarray(embed),
                  seg_map=jnp.asarray(seg), inst_gid=jb.inst_gid, tile_starts=jb.tile_starts,
                  tile_counts=jb.tile_counts, order=jb.order, red_slot=jb.red.slot_to_pos,
                  red_rank=jb.red.slot_rank, red_block=jb.red.chunk_block)
    jstep_fn = jtrain.make_train_step_binned(statics, W, H, jcfg)

    def jstep(state, ew, rw):
        return jstep_fn(state, jgeom, jbatch, jnp.float32(ew), jnp.float32(rw))

    # one JAX warm-up step, so that the carried Adam moments are non-zero
    jstate, _ = jstep(jstate, 1e-3, 0.0)
    return jstate, jstep


def _craw(raw):
    return dict(means=raw["means"], quats=raw["quats"], scales_raw=np.log(raw["scales"]),
                opacities_raw=np.log(raw["opacities"] / (1 - raw["opacities"])), sh=raw["sh"])


def _setup_parts(**kw):
    """Both packages' states from one JAX warm-up step (a fresh port state
    each call), their steps, and the port's geometry, batch and config."""
    jstate, jstep = _jax_parts(tuple(sorted(kw.items())))
    return dict(jstate=jstate, jstep=jstep, **_port_parts(jstate, **kw))


def _port_parts(jstate=None, **kw):
    """The port's state, geometry, batch, config and step. The state is
    carried over from `jstate`, or without it takes one warm-up step of
    its own (so the Adam moments are non-zero either way)."""
    raw, feats, embed, seg = _inputs()
    _, tcfg = _cfgs(**kw)
    tscene = scene_from_arrays(**_craw(raw), semantic_features=feats)
    cam = make_camera(W, H)
    vm, K = cam.viewmat.numpy(), cam.K.numpy()
    tstate = ttrain.create_train_state(tscene, tcfg, device="cpu")
    tgeom = ttrain.frozen_geometry(tscene)
    tb = prepare_binning(tgeom["means"], tgeom["quats"], tgeom["scales"], torch.as_tensor(vm),
                         torch.as_tensor(K), W, H, tcfg.raster, opacities=tgeom["opacities"])
    tbatch = dict(viewmat=torch.as_tensor(vm), K=torch.as_tensor(K),
                  img_embed=torch.as_tensor(embed), seg_map=torch.as_tensor(seg),
                  inst_gid=tb.inst_gid, tile_starts=tb.tile_starts, tile_counts=tb.tile_counts,
                  order=tb.order, red_slot=tb.red.slot_to_pos, red_rank=tb.red.slot_rank,
                  red_block=tb.red.chunk_block)
    tstep_fn = ttrain.make_train_step_binned(W, H, tcfg)

    def tstep(state, ew, rw):
        return tstep_fn(state, tgeom, tbatch, ew, rw)

    if jstate is None:
        tstep(tstate, 1e-3, 0.0)
    else:
        opt = {}
        for key, st in (("feat", jstate.opt_feat), ("dec", jstate.opt_dec),
                        ("scale", jstate.opt_scale)):
            adam = st[0]
            mu, nu = jax.tree.map(np.asarray, (adam.mu, adam.nu))
            opt[key] = (np.asarray(adam.count), mu, nu)
        load_jax_train_state(
            tstate, features=np.asarray(jstate.features),
            decoder_params=jax.tree.map(np.asarray, jstate.decoder_params),
            scale_params=jax.tree.map(np.asarray, jstate.scale_params),
            opt_states=opt, step=int(jstate.step))
    return dict(tstate=tstate, tstep=tstep, tgeom=tgeom, tbatch=tbatch, tcfg=tcfg)


def _flax_params_as_torch(params):
    out = {}
    for name, p in params["params"].items():
        out[f"{name}.weight"] = np.asarray(p["kernel"]).T
        out[f"{name}.bias"] = np.asarray(p["bias"])
    return out


@pytest.mark.parametrize("weights", [(1e-3, 0.0), (2e-3, 0.1)], ids=["early", "after_flip"])
def test_binned_steps_track_jax(weights):
    """Three binned steps from the same state: per-step loss terms at
    rtol 1e-4, then features and both decoders' parameters at atol 1e-5.
    "after_flip" uses the weights past the schedule switch (15001)."""
    ew, rw = weights
    jstate, jstep, tstate, tstep = _setup()
    assert tstate.step == int(jstate.step) == 1
    for _ in range(3):
        jstate, mj = jstep(jstate, ew, rw)
        tstate, mt = tstep(tstate, ew, rw)
        for k in METRICS:
            np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-4, atol=1e-7, err_msg=k)
    assert tstate.step == int(jstate.step) == 4
    if rw:
        assert float(mt["region_var"]) > 0
    np.testing.assert_allclose(tstate.features.detach().numpy(), np.asarray(jstate.features),
                               atol=1e-5)
    for module, params in ((tstate.decoder, jstate.decoder_params),
                           (tstate.scale_decoder, jstate.scale_params)):
        want = _flax_params_as_torch(params)
        for name, t in module.state_dict().items():
            np.testing.assert_allclose(t.numpy(), want[name], atol=1e-5, err_msg=name)


def test_every_parameter_group_updates():
    _, _, tstate, tstep = _setup()
    before = [tstate.features.detach().clone()] + [
        p.detach().clone() for m in (tstate.decoder, tstate.scale_decoder) for p in m.parameters()]
    tstate, m = tstep(tstate, 1e-3, 0.1)
    after = [tstate.features] + [p for mdl in (tstate.decoder, tstate.scale_decoder)
                                 for p in mdl.parameters()]
    assert float((after[0].detach() - before[0]).abs().max()) > 0
    assert any(float((a.detach() - b).abs().max()) > 0 for a, b in zip(after[1:10], before[1:10]))
    assert any(float((a.detach() - b).abs().max()) > 0 for a, b in zip(after[19:], before[19:]))
    assert int(m["overflow"]) == 0


def test_decoder_bf16_step_close_to_f32():
    """decoder_bf16 changes the decoders' compute type only: the step runs
    finite and lands within bf16 tolerance of the f32 step."""
    raw, feats, embed, seg = _inputs()
    losses = {}
    for bf16 in (False, True):
        _, tcfg = _cfgs(decoder_bf16=bf16)
        scene = scene_from_arrays(raw["means"], raw["quats"], np.log(raw["scales"]),
                                  np.log(raw["opacities"] / (1 - raw["opacities"])), raw["sh"],
                                  semantic_features=np.full((N, F), 0.1, np.float32))
        state = ttrain.create_train_state(scene, tcfg, seed=0, device="cpu")
        cam = make_camera(W, H)
        batch = dict(viewmat=cam.viewmat, K=cam.K, img_embed=torch.as_tensor(embed),
                     seg_map=torch.as_tensor(seg))
        step = ttrain.make_train_step(W, H, tcfg)
        _, m = step(state, ttrain.frozen_geometry(scene), batch, 1e-3, 0.0)
        losses[bf16] = float(m["loss"])
    assert np.isfinite(losses[True])
    np.testing.assert_allclose(losses[True], losses[False], rtol=3e-2)


def test_gad_config_roundtrip(tmp_path):
    cfg = ttrain.GadConfig(max_segments=1024, decoder_bf16=True,
                           raster=RasterizeConfig(tile_h=16, tile_w=16, budget_factor=2.5))
    cfg.save(str(tmp_path))
    assert ttrain.GadConfig.load(str(tmp_path)) == cfg
    # a JAX model dir's config loads too (unknown TPU switches are dropped)
    jtrain.GadConfig(max_segments=1024, raster=JConfig(tile_h=16, mxu_sigma=False)).save(
        str(tmp_path))
    back = ttrain.GadConfig.load(str(tmp_path), decoder_lr=2e-4)
    assert (back.max_segments, back.raster.tile_h, back.decoder_lr) == (1024, 16, 2e-4)
    assert ttrain.loss_weights(15000, back) == (1e-3, 0.0)
    assert ttrain.loss_weights(15001, back) == (2e-3, 0.1)


def test_create_train_state_defaults_to_cuda():
    """The state (and so every step, which runs where the state lives)
    defaults to the card; without one it raises instead of training on the
    CPU."""
    raw, feats, _, _ = _inputs()
    _, tcfg = _cfgs()
    scene = scene_from_arrays(raw["means"], raw["quats"], np.log(raw["scales"]),
                              np.log(raw["opacities"] / (1 - raw["opacities"])), raw["sh"],
                              semantic_features=feats)
    if torch.cuda.is_available():
        assert ttrain.create_train_state(scene, tcfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            ttrain.create_train_state(scene, tcfg)


def test_render_feature_map_decodes_the_rendered_map():
    raw, feats, _, _ = _inputs()
    _, tcfg = _cfgs()
    scene = scene_from_arrays(raw["means"], raw["quats"], np.log(raw["scales"]),
                              np.log(raw["opacities"] / (1 - raw["opacities"])), raw["sh"],
                              semantic_features=feats)
    state = ttrain.create_train_state(scene, tcfg, device="cpu")
    cam = make_camera(W, H)
    fmap = ttrain.render_feature_map(scene, state, cam.viewmat, cam.K, W, H, tcfg)
    dec = ttrain.render_feature_map(scene, state, cam.viewmat, cam.K, W, H, tcfg, decode=True)
    assert fmap.shape == (H, W, F) and dec.shape == (H, W, CLIP)
    assert float(fmap.abs().max()) > 0
    torch.testing.assert_close(dec, state.decoder(fmap).detach())
    norms = torch.linalg.norm(dec, dim=-1)
    torch.testing.assert_close(norms, torch.ones_like(norms), rtol=1e-5, atol=1e-5)


def test_autotune_returns_equivalent_step():
    """gags_torch.gad.autotune on the CPU (force=True): both candidates are
    timed, the winner is loss-equivalent to the base step (the tuner's
    gate, rtol 1e-3) and trains, and its step tracks the JAX step from the
    same state (rtol 1e-4 / atol 1e-7). Here rather than in
    test_torch_train_autotune.py so that it shares this file's JAX compile."""
    import copy
    import dataclasses

    from gags_torch.gad.autotune import autotune_train_step

    parts = _setup_parts()
    st, cfg, geom, batch = parts["tstate"], parts["tcfg"], parts["tgeom"], parts["tbatch"]
    ew = cfg.entropy_w_early
    times = {}
    win_cfg, win_step = autotune_train_step(W, H, cfg, st, geom, batch, k=1, force=True,
                                            verbose=False, times=times)
    assert set(times) == {"fsup=True", "fsup=False"}  # both candidates timed
    assert dataclasses.replace(win_cfg, fused_supervision=cfg.fused_supervision) == cfg
    before = st.features.detach().clone()
    st2 = copy.deepcopy(st)  # the tuner left the state as it found it
    _, m_base = ttrain.make_train_step_binned(W, H, cfg)(st, geom, batch, ew, 0.0)
    _, m_win = win_step(st2, geom, batch, ew, 0.0)
    base, win = float(m_base["loss"]), float(m_win["loss"])
    assert np.isfinite(win) and abs(win - base) / abs(base) <= 1e-3
    assert float((st2.features.detach() - before).abs().sum()) > 0  # the winner's step trains
    _, mj = parts["jstep"](parts["jstate"], ew, 0.0)
    np.testing.assert_allclose(win, float(mj["loss"]), rtol=1e-4, atol=1e-7)
