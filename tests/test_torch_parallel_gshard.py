"""gags_torch.parallel.gshard (Gaussian-sharded features, tile-strip
rasterization) on gloo ranks against gags_tpu.parallel.gshard, against
the port's one-process rasterizer and step, and against the port's own
data-parallel step.

H = 32 is a multiple of world * tile_h at worlds 2 and 4, so the JAX
strips have no pad rows (ROADMAP.md §3, F2). The JAX references run once
in a module fixture; each rank group (world 2, world 4) is spawned once.
JAX is imported inside the JAX-side functions only."""

import numpy as np
import pytest
import torch

from gags_torch.gad import train as ttrain
from gags_torch.models.weights import load_jax_train_state, scene_from_arrays
from gags_torch.parallel import (gshard_state, make_dp_gshard_train_step, make_dp_train_step,
                                 make_gshard_render, make_gshard_train_step, make_mesh,
                                 make_mesh2d, shard_gaussians)
from gags_torch.parallel.collectives import all_gather_tensor
from gags_torch.parallel.launch import spawn
from gags_torch.splat.rasterizer import RasterizeConfig, rasterize
from gags_torch.utils.synthetic import make_camera, make_scene

N, W, H, F, CLIP, M = 75, 32, 32, 8, 16, 6
N_EVEN = 72  # divisible by 2 and 4
TILE = dict(tile_h=4, tile_w=16, chunk=8)
WEIGHTS = (1e-3, 0.1)


def _inputs(n=N):
    raw = make_scene(n, seed=0)
    feats = np.random.default_rng(3).normal(size=(n, F)).astype(np.float32)
    rng = np.random.default_rng(1)
    emb = rng.normal(size=(2, M, CLIP)).astype(np.float32)
    seg = rng.integers(-1, M, size=(2, H, W, 4)).astype(np.int32)
    cams = [make_camera(W, H, dist=0.15 * i) for i in range(2)]
    return (raw, feats, emb, seg, np.stack([c.viewmat.numpy() for c in cams]),
            np.stack([c.K.numpy() for c in cams]))


def _craw(raw):
    return dict(means=raw["means"], quats=raw["quats"], scales_raw=np.log(raw["scales"]),
                opacities_raw=np.log(raw["opacities"] / (1 - raw["opacities"])), sh=raw["sh"])


# ---------------------------------------------------------------- JAX side


@pytest.fixture(scope="module")
def jax_ref():
    import jax
    import jax.numpy as jnp
    from test_torch_parallel_dp import jax_params, jax_state_arrays

    from gags_tpu.gad import train as jtrain
    from gags_tpu.parallel import (gshard_state as jgshard_state,
                                   make_dp_gshard_train_step as jdp_gshard,
                                   make_gshard_train_step as jgshard_step,
                                   make_mesh as jmesh, make_mesh2d as jmesh2d,
                                   pad_seg_map as jpad, shard_gaussians as jshard)
    from gags_tpu.scene.gaussian_data import GaussianScene
    from gags_tpu.splat.rasterizer import RasterizeConfig as JConfig
    from gags_tpu.splat.rasterizer import rasterize as jrasterize

    rcfg = JConfig(**TILE, interpret=True)
    out = {"render": {}}
    for n in (N, N_EVEN):
        raw, feats = _inputs(n)[:2]
        geom = {k: jnp.asarray(raw[k]) for k in ("means", "quats", "scales", "opacities")}
        res = jrasterize(geom["means"], geom["quats"], geom["scales"], geom["opacities"],
                         jnp.asarray(feats), jnp.asarray(_inputs(n)[4][0]),
                         jnp.asarray(_inputs(n)[5][0]), W, H,
                         background=jnp.zeros((F,)), config=rcfg)
        out["render"][n] = (np.asarray(res.image), np.asarray(res.alpha))

    raw, feats, emb, seg, vms, Ks = _inputs()
    jcfg = jtrain.GadConfig(feature_dim=F, clip_dim=CLIP, max_segments=16, raster=rcfg)
    jscene = GaussianScene(**{k: jnp.asarray(v) for k, v in _craw(raw).items()},
                           semantic_features=jnp.asarray(feats))
    state0, statics = jtrain.create_train_state(jscene, jax.random.PRNGKey(0), jcfg)
    geom = jtrain.frozen_geometry(jscene)
    out["init"] = jax_state_arrays(state0)
    ew, rw = (jnp.float32(w) for w in WEIGHTS)
    step = jtrain.make_train_step(statics, W, H, jcfg)
    batch = dict(viewmat=jnp.asarray(vms[0]), K=jnp.asarray(Ks[0]),
                 img_embed=jnp.asarray(emb[0]), seg_map=jnp.asarray(seg[0]))
    s, runs = state0, []
    for _ in range(2):
        s, m = step(s, geom, batch, ew, rw)
        runs.append(dict(losses=[float(m["loss"])], **jax_params(s, N)))
    out["single"] = runs
    for world in (2, 4):
        mesh = jmesh(world)
        geom_s, _ = jshard(geom, state0.features, mesh)
        s = jgshard_state(state0, mesh)
        step = jgshard_step(mesh, statics, W, H, jcfg, s)
        batch = dict(viewmat=jnp.asarray(vms[0]), K=jnp.asarray(Ks[0]),
                     img_embed=jnp.asarray(emb[0]), seg_map=jnp.asarray(jpad(seg[0], mesh, rcfg)))
        runs = []
        for _ in range(2):
            s, loss, ovf = step(s, geom_s, batch, ew, rw)
            assert int(ovf) == 0
            runs.append(dict(losses=[float(loss)], **jax_params(s, N)))
        out[f"gshard{world}"] = runs
    mesh = jmesh2d(2, 2)
    geom_s, _ = jshard(geom, state0.features, mesh, axis="gs")
    s = jgshard_state(state0, mesh, axis="gs")
    seg_pad = np.stack([jpad(seg[i], mesh, rcfg, axis="gs") for i in range(2)])
    s, loss, ovf = jdp_gshard(mesh, statics, W, H, jcfg, s)(
        s, geom_s, dict(viewmat=jnp.asarray(vms), K=jnp.asarray(Ks), img_embed=jnp.asarray(emb),
                        seg_map=jnp.asarray(seg_pad)), ew, rw)
    assert int(ovf) == 0
    out["dp_gshard"] = dict(losses=[float(loss)], **jax_params(s, N))
    return out


# ---------------------------------------------------------------- the ranks


def _port_state(init):
    raw, feats = _inputs()[:2]
    cfg = ttrain.GadConfig(feature_dim=F, clip_dim=CLIP, max_segments=16,
                           raster=RasterizeConfig(**TILE))
    scene = scene_from_arrays(**_craw(raw), semantic_features=feats)
    state = ttrain.create_train_state(scene, cfg, device="cpu")
    load_jax_train_state(state, **init)
    return state, ttrain.frozen_geometry(scene), cfg


def _camera(i):
    _, _, emb, seg, vms, Ks = _inputs()
    return dict(viewmat=torch.as_tensor(vms[i]), K=torch.as_tensor(Ks[i]),
                img_embed=torch.as_tensor(emb[i]), seg_map=torch.as_tensor(seg[i]))


def _gathered(state, mesh, axis):
    """Full features (N, F) of a GShardState, and both decoders."""
    g = mesh.groups[axis]
    return dict(features=all_gather_tensor(state.features.detach(), g)[:N],
                decoder={k: v.clone() for k, v in state.decoder.state_dict().items()},
                scale_decoder={k: v.clone() for k, v in state.scale_decoder.state_dict().items()})


def _grads(state, mesh, axis):
    g = mesh.groups[axis]
    return ([all_gather_tensor(state.features.grad, g)[:N]]
            + [p.grad.clone() for p in list(state.decoder.parameters())
               + list(state.scale_decoder.parameters())])


def _gshard_steps(init, mesh, budget_slack=2.0, steps=2):
    state, geom, cfg = _port_state(init)
    geom_l, _ = shard_gaussians(geom, state.features, mesh)
    gs = gshard_state(state, mesh)
    step = make_gshard_train_step(mesh, W, H, cfg, budget_slack=budget_slack)
    runs = []
    for _ in range(steps):
        gs, m = step(gs, geom_l, _camera(0), *WEIGHTS)
        runs.append(dict(losses=[float(m["loss"])], overflow=int(m["overflow"]),
                         grads=_grads(gs, mesh, "dp"), **_gathered(gs, mesh, "dp")))
    return runs


def ranks_world2(ctx, init):
    mesh = make_mesh()
    out = {"render": {}}
    for n in (N, N_EVEN):
        raw, feats, _, _, vms, Ks = _inputs(n)
        geom = {k: torch.as_tensor(raw[k]) for k in ("means", "quats", "scales", "opacities")}
        geom_l, feats_l = shard_gaussians(geom, torch.as_tensor(feats), mesh)
        cfg = RasterizeConfig(**TILE)
        img, alpha, ovf = make_gshard_render(mesh, W, H, F, cfg)(
            geom_l, feats_l, torch.as_tensor(vms[0]), torch.as_tensor(Ks[0]))
        one = rasterize(geom["means"], geom["quats"], geom["scales"], geom["opacities"],
                        torch.as_tensor(feats), torch.as_tensor(vms[0]), torch.as_tensor(Ks[0]),
                        W, H, config=RasterizeConfig(**TILE, aligned=False), device="cpu")
        out["render"][n] = dict(img=img, alpha=alpha, overflow=int(ovf), one=one.image,
                                one_alpha=one.alpha)
    out["gshard"] = _gshard_steps(init, mesh)
    out["starved"] = _gshard_steps(init, mesh, budget_slack=1e-6, steps=1)[0]["overflow"]
    # the one-process step and the port's data-parallel step, same state
    state, geom, cfg = _port_state(init)
    _, m = ttrain.make_train_step(W, H, cfg)(state, geom, _camera(0), *WEIGHTS)
    out["one_process"] = dict(loss=float(m["loss"]), grads=[
        p.grad.clone() for p in [state.features] + list(state.decoder.parameters())
        + list(state.scale_decoder.parameters())])
    state, geom, cfg = _port_state(init)
    batch = {k: v[None] for k, v in _camera(ctx.rank).items()}
    _, m = make_dp_train_step(mesh, W, H, cfg)(state, geom, batch, *WEIGHTS)
    out["dp"] = dict(losses=[float(m["loss"])], features=state.features.detach().clone(),
                     decoder=state.decoder.state_dict(),
                     scale_decoder=state.scale_decoder.state_dict())
    return out


def ranks_world4(ctx, init):
    out = dict(gshard=_gshard_steps(init, make_mesh()))
    mesh = make_mesh2d(2, 2)
    state, geom, cfg = _port_state(init)
    geom_l, _ = shard_gaussians(geom, state.features, mesh, axis="gs")
    gs = gshard_state(state, mesh, axis="gs")
    gs, m = make_dp_gshard_train_step(mesh, W, H, cfg)(gs, geom_l, _camera(mesh.coords["dp"]),
                                                       *WEIGHTS)
    out["dp_gshard"] = dict(losses=[float(m["loss"])], overflow=int(m["overflow"]),
                            **_gathered(gs, mesh, "gs"))
    return out


@pytest.fixture(scope="module")
def world2(jax_ref):
    return [r.result for r in spawn(ranks_world2, 2, "gloo", "cpu", args=(jax_ref["init"],),
                                    deadline=240)]


@pytest.fixture(scope="module")
def world4(jax_ref):
    return [r.result for r in spawn(ranks_world4, 4, "gloo", "cpu", args=(jax_ref["init"],),
                                    deadline=240)]


# ---------------------------------------------------------------- tests


def _assert_tracks(port, ref, atol=1e-5, decoders=True):
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(port["features"].numpy(), ref["features"], atol=atol)
    for mod in ("decoder", "scale_decoder") if decoders else ():
        for name, t in port[mod].items():
            np.testing.assert_allclose(t.numpy(), ref[mod][name], atol=atol, err_msg=name)


@pytest.mark.parametrize("n", [N, N_EVEN], ids=["uneven_n", "even_n"])
def test_gshard_render_matches_single_device(world2, jax_ref, n):
    """Two strips, N not divisible by the world (pad Gaussians must not
    render) and divisible: JAX's one-device rasterize at atol 2e-4
    (tests/test_gshard.py), the port's one-process unaligned render at
    2e-6 (the y-shift of the strip rounds the means)."""
    r = world2[0]["render"][n]
    assert r["overflow"] == 0 and r["img"].shape == (H, W, F)
    np.testing.assert_allclose(r["img"].numpy(), jax_ref["render"][n][0], atol=2e-4)
    np.testing.assert_allclose(r["alpha"].numpy(), jax_ref["render"][n][1], atol=2e-4)
    np.testing.assert_allclose(r["img"].numpy(), r["one"].numpy(), atol=2e-6)
    np.testing.assert_allclose(r["alpha"].numpy(), r["one_alpha"].numpy(), atol=2e-6)
    assert torch.equal(r["img"], world2[1]["render"][n]["img"])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("steps", [1, 2])
def test_gshard_steps_track_jax(world2, world4, jax_ref, world, steps):
    """The 1-D step after 1 and 2 steps, at the port-vs-JAX step
    tolerances (loss rtol 1e-4, features and decoders atol 1e-5), overflow
    0: loss and features against make_gshard_train_step on
    make_mesh(world); loss, features and decoders against JAX's one-device
    make_train_step. JAX's strip step scales its gradients by the strip
    count (F1), which the decoders' Adam eps (1e-8) turns into up to 3.3e-5
    of drift from its own one-device step (test_torch_gshard_faults.py);
    the features' eps (1e-15) hides it."""
    run = (world2 if world == 2 else world4)[0]["gshard"][steps - 1]
    assert run["overflow"] == 0
    _assert_tracks(run, jax_ref[f"gshard{world}"][steps - 1], decoders=False)
    _assert_tracks(run, jax_ref["single"][steps - 1])


def test_dp_gshard_step_tracks_jax_and_dp(world2, world4, jax_ref):
    """dp 2 x gs 2 on four ranks against make_dp_gshard_train_step on
    make_mesh2d(2, 2) (atol 5e-5, as tests/test_gshard.py: the sums run in
    another order) and against the port's own two-rank data-parallel step
    on the same two cameras (atol 1e-6)."""
    got = world4[0]["dp_gshard"]
    assert got["overflow"] == 0
    _assert_tracks(got, jax_ref["dp_gshard"], atol=5e-5)
    dp = world2[0]["dp"]
    np.testing.assert_allclose(got["losses"], dp["losses"], rtol=1e-6)
    np.testing.assert_allclose(got["features"].numpy(), dp["features"].numpy(), atol=1e-6)
    for mod in ("decoder", "scale_decoder"):
        for name, t in got[mod].items():
            np.testing.assert_allclose(t.numpy(), dp[mod][name].numpy(), atol=1e-6)
    for r in world4[1:]:
        assert torch.equal(r["dp_gshard"]["features"], got["features"])


def test_gshard_reports_overflow(world2):
    """A starved strip budget (budget_slack 1e-6: the 4 * chunk floor)
    surfaces as a non-zero overflow on every rank."""
    assert world2[0]["starved"] > 0 and world2[1]["starved"] == world2[0]["starved"]


def test_gshard_gradients_equal_one_process(world2):
    """The raw gradients after the reduce_scatter (features) and the strip
    sum (decoders) are the one-process step's: rtol 1e-5 (K3 and K4 sum per
    strip, so the sums run in another order), atol 1e-6 of each tensor's
    largest entry. The losses agree to rtol 1e-6."""
    got = world2[0]["gshard"][0]
    want = world2[0]["one_process"]
    np.testing.assert_allclose(got["losses"][0], want["loss"], rtol=1e-6)
    for g, w in zip(got["grads"], want["grads"]):
        scale = float(w.abs().max())
        assert scale > 0
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-6 * scale)
