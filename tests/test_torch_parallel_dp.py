"""gags_torch.parallel.sharding (camera data parallelism on two gloo ranks)
against gags_tpu.parallel.sharding on a 2-device mesh, from one state.

The JAX references run once, in a module fixture; the port's ranks are
spawned once (parallel.launch: file rendezvous, a deadline) and run every
port-side step. JAX is imported inside the JAX-side functions only, so
the ranks, which import this module to find their function, load torch
alone."""

import numpy as np
import pytest
import torch

from gags_torch.gad import train as ttrain
from gags_torch.models.weights import load_jax_train_state, scene_from_arrays
from gags_torch.parallel import make_dp_render, make_dp_train_step, make_mesh
from gags_torch.parallel.launch import spawn
from gags_torch.parallel.sharding import train_params
from gags_torch.splat.rasterizer import RasterizeConfig, prepare_binning, rasterize
from gags_torch.utils.synthetic import make_camera, make_scene

W, H, N, F, CLIP, M = 32, 16, 60, 8, 16, 5
TILE = dict(tile_h=8, tile_w=16, chunk=8)
WEIGHTS = (2e-3, 0.1)  # past the schedule switch: the region variance counts
BINNED_KEYS = ("inst_gid", "tile_starts", "tile_counts", "order", "red_slot", "red_rank",
               "red_block")


def _inputs():
    raw = make_scene(N, seed=0)
    rng = np.random.default_rng(1)
    feats = (0.1 * rng.normal(size=(N, F))).astype(np.float32)
    emb = rng.normal(size=(4, M, CLIP)).astype(np.float32)
    seg = rng.integers(-1, M, size=(4, H, W, 4)).astype(np.int32)
    cams = [make_camera(W, H, dist=0.1 * i) for i in range(4)]
    vms = np.stack([c.viewmat.numpy() for c in cams])
    Ks = np.stack([c.K.numpy() for c in cams])
    return raw, feats, emb, seg, vms, Ks


def _craw(raw):
    return dict(means=raw["means"], quats=raw["quats"], scales_raw=np.log(raw["scales"]),
                opacities_raw=np.log(raw["opacities"] / (1 - raw["opacities"])), sh=raw["sh"])


def _render_cfg():
    return dict(TILE, aligned=False, budget_factor=8)


def _flax_as_torch(params):
    out = {}
    for name, p in params["params"].items():
        out[f"{name}.weight"] = np.asarray(p["kernel"]).T
        out[f"{name}.bias"] = np.asarray(p["bias"])
    return out


# ---------------------------------------------------------------- JAX side


def _plain(tree):
    """A parameter tree as nested dicts of numpy arrays (the ranks unpickle
    it without JAX or flax)."""
    if hasattr(tree, "items"):
        return {k: _plain(v) for k, v in tree.items()}
    return np.asarray(tree)


def jax_state_arrays(jstate, n=None):
    """A JAX GAD TrainState as numpy: load_jax_train_state's arguments
    (the first n rows of the per-Gaussian arrays where n is given)."""
    rows = slice(None) if n is None else slice(0, n)
    opt = {}
    for key, st in (("feat", jstate.opt_feat), ("dec", jstate.opt_dec),
                    ("scale", jstate.opt_scale)):
        adam = st[0]
        mu, nu = _plain(adam.mu), _plain(adam.nu)
        if key == "feat":
            mu, nu = mu[rows], nu[rows]
        opt[key] = (np.asarray(adam.count), mu, nu)
    return dict(features=np.asarray(jstate.features)[rows],
                decoder_params=_plain(jstate.decoder_params),
                scale_params=_plain(jstate.scale_params),
                opt_states=opt, step=int(jstate.step))


def jax_params(jstate, n=N):
    """The first n rows of the features, and both decoders as state dicts."""
    return dict(features=np.asarray(jstate.features)[:n],
                decoder=_flax_as_torch(jstate.decoder_params),
                scale_decoder=_flax_as_torch(jstate.scale_params))


@pytest.fixture(scope="module")
def jax_ref():
    import jax
    import jax.numpy as jnp

    from gags_tpu.gad import train as jtrain
    from gags_tpu.parallel import make_dp_render as jrender
    from gags_tpu.parallel import make_dp_train_step as jdp_step
    from gags_tpu.parallel import make_mesh as jmesh
    from gags_tpu.scene.gaussian_data import GaussianScene
    from gags_tpu.splat.rasterizer import RasterizeConfig as JConfig
    from gags_tpu.splat.rasterizer import prepare_binning as jprepare

    raw, feats, emb, seg, vms, Ks = _inputs()
    jcfg = jtrain.GadConfig(feature_dim=F, clip_dim=CLIP, max_segments=16,
                            raster=JConfig(**TILE, interpret=True))
    jscene = GaussianScene(**{k: jnp.asarray(v) for k, v in _craw(raw).items()},
                           semantic_features=jnp.asarray(feats))
    state0, statics = jtrain.create_train_state(jscene, jax.random.PRNGKey(0), jcfg)
    geom = jtrain.frozen_geometry(jscene)
    mesh = jmesh(2)
    ew, rw = (jnp.float32(w) for w in WEIGHTS)

    def batch(idx, binned):
        b = dict(viewmat=jnp.asarray(vms[idx]), K=jnp.asarray(Ks[idx]),
                 img_embed=jnp.asarray(emb[idx]), seg_map=jnp.asarray(seg[idx]))
        if binned:
            bins = [jprepare(geom["means"], geom["quats"], geom["scales"], jnp.asarray(vms[i]),
                             jnp.asarray(Ks[i]), W, H, jcfg.raster,
                             opacities=geom["opacities"]) for i in idx]
            fields = dict(inst_gid=lambda x: x.inst_gid, tile_starts=lambda x: x.tile_starts,
                          tile_counts=lambda x: x.tile_counts, order=lambda x: x.order,
                          red_slot=lambda x: x.red.slot_to_pos,
                          red_rank=lambda x: x.red.slot_rank,
                          red_block=lambda x: x.red.chunk_block)
            b.update({k: jnp.stack([f(x) for x in bins]) for k, f in fields.items()})
        return b

    out = dict(init=jax_state_arrays(state0))
    for binned in (False, True):
        step = jdp_step(mesh, statics, W, H, jcfg, binned=binned)
        s, losses, b = state0, [], batch([0, 1], binned)
        for _ in range(2):
            s, loss = step(s, geom, b, ew, rw)
            losses.append(float(loss))
        out["binned" if binned else "unbinned"] = dict(losses=losses, **jax_params(s))
    s, loss = jdp_step(mesh, statics, W, H, jcfg)(state0, geom, batch([0, 1, 2, 3], False),
                                                   ew, rw)
    out["b4"] = dict(losses=[float(loss)], **jax_params(s))
    render = jrender(mesh, W, H, JConfig(**_render_cfg(), interpret=True))
    imgs, alphas = render(geom, jnp.asarray(feats), jnp.asarray(vms), jnp.asarray(Ks),
                          jnp.zeros((F,), jnp.float32))
    out["render"] = (np.asarray(imgs), np.asarray(alphas))
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


def _params(state):
    return dict(features=state.features.detach().clone(),
                decoder={k: v.clone() for k, v in state.decoder.state_dict().items()},
                scale_decoder={k: v.clone() for k, v in state.scale_decoder.state_dict().items()})


def _port_batch(geom, cfg, idx, binned):
    _, _, emb, seg, vms, Ks = _inputs()
    b = dict(viewmat=torch.as_tensor(vms[idx]), K=torch.as_tensor(Ks[idx]),
             img_embed=torch.as_tensor(emb[idx]), seg_map=torch.as_tensor(seg[idx]))
    if binned:
        bins = [prepare_binning(geom["means"], geom["quats"], geom["scales"],
                                torch.as_tensor(vms[i]), torch.as_tensor(Ks[i]), W, H,
                                cfg.raster, opacities=geom["opacities"]) for i in idx]
        fields = [(x.inst_gid, x.tile_starts, x.tile_counts, x.order, x.red.slot_to_pos,
                   x.red.slot_rank, x.red.chunk_block) for x in bins]
        b.update({k: torch.stack([f[j] for f in fields]) for j, k in enumerate(BINNED_KEYS)})
    return b


def port_ranks(ctx, init):
    """Every port-side run of this file, on each of two ranks."""
    mesh = make_mesh()
    r = ctx.rank
    out = {}
    for binned in (False, True):
        state, geom, cfg = _port_state(init)
        step = make_dp_train_step(mesh, W, H, cfg, binned=binned)
        b = _port_batch(geom, cfg, [r], binned)
        losses = [float(step(state, geom, b, *WEIGHTS)[1]["loss"]) for _ in range(2)]
        out["binned" if binned else "unbinned"] = dict(losses=losses, **_params(state))
    state, geom, cfg = _port_state(init)
    _, m = make_dp_train_step(mesh, W, H, cfg)(state, geom,
                                               _port_batch(geom, cfg, [2 * r, 2 * r + 1], False),
                                               *WEIGHTS)
    out["b4"] = dict(losses=[float(m["loss"])], **_params(state))

    # the reduced gradients of one step, and (rank 0) the same two cameras
    # accumulated in this one process and halved
    state, geom, cfg = _port_state(init)
    make_dp_train_step(mesh, W, H, cfg)(state, geom, _port_batch(geom, cfg, [r], False),
                                        *WEIGHTS)
    out["dp_grads"] = [p.grad.clone() for p in train_params(state)]
    if r == 0:
        state, geom, cfg = _port_state(init)
        for i in (0, 1):
            cam = {k: v[0] for k, v in _port_batch(geom, cfg, [i], False).items()}
            ttrain.camera_loss(state, geom, cam, *WEIGHTS, W, H, cfg)[0].backward()
        out["one_process_grads"] = [p.grad / 2 for p in train_params(state)]

    raw, feats, _, _, vms, Ks = _inputs()
    rcfg = RasterizeConfig(**_render_cfg())
    geom = {k: torch.as_tensor(raw[k]) for k in ("means", "quats", "scales", "opacities")}
    colors, bg = torch.as_tensor(feats), torch.zeros(F)
    out["render"] = make_dp_render(mesh, W, H, rcfg)(geom, colors, torch.as_tensor(vms),
                                                     torch.as_tensor(Ks), bg)
    seq = [rasterize(geom["means"], geom["quats"], geom["scales"], geom["opacities"], colors,
                     torch.as_tensor(vms[i]), torch.as_tensor(Ks[i]), W, H, background=bg,
                     config=rcfg, device="cpu") for i in range(4)]
    out["sequential"] = (torch.stack([s.image for s in seq]), torch.stack([s.alpha for s in seq]))
    return out


@pytest.fixture(scope="module")
def ranks(jax_ref):
    return [r.result for r in spawn(port_ranks, 2, "gloo", "cpu", args=(jax_ref["init"],),
                                    deadline=240)]


# ---------------------------------------------------------------- tests


def _assert_tracks(port, ref):
    """The port-vs-JAX step tolerances of tests/test_torch_train_step.py."""
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(port["features"].numpy(), ref["features"], atol=1e-5)
    for mod in ("decoder", "scale_decoder"):
        for name, t in port[mod].items():
            np.testing.assert_allclose(t.numpy(), ref[mod][name], atol=1e-5, err_msg=name)


@pytest.mark.parametrize("path", ["unbinned", "binned"])
def test_dp_steps_track_jax(ranks, jax_ref, path):
    """Two data-parallel steps (one camera a rank) against
    make_dp_train_step on make_mesh(2): the loss of each step, then the
    features and both decoders; both ranks hold the same state."""
    _assert_tracks(ranks[0][path], jax_ref[path])
    for k in ("features",):
        assert torch.equal(ranks[0][path][k], ranks[1][path][k])


def test_dp_two_cameras_a_rank_track_jax_scan(ranks, jax_ref):
    """B = 4 over two ranks: each accumulates its two cameras' gradients
    and divides by 2 before the all_reduce, as JAX's lax.scan does."""
    _assert_tracks(ranks[0]["b4"], jax_ref["b4"])


def test_dp_gradients_equal_one_process_mean(ranks):
    """At world 2 the all_reduce is one addition: the reduced gradients of
    every parameter equal one process's (g0 + g1) / 2 bit for bit."""
    for got, want in zip(ranks[0]["dp_grads"], ranks[0]["one_process_grads"]):
        assert torch.equal(got, want)
    for a, b in zip(ranks[0]["dp_grads"], ranks[1]["dp_grads"]):
        assert torch.equal(a, b)


def test_dp_render_matches_jax_and_sequential(ranks, jax_ref):
    """Four cameras on two ranks: JAX's make_dp_render at the unaligned
    path's tolerance (2e-4, tests/test_gshard.py), and the port's own
    sequential renders bit for bit."""
    imgs, alphas = ranks[0]["render"]
    assert imgs.shape == (4, H, W, F) and alphas.shape == (4, H, W)
    np.testing.assert_allclose(imgs.numpy(), jax_ref["render"][0], atol=2e-4)
    np.testing.assert_allclose(alphas.numpy(), jax_ref["render"][1], atol=2e-4)
    assert torch.equal(imgs, ranks[0]["sequential"][0])
    assert torch.equal(alphas, ranks[0]["sequential"][1])
    assert torch.equal(imgs, ranks[1]["render"][0])
