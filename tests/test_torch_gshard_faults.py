"""Two faults of gags_tpu.parallel.gshard that the port leaves out
(ROADMAP.md §3), each shown against the JAX function itself.

F1: the JAX strip step differentiates inside shard_map(check_vma=False),
where the transpose of psum is psum, so every gradient comes out scaled by
the strip count. With optax.sgd(1.0) as the three transforms the update is
minus the gradient: on make_mesh(4) the JAX step moves the parameters by
4x its own one-device gradient; the port's raw gradients are 1x.

F2: at H not a multiple of world * tile_h the JAX strips carry pad rows
below the image, and they enter its loss (the entropy mean, the region
variance's H * W); the port's strip loss is its one-process loss.

JAX is imported inside the JAX-side functions only, so the ranks load
torch alone."""

import dataclasses

import numpy as np
import pytest
import torch

from gags_torch.gad import train as ttrain
from gags_torch.parallel import gshard_state, make_gshard_train_step, make_mesh, shard_gaussians
from gags_torch.parallel.collectives import all_gather_tensor
from gags_torch.parallel.launch import spawn
from gags_torch.utils.synthetic import make_camera

from test_torch_parallel_gshard import CLIP, F, M, N, TILE, W, WEIGHTS, _craw, _port_state
from test_torch_parallel_gshard import _inputs as _scene_inputs

H1 = 32  # F1: four strips of 8 rows, no pad rows
H2 = 20  # F2: two strips of 12 rows (24), four pad rows


def _inputs(h, zero_features):
    raw, feats, emb = _scene_inputs()[:3]
    cam = make_camera(W, h)
    seg = np.random.default_rng(5).integers(-1, M, size=(h, W, 4)).astype(np.int32)
    if zero_features:  # a zero feature's sgd update is exactly -grad
        feats = np.zeros_like(feats)
    return raw, feats, emb[0], seg, cam.viewmat.numpy(), cam.K.numpy()


def _ratio(a, b):
    """The least-squares factor k of a ~ k b."""
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (b @ b))


@pytest.fixture(scope="module")
def jax_ref():
    import jax
    import jax.numpy as jnp
    import optax
    from test_torch_parallel_dp import _flax_as_torch, _plain

    from gags_tpu.gad import train as jtrain
    from gags_tpu.parallel import gshard_state as jgshard_state
    from gags_tpu.parallel import make_gshard_train_step as jgshard_step
    from gags_tpu.parallel import make_mesh as jmesh
    from gags_tpu.parallel import pad_seg_map as jpad
    from gags_tpu.parallel import shard_gaussians as jshard
    from gags_tpu.scene.gaussian_data import GaussianScene
    from gags_tpu.splat.rasterizer import RasterizeConfig as JConfig

    rcfg = JConfig(**TILE, interpret=True)
    jcfg = jtrain.GadConfig(feature_dim=F, clip_dim=CLIP, max_segments=16, raster=rcfg)
    ew, rw = (jnp.float32(w) for w in WEIGHTS)
    sgd = optax.sgd(1.0)
    out = {}
    for fault, h, world in (("F1", H1, 4), ("F2", H2, 2)):
        raw, feats, emb, seg, vm, K = _inputs(h, zero_features=fault == "F1")
        jscene = GaussianScene(**{k: jnp.asarray(v) for k, v in _craw(raw).items()},
                               semantic_features=jnp.asarray(feats))
        state0, statics = jtrain.create_train_state(jscene, jax.random.PRNGKey(0), jcfg)
        if fault == "F1":
            statics = dict(statics, tx_feat=sgd, tx_dec=sgd, tx_scale=sgd)
            state0 = dataclasses.replace(
                state0, opt_feat=sgd.init(state0.features),
                opt_dec=sgd.init(state0.decoder_params), opt_scale=sgd.init(state0.scale_params))
        geom = jtrain.frozen_geometry(jscene)
        batch = dict(viewmat=jnp.asarray(vm), K=jnp.asarray(K), img_embed=jnp.asarray(emb),
                     seg_map=jnp.asarray(seg))
        s1, m1 = jtrain.make_train_step(statics, W, h, jcfg)(state0, geom, batch, ew, rw)
        mesh = jmesh(world)
        geom_s, _ = jshard(geom, state0.features, mesh)
        gs = jgshard_state(state0, mesh)
        s2, loss2, ovf = jgshard_step(mesh, statics, W, h, jcfg, gs)(
            gs, geom_s, dict(batch, seg_map=jnp.asarray(jpad(seg, mesh, rcfg))), ew, rw)
        assert int(ovf) == 0

        def delta(s):  # what the update moved each parameter by, by torch name
            out = {"features": np.asarray(s.features)[:N] - np.asarray(state0.features)}
            for mod, new, old in (("decoder", s.decoder_params, state0.decoder_params),
                                  ("scale_decoder", s.scale_params, state0.scale_params)):
                new, old = _flax_as_torch(new), _flax_as_torch(old)
                out.update({f"{mod}.{k}": new[k] - old[k] for k in new})
            return out

        out[fault] = dict(
            loss1=float(m1["loss"]), loss_strips=float(loss2), delta1=delta(s1),
            delta_strips=delta(s2),
            init=dict(features=np.asarray(state0.features),
                      decoder_params=_plain(state0.decoder_params),
                      scale_params=_plain(state0.scale_params)))
    return out


def fault_ranks(ctx, init, h, zero_features):
    """The port's strip step (raw gradients gathered) and, on rank 0, its
    one-process step, from one state, at height h."""
    _, _, emb, seg, vm, K = _inputs(h, zero_features)
    state, geom, cfg = _port_state(init)
    batch = dict(viewmat=torch.as_tensor(vm), K=torch.as_tensor(K),
                 img_embed=torch.as_tensor(emb), seg_map=torch.as_tensor(seg))
    mesh = make_mesh()
    geom_l, _ = shard_gaussians(geom, state.features, mesh)
    gs = gshard_state(state, mesh)
    gs, m = make_gshard_train_step(mesh, W, h, cfg)(gs, geom_l, batch, *WEIGHTS)
    out = dict(loss=float(m["loss"]), overflow=int(m["overflow"]),
               grads=_grads(gs, all_gather_tensor(gs.features.grad)[:N]))
    if ctx.rank == 0:
        _, m1 = ttrain.make_train_step(W, h, cfg)(state, geom, batch, *WEIGHTS)
        out.update(one_loss=float(m1["loss"]), one_grads=_grads(state, state.features.grad))
    return out


def _grads(state, features_grad):
    """Every gradient of a state, named as `delta` names the JAX moves."""
    out = {"features": features_grad}
    for mod in ("decoder", "scale_decoder"):
        out.update({f"{mod}.{k}": p.grad for k, p in getattr(state, mod).named_parameters()})
    return out


@pytest.fixture(scope="module")
def port(jax_ref):
    return {fault: [r.result for r in spawn(fault_ranks, world, "gloo", "cpu",
                                            args=(jax_ref[fault]["init"], h, fault == "F1"),
                                            deadline=240)]
            for fault, h, world in (("F1", H1, 4), ("F2", H2, 2))}


def test_f1_jax_strip_gradients_scale_with_strip_count(jax_ref, port):
    """F1 on make_mesh(4), sgd(1.0): JAX's strip step moves the features
    by 4x its one-device step (rtol 1e-5, atol 1e-6 of the largest; the
    features start at 0, so both moves are exact negated gradients) and
    every decoder tensor by 4x (least-squares factor within 1e-3: the
    decoders' moves round at their values' scale). The port's raw
    gradients are JAX's one-device gradient, 1x (rtol 1e-4 / factor within
    1e-3), and its loss is JAX's one-device loss."""
    ref = jax_ref["F1"]
    d1, d4 = ref["delta1"], ref["delta_strips"]
    scale = np.abs(d1["features"]).max()
    assert scale > 0
    np.testing.assert_allclose(d4["features"], 4 * d1["features"], rtol=1e-5, atol=1e-6 * scale)
    got = port["F1"][0]
    assert got["overflow"] == 0
    np.testing.assert_allclose(got["loss"], ref["loss1"], rtol=1e-4)
    np.testing.assert_allclose(-got["grads"]["features"].numpy(), d1["features"], rtol=1e-4,
                               atol=1e-6 * scale)
    moved = [k for k in d1 if k != "features" and np.abs(d1[k]).max() > 0]
    assert len(moved) > 10
    for k in moved:
        assert abs(_ratio(d4[k], d1[k]) - 4.0) < 4e-3, k
        assert abs(_ratio(-got["grads"][k].numpy(), d1[k]) - 1.0) < 1e-3, k


def test_f2_pad_rows_enter_jax_strip_loss(jax_ref, port):
    """F2 at H = 20 on two strips (24 rows, 4 of them pad): the port's
    strip loss equals its one-process loss (rtol 1e-6) and so do its raw
    gradients (rtol 1e-5, atol 1e-6 of the largest); JAX's strip loss
    misses its own one-device loss by far more (recorded: 1.224e-3
    relative; held above 5e-4)."""
    ref, got = jax_ref["F2"], port["F2"][0]
    np.testing.assert_allclose(got["loss"], got["one_loss"], rtol=1e-6)
    for k, w in got["one_grads"].items():
        np.testing.assert_allclose(got["grads"][k].numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6 * float(w.abs().max()), err_msg=k)
    np.testing.assert_allclose(got["one_loss"], ref["loss1"], rtol=1e-4)
    rel = abs(ref["loss_strips"] - ref["loss1"]) / abs(ref["loss1"])
    print(f"F2: JAX strip loss {ref['loss_strips']:.7f}, one-device {ref['loss1']:.7f}, "
          f"relative difference {rel:.3e}")
    assert rel > 5e-4
