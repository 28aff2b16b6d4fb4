"""gags_torch.gad.interop and train_gad's warm start against gags_tpu, and a
model dir whose newest chkpnt<N>/ is not the port's.

The reference's checkpoints are written here as the reference writes
them: `(gaussian_model.capture(), iteration)` with nn.Parameters and a
real torch.optim.Adam state dict in the optimizer slot, and the decoders
as 1x1-Conv2d state dicts. Tolerances: the scene arrays bit for bit; the
decoders' outputs rtol 1e-5 against the flax decoders; the warm start's
first losses rtol 1e-4 / atol 1e-7 against the JAX CLI's
(tests/test_torch_train_step.py's loss tolerance)."""

import os
import shutil
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gags_torch.cli import render as render_cli
from gags_torch.cli.relevancy import load_query_model
from gags_torch.cli.train_gad import RunConfig, run
from gags_torch.gad.interop import (load_reference_checkpoint, load_reference_decoder,
                                    load_reference_scale_decoder)
from gags_torch.models.decoders import FeatureDecoder, ScaleDecoder
from gags_torch.scene.gaussian_data import GaussianScene
from gags_torch.utils.synthetic import make_scene

from test_torch_train_cli import CLIP, build_fixture, _cfg

N_FIX = 60  # build_fixture's Gaussians (make_scene(60, seed=3))


def _capture(raw, feats=None, seed=0):
    """The reference's capture() tuple: Parameters, buffers, a real Adam
    state dict after one step, the spatial lr scale (a numpy.float64, as
    getNerfppNorm gives it), the features."""
    n = raw["means"].shape[0]
    p = lambda a: torch.nn.Parameter(torch.from_numpy(np.ascontiguousarray(a, np.float32)))  # noqa: E731
    params = [p(raw["means"]), p(raw["sh"][:, :1]), p(raw["sh"][:, 1:]),
              p(np.log(raw["scales"])), p(raw["quats"]),
              p(np.log(raw["opacities"] / (1 - raw["opacities"]))[:, None])]
    opt = torch.optim.Adam([{"params": [q], "lr": 1e-3, "name": name}
                            for q, name in zip(params, ("xyz", "f_dc", "f_rest", "scaling",
                                                        "rotation", "opacity"))], eps=1e-15)
    gen = torch.Generator().manual_seed(seed)
    for q in params:
        q.grad = torch.randn(q.shape, generator=gen)
    opt.step()
    with torch.no_grad():  # back to the arrays: the step moved them
        for q, a in zip(params, (raw["means"], raw["sh"][:, :1], raw["sh"][:, 1:],
                                 np.log(raw["scales"]), raw["quats"],
                                 np.log(raw["opacities"] / (1 - raw["opacities"]))[:, None])):
            q.copy_(torch.from_numpy(np.ascontiguousarray(a, np.float32)))
    args = (3, *params, torch.zeros(n), torch.zeros(n, 1), torch.zeros(n, 1),
            opt.state_dict(), np.float64(4.2))
    return args if feats is None else args + (p(feats),)


@pytest.mark.parametrize("fields", [12, 13])
def test_reference_checkpoint_matches_jax(tmp_path, fields):
    from gags_tpu.gad.interop import load_reference_checkpoint as jload

    raw = make_scene(40, seed=5)
    feats = np.random.default_rng(1).normal(size=(40, 16)).astype(np.float32)
    path = str(tmp_path / "chkpnt30000.pth")
    torch.save((_capture(raw, feats if fields == 13 else None), 30000), path)
    scene, it, got_feats = load_reference_checkpoint(path, device="cpu")
    jscene, jit, jfeats = jload(path)
    assert it == jit == (30000 if fields == 13 else 0)
    assert scene.max_sh_degree == jscene.max_sh_degree == 3
    for name in ("means", "sh", "opacities_raw", "scales_raw", "quats"):
        np.testing.assert_array_equal(getattr(scene, name).numpy(),
                                      np.asarray(getattr(jscene, name)), err_msg=name)
    if fields == 13:
        np.testing.assert_array_equal(got_feats.numpy(), jfeats)
        np.testing.assert_array_equal(scene.semantic_features.numpy(), feats)
    else:
        assert got_feats is None and jfeats is None and scene.semantic_features is None


def test_reference_checkpoint_numpy1_pickle(tmp_path):
    """A file saved under numpy 1 names the scalar reconstructor
    `numpy.core.multiarray.scalar`; numpy 2 writes `numpy._core...`. The
    weights-only load takes both, and nothing else is needed."""
    raw = make_scene(20, seed=6)
    path = str(tmp_path / "chkpnt7.pth")
    torch.save((_capture(raw, np.ones((20, 4), np.float32)), 7), path)
    with zipfile.ZipFile(path) as zin:
        entries = [(i.filename, zin.read(i.filename)) for i in zin.infolist()]
    old = tmp_path / "chkpnt7_numpy1.pth"
    with zipfile.ZipFile(old, "w", zipfile.ZIP_STORED) as zout:
        for name, data in entries:
            if name.endswith("data.pkl"):
                assert b"numpy._core.multiarray\nscalar" in data
                data = data.replace(b"numpy._core.multiarray\nscalar",
                                    b"numpy.core.multiarray\nscalar")
            zout.writestr(name, data)
    with pytest.raises(Exception, match="numpy.core.multiarray.scalar"):
        torch.load(str(old), weights_only=True)  # the default allowlist refuses it
    for p in (path, str(old)):
        scene, it, feats = load_reference_checkpoint(p, device="cpu")
        assert it == 7 and feats.shape == (20, 4)
        np.testing.assert_array_equal(scene.means.numpy(), raw["means"].astype(np.float32))


def _conv_sd(rng, dims_in, dims_out):
    sd = {}
    for i, (ci, co) in enumerate(zip(dims_in, dims_out)):
        sd[f"decoder.{2 * i}.weight"] = torch.from_numpy(
            rng.normal(scale=0.2, size=(co, ci, 1, 1)).astype(np.float32))
        sd[f"decoder.{2 * i}.bias"] = torch.from_numpy(
            rng.normal(scale=0.1, size=(co,)).astype(np.float32))
    return sd


def _write_decoders(d, n, rng, fdim=16, clip=512):
    f_sd = _conv_sd(rng, [fdim] + [256] * 8, [256] * 8 + [clip])
    s_sd = _conv_sd(rng, [fdim, 64, 128, 64, 32, 16], [64, 128, 64, 32, 16, 3])
    for sd, name in ((f_sd, "decoder"), (s_sd, "scale_decoder")):
        # a real optimizer state beside the weights, as the reference saves it
        ws = [torch.nn.Parameter(v.clone()) for v in sd.values()]
        opt = torch.optim.Adam(ws, lr=1e-4)
        for w in ws:
            w.grad = torch.ones_like(w)
        opt.step()
        torch.save({"module_state_dict": sd, "optimizer_state_dict": opt.state_dict()},
                   os.path.join(d, f"{name}_chkpnt{n}.pth"))
    return f_sd, s_sd


def test_reference_decoders_match_flax(tmp_path):
    from gags_tpu.gad.interop import load_reference_decoder as jdec
    from gags_tpu.gad.interop import load_reference_scale_decoder as jscale
    from gags_tpu.models.decoders import FeatureDecoder as JFeature
    from gags_tpu.models.decoders import ScaleDecoder as JScale

    rng = np.random.default_rng(0)
    _write_decoders(str(tmp_path), 30000, rng)
    x = rng.normal(size=(5, 7, 16)).astype(np.float32)
    dec = FeatureDecoder()
    dec.load_state_dict(load_reference_decoder(str(tmp_path / "decoder_chkpnt30000.pth")))
    scl = ScaleDecoder()
    scl.load_state_dict(load_reference_scale_decoder(
        str(tmp_path / "scale_decoder_chkpnt30000.pth")))
    with torch.no_grad():
        got_f = dec(torch.from_numpy(x)).numpy()
        got_s = scl(torch.from_numpy(x)).numpy()
    want_f = np.asarray(JFeature().apply(jdec(str(tmp_path / "decoder_chkpnt30000.pth")),
                                         jnp.asarray(x)))
    want_s = np.asarray(JScale().apply(jscale(str(tmp_path / "scale_decoder_chkpnt30000.pth")),
                                       jnp.asarray(x)))
    np.testing.assert_allclose(got_f, want_f, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-5, atol=1e-7)


def test_start_checkpoint_tracks_jax_warm_start(tmp_path, monkeypatch):
    """A 13-tuple chkpnt6.pth with both decoder files: the port resumes at
    iteration 7 with the file's decoders, and its first three losses track
    the JAX CLI's warm start from the same files."""
    import gags_tpu.cli.train_gad as jcli
    from gags_tpu.gad.train import GadConfig as JGadConfig
    from gags_tpu.splat.rasterizer import RasterizeConfig as JRaster

    root = str(tmp_path / "scene")
    build_fixture(root)
    ckdir = tmp_path / "ref"
    ckdir.mkdir()
    rng = np.random.default_rng(2)
    feats = (0.05 * rng.normal(size=(N_FIX, 8))).astype(np.float32)
    ck = str(ckdir / "chkpnt6.pth")
    torch.save((_capture(make_scene(N_FIX, seed=3), feats), 6), ck)
    f_sd, _ = _write_decoders(str(ckdir), 6, rng, fdim=8, clip=CLIP)

    seen, dec0 = [], {}

    def on_step(it, state, m):
        if m is None:
            dec0.update({k: v.clone() for k, v in state.decoder.state_dict().items()})
            np.testing.assert_array_equal(state.features.detach().numpy(), feats)
        seen.append((it, None if m is None else float(m["loss"])))

    rc = RunConfig(source_path=root, model_path=str(tmp_path / "torch"), start_checkpoint=ck,
                   resolution=1, iterations=9, save_iterations="9", test_iterations="",
                   device="cpu")
    state = run(rc, _cfg(), on_step=on_step)
    assert [it for it, _ in seen] == [6, 7, 8, 9] and state.step == 3
    for i in range(9):
        np.testing.assert_array_equal(dec0[f"d{i}.weight"].numpy(),
                                      f_sd[f"decoder.{2 * i}.weight"].numpy()[:, :, 0, 0])

    jlosses = []
    real = jcli.make_train_step_binned

    def recording(*a, **kw):
        step = real(*a, **kw)

        def wrapped(*sa):
            st, m = step(*sa)
            jlosses.append(float(m["loss"]))
            return st, m
        return wrapped

    monkeypatch.setattr(jcli, "make_train_step_binned", recording)
    jrc = jcli.RunConfig(source_path=root, model_path=str(tmp_path / "jax"),
                         start_checkpoint=ck, resolution=1, iterations=9,
                         save_iterations="9", test_iterations="")
    jcfg = JGadConfig(feature_dim=8, clip_dim=CLIP, max_segments=16,
                      raster=JRaster(tile_h=8, tile_w=16, chunk=8, interpret=True))
    jcli.run(jrc, jcfg)
    np.testing.assert_allclose([loss for _, loss in seen[1:]], jlosses, rtol=1e-4, atol=1e-7)


def test_newest_checkpoint_without_state_pt_raises(tmp_path):
    """An empty chkpnt50/ beside the port's chkpnt4/ (a JAX model dir's
    orbax checkpoint, say): the query loader, the scale-decoder loader and
    --resume each raise naming it instead of reading chkpnt4/."""
    root, model = str(tmp_path / "scene"), str(tmp_path / "model")
    ply = build_fixture(root)
    rc = RunConfig(source_path=root, model_path=model, ply_path=ply, resolution=1,
                   iterations=4, save_iterations="4", test_iterations="", device="cpu")
    run(rc, _cfg())
    scene = GaussianScene.from_ply(
        os.path.join(model, "point_cloud", "iteration_4", "point_cloud.ply"))
    assert render_cli.load_scale_decoder(model, scene, "cpu") is not None
    load_query_model(model, 4, "cpu")
    os.makedirs(os.path.join(model, "chkpnt50"))
    for call in (lambda: load_query_model(model, 4, "cpu"),
                 lambda: render_cli.load_scale_decoder(model, scene, "cpu"),
                 lambda: run(RunConfig(**{**rc.__dict__, "iterations": 6, "resume": True}),
                             _cfg())):
        with pytest.raises(ValueError, match=r"chkpnt50 is not a gags_torch checkpoint.*state\.pt"):
            call()
    shutil.rmtree(os.path.join(model, "chkpnt50"))
    assert run(RunConfig(**{**rc.__dict__, "iterations": 5, "save_iterations": "",
                            "resume": True}), _cfg()).step == 5
