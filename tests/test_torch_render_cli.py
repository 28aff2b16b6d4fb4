"""gags_torch.cli.render on the CPU: a tiny COLMAP fixture trained for a
few GAD steps, rendered in RGB+ED and in feature mode, its .npy outputs
against gags_tpu's render of the same PLY (Pallas in interpret mode), its
PNGs decoded by read_png; the persisted autotune winner reused by the
render and serve CLIs."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gags_tpu.scene.dataset import camera_from_info as jcamera_from_info
from gags_tpu.scene.dataset import detect_and_load as jdetect_and_load
from gags_tpu.scene.gaussian_data import GaussianScene as JScene
from gags_tpu.splat.rasterizer import RasterizeConfig as JConfig
from gags_tpu.splat.render import render as jrender
from gags_torch.cli import render as rcli
from gags_torch.cli.serve import load_server
from gags_torch.cli.train_gad import RunConfig, run as train_run
from gags_torch.gad.train import GadConfig
from gags_torch.splat import autotune
from gags_torch.splat.rasterizer import RasterizeConfig
from gags_torch.utils.image import read_png
from test_torch_train_cli import CLIP, H, W, build_fixture

STEPS = 3


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The fixture scene with 10 cameras (so --eval holds one out) and a
    model dir after 3 CPU GAD steps (checkpoint, PLY, decoders)."""
    tmp = tmp_path_factory.mktemp("render_cli")
    root, model = str(tmp / "scene"), str(tmp / "model")
    ply = build_fixture(root, n_cams=10)
    cfg = GadConfig(feature_dim=8, clip_dim=CLIP, max_segments=16,
                    raster=RasterizeConfig(tile_h=8, tile_w=16, chunk=8))
    train_run(RunConfig(source_path=root, model_path=model, ply_path=ply, resolution=1,
                        iterations=STEPS, save_iterations=str(STEPS), test_iterations="",
                        device="cpu"), cfg)
    return root, model


@pytest.fixture()
def store(tmp_path, monkeypatch):
    path = tmp_path / "tune.json"
    monkeypatch.setattr(autotune, "PERSIST_PATH", path)
    return path


def _jax_renders(root, model, **kw):
    """gags_tpu's render of the model dir's PLY for every train camera."""
    scene = JScene.from_ply(os.path.join(model, "point_cloud", f"iteration_{STEPS}",
                                         "point_cloud.ply"))
    cfg = JConfig(aligned=False, interpret=True, mxu_sigma=False)
    out = {}
    for info in jdetect_and_load(root, foundation_model="none").train_cameras:
        cam = jcamera_from_info(info, 1)
        r = jrender(cam, means=scene.means, quats=scene.quats, scales=scene.scales,
                    opacities=scene.opacities, sh=scene.sh, sh_degree=scene.max_sh_degree,
                    semantic_features=scene.semantic_features, bg_color=jnp.zeros((3,)),
                    config=cfg, **kw)
        out[os.path.splitext(info.name)[0]] = np.asarray(r.render)
    return out


def test_render_rgb_ed_matches_jax(trained, store):
    root, model = trained
    rep = rcli.run(model, root, STEPS, render_mode="RGB+ED", resolution=1, device="cpu")
    assert set(rep) == {"train"} and rep["train"]["frames"] == 10
    assert rep["train"]["frames_per_s"] > 0 and not rep["train"]["config"]["aligned"]
    want = _jax_renders(root, model, render_mode="RGB+ED")
    base = os.path.join(model, "train", f"ours_{STEPS}")
    for name, img in want.items():
        depth = np.load(os.path.join(base, "depth", name + "_depth.npy"))
        assert depth.shape == (H, W)
        np.testing.assert_allclose(depth, img[..., 3], atol=2e-5, rtol=1e-4)
        png = read_png(os.path.join(base, "renders", name + ".png"))
        assert png.shape == (H, W, 3)
        q = (np.clip(img[..., :3], 0, 1) * 255).astype(np.int32)
        assert np.abs(png.astype(np.int32) - q).max() <= 1  # 8-bit rounding at a boundary
        assert read_png(os.path.join(base, "depth", name + "_depth.png")).shape == (H, W, 3)


def test_render_feature_mode_matches_jax(trained, store):
    root, model = trained
    rcli.run(model, root, STEPS, feature_mode=True, feature_npy=True, resolution=1,
             device="cpu")
    want = _jax_renders(root, model, feature_mode=True)
    base = os.path.join(model, "train", f"ours_{STEPS}")
    for name, fmap in want.items():
        got = np.load(os.path.join(base, "saved_feature", name + "_fmap_CxHxW.npy"))
        assert got.shape == (8, H, W)
        np.testing.assert_allclose(got, fmap.transpose(2, 0, 1), atol=2e-5, rtol=1e-4)
        for sub in ("feature_pca", "scale_map"):  # the checkpoint's scale decoder
            assert read_png(os.path.join(base, sub, name + ".png")).shape == (H, W, 3)


def test_scale_map_is_the_checkpoint_decoder(trained):
    from gags_torch.gad.checkpoints import load_checkpoint
    from gags_torch.gad.train import create_train_state
    from gags_torch.scene.gaussian_data import GaussianScene

    _, model = trained
    scene = GaussianScene.from_ply(os.path.join(model, "point_cloud", f"iteration_{STEPS}",
                                                "point_cloud.ply"))
    dec = rcli.load_scale_decoder(model, scene, torch.device("cpu"))
    state = load_checkpoint(model, STEPS, create_train_state(
        scene, GadConfig.load(model, feature_dim=8), device="cpu"))
    for a, b in zip(dec.parameters(), state.scale_decoder.parameters()):
        assert torch.equal(a, b)
    # a fresh decoder (seed 0) differs from the trained one
    fresh = create_train_state(scene, GadConfig.load(model, feature_dim=8), device="cpu")
    assert any(not torch.equal(a, b) for a, b in zip(dec.parameters(),
                                                     fresh.scale_decoder.parameters()))


def test_main_eval_split_and_skip(trained, store, capsys):
    root, model = trained
    rcli.main(["-m", model, "-s", root, "--iteration", str(STEPS), "--eval", "--skip_train",
               "-r", "1", "--device", "cpu"])
    assert "test: 1 frames" in capsys.readouterr().out
    held_out = jdetect_and_load(root, eval_split=True, foundation_model="none").test_cameras
    names = sorted(os.listdir(os.path.join(model, "test", f"ours_{STEPS}", "renders")))
    assert names == [os.path.splitext(c.name)[0] + ".png" for c in held_out] == ["img002.png"]
    with pytest.raises(ValueError, match="mutually exclusive"):
        rcli.run(model, root, STEPS, feature_mode=True, render_mode="RGB+ED", device="cpu")


def test_render_defaults_to_cuda(trained, monkeypatch):
    root, model = trained
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        rcli.run(model, root, STEPS)
    with pytest.raises(RuntimeError, match="CUDA"):
        rcli.main(["-m", model, "-s", root, "--iteration", str(STEPS)])


def test_render_reuses_persisted_winner(trained, store, capsys):
    """A stored winner of this shape is used without --autotune; its lossy
    flags are stripped for the render CLI; --autotune on the CPU keeps the
    base (times mean nothing there)."""
    root, model = trained
    n = 60
    won = RasterizeConfig(aligned=False, fused_keys=True, tile_cull=True, blend_bf16=True,
                          budget_factor=5)
    autotune.persist(W, H, n, 3, won)
    rep = rcli.run(model, root, STEPS, resolution=1, skip_test=True, device="cpu")
    assert "persisted tuned config reused" in capsys.readouterr().out
    cfg = rep["train"]["config"]
    assert cfg["fused_keys"] and cfg["tile_cull"] and not cfg["blend_bf16"]
    assert cfg["budget_factor"] == 5
    rep = rcli.run(model, root, STEPS, resolution=1, autotune=True, device="cpu")
    assert rep["train"]["config"] == dataclasses.asdict(RasterizeConfig(aligned=False))


def test_serve_reuses_persisted_winner(trained, store):
    """load_server: the stored winner at autotune_res with bf16 kept, the
    default config without one, the base of the CPU autotune."""
    _, model = trained
    assert load_server(model, STEPS, device="cpu", autotune_res=(W, H)).raster == \
        RasterizeConfig(aligned=False)
    won = RasterizeConfig(aligned=False, fused_keys=True, blend_bf16=True,
                          fast_color_rows=True)
    autotune.persist(W, H, 60, 8, won)
    assert load_server(model, STEPS, device="cpu", autotune_res=(W, H)).raster == won
    assert load_server(model, STEPS, device="cpu").raster == RasterizeConfig(aligned=False)
    srv = load_server(model, STEPS, device="cpu", autotune=True, autotune_res=(W, H))
    assert srv.raster == RasterizeConfig(aligned=False, fast_color_rows=True)
