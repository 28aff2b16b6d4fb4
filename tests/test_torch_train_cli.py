"""gags_torch.cli.train_gad end to end on the CPU: a tiny COLMAP fixture
on disk → a few iterations with held-out reporting → checkpoint, PLY,
decoders.pt, metrics, PNGs → resume → serve the result."""

import json
import os

import numpy as np
import pytest
import torch

from gags_torch.cli.serve import load_server
from gags_torch.cli.train_gad import RunConfig, main, run
from gags_torch.core.camera import look_at
from gags_torch.gad.train import GadConfig
from gags_torch.models.weights import scene_from_arrays
from gags_torch.scene import colmap as cm
from gags_torch.splat.rasterizer import RasterizeConfig
from gags_torch.utils.synthetic import make_scene

N_GAUSS, W, H, CLIP = 60, 32, 16, 24


def build_fixture(root, n_cams=4, n_masks=5, seed=0, feature_dim=8, clip=CLIP):
    """COLMAP binary scene + language features + pretrained PLY, written
    with the port's own writers (the layout of tests/test_e2e_gad.py)."""
    rng = np.random.default_rng(seed)
    sparse = os.path.join(root, "sparse", "0")
    feat_dir = os.path.join(root, "language_features")
    os.makedirs(sparse, exist_ok=True)
    os.makedirs(feat_dir, exist_ok=True)
    f = 20.0
    cams = {1: cm.ColmapCamera(1, "PINHOLE", W, H, np.array([f, f, W / 2, H / 2]))}
    imgs = {}
    for i in range(n_cams):
        ang = 2 * np.pi * i / n_cams
        eye = np.array([0.4 * np.cos(ang), 0.4 * np.sin(ang), -0.5])
        vm = look_at(eye, np.array([0.0, 0.0, 6.0]), np.array([0, -1.0, 0]))
        imgs[i + 1] = cm.ColmapImage(i + 1, cm.rotmat_to_qvec(vm[:3, :3]), vm[:3, 3], 1,
                                     f"img{i:03d}.png")
        emb = rng.normal(size=(n_masks, clip)).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        np.save(os.path.join(feat_dir, f"img{i:03d}_f.npy"), emb)
        seg = np.full((4, H, W), -1.0, np.float32)
        seg[0] = 0
        seg[1, :, : W // 2] = 0
        seg[1, :, W // 2:] = 1
        seg[2] = 2
        seg[3] = rng.integers(3, n_masks, size=(H, W))
        np.save(os.path.join(feat_dir, f"img{i:03d}_s.npy"), seg)
    cm.write_cameras_binary(os.path.join(sparse, "cameras.bin"), cams)
    cm.write_images_binary(os.path.join(sparse, "images.bin"), imgs)
    xyz = rng.normal(size=(30, 3)) + [0, 0, 6.0]
    cm.write_points3d_binary(os.path.join(sparse, "points3D.bin"), xyz,
                             rng.integers(0, 255, (30, 3)))
    raw = make_scene(N_GAUSS, seed=3)
    scene = scene_from_arrays(raw["means"], raw["quats"], np.log(raw["scales"]),
                              np.log(raw["opacities"] / (1 - raw["opacities"])), raw["sh"],
                              semantic_features=np.zeros((N_GAUSS, feature_dim), np.float32))
    ply = os.path.join(root, "pretrained.ply")
    scene.save_ply(ply)
    return ply


def _cfg():
    return GadConfig(feature_dim=8, clip_dim=CLIP, max_segments=16,
                     raster=RasterizeConfig(tile_h=8, tile_w=16, chunk=8))


def test_train_cli_end_to_end(tmp_path):
    root, model = str(tmp_path / "scene"), str(tmp_path / "model")
    ply = build_fixture(root, n_cams=10)
    rc = RunConfig(source_path=root, model_path=model, ply_path=ply, resolution=1,
                   iterations=10, save_iterations="6", test_iterations="10",
                   eval_split=True, device="cpu")
    seen = []
    state = run(rc, _cfg(), on_step=lambda it, st, m: seen.append(
        (it, None if m is None else float(m["loss"]))))
    assert state.step == 10 and [it for it, _ in seen] == list(range(0, 11))
    assert seen[0][1] is None and all(np.isfinite(loss) for _, loss in seen[1:])
    for it in (6, 10):
        assert os.path.exists(os.path.join(model, f"chkpnt{it}", "state.pt"))
        ply_out = os.path.join(model, "point_cloud", f"iteration_{it}", "point_cloud.ply")
        assert os.path.exists(ply_out)
    for name in ("decoders.pt", "metrics.jsonl", "cfg.json", "gad_cfg.json", "cameras.json"):
        assert os.path.exists(os.path.join(model, name)), name
    pngs = sorted(os.listdir(os.path.join(model, "test_renders")))
    assert pngs == ["scale_map_10.png", "scale_map_l_10.png", "scale_map_m_10.png",
                    "scale_map_s_10.png"]
    with open(os.path.join(model, "test_renders", pngs[0]), "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    rows = [json.loads(l) for l in open(os.path.join(model, "metrics.jsonl"))]
    assert any("test_l1_feature" in r for r in rows)
    assert len(json.load(open(os.path.join(model, "cameras.json")))) == 9  # i % 8 == 2 held out

    # --resume continues from the last checkpoint
    rc2 = RunConfig(**{**rc.__dict__, "iterations": 12, "save_iterations": "12",
                       "test_iterations": "", "resume": True})
    state2 = run(rc2, _cfg())
    assert state2.step == 12

    # the trained model dir serves /relevancy through the port's server
    srv = load_server(model, 12, device="cpu")
    assert srv.scene.semantic_features.shape == (N_GAUSS, 8)
    assert torch.abs(srv.scene.semantic_features).max() > 0  # features trained
    cam_vm = look_at(np.array([0.0, 0.0, -0.5]), np.array([0.0, 0.0, 6.0]), np.array([0, -1.0, 0]))
    K = [20.0, 0, W / 2, 0, 20.0, H / 2, 0, 0, 1]
    pos = np.ones(CLIP, np.float32) / np.sqrt(CLIP)
    rep = srv.relevancy(dict(viewmat=cam_vm.reshape(-1).tolist(), K=K, width=W, height=H,
                             pos=pos.tolist(), neg=[(-pos).tolist()]))
    assert np.isfinite(rep["relevancy_max"])


def test_train_cli_defaults_to_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run(RunConfig(source_path=str(tmp_path), model_path=str(tmp_path / "m"),
                      ply_path="x.ply"))
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["-s", str(tmp_path), "-m", str(tmp_path / "m"), "--ply", "x.ply"])


def test_main_trains_on_cpu(tmp_path):
    """The command line with the default GadConfig (16-dim features,
    512-dim CLIP supervision)."""
    root, model = str(tmp_path / "scene"), str(tmp_path / "model")
    ply = build_fixture(root, feature_dim=16, clip=512)
    main(["-s", root, "-m", model, "--ply", ply, "-r", "2", "--iterations", "3",
          "--save_iterations", "3", "--test_iterations", "", "--device", "cpu"])
    assert os.path.exists(os.path.join(model, "point_cloud", "iteration_3", "point_cloud.ply"))


def test_non_finite_loss_dumps_state(tmp_path, monkeypatch):
    """A NaN loss stops the run and keeps the state outside the chkpnt*
    namespace, so --resume still finds the last good checkpoint."""
    import gags_torch.cli.train_gad as tg

    real = tg.make_train_step_binned

    def poisoned(width, height, cfg):
        step = real(width, height, cfg)

        def wrapped(state, geom, batch, ew, rw):
            state, m = step(state, geom, batch, ew, rw)
            return state, {**m, "loss": torch.tensor(float("nan"))}
        return wrapped

    monkeypatch.setattr(tg, "make_train_step_binned", poisoned)
    root, model = str(tmp_path / "scene"), str(tmp_path / "model")
    ply = build_fixture(root)
    rc = RunConfig(source_path=root, model_path=model, ply_path=ply, resolution=1,
                   iterations=12, save_iterations="", test_iterations="", device="cpu")
    with pytest.raises(FloatingPointError, match="non-finite"):
        run(rc, _cfg())
    assert os.path.exists(os.path.join(model, "nan_dump", "chkpnt10", "state.pt"))
    assert tg.latest_checkpoint_step(model) is None


def test_dataset_matches_jax(tmp_path):
    """The loader's padded embeddings, render-resolution seg maps and
    cameras equal the JAX package's at -r 2."""
    from gags_tpu.gad.data import GadDataset as JDataset
    from gags_tpu.scene.dataset import detect_and_load as jload
    from gags_torch.gad.data import GadDataset
    from gags_torch.scene.dataset import detect_and_load

    root = str(tmp_path / "scene")
    build_fixture(root, n_cams=3)
    dj = JDataset(jload(root).train_cameras, resolution=2)
    dt = GadDataset(detect_and_load(root).train_cameras, resolution=2)
    assert (dt.width, dt.height, dt.max_masks) == (dj.width, dj.height, dj.max_masks) == (16, 8, 5)
    for i in range(len(dj)):
        bj, bt = dj.batch(i), dt.batch(i)
        for k in ("img_embed", "seg_map"):
            np.testing.assert_array_equal(bt[k], np.asarray(bj[k]))
        for k in ("viewmat", "K"):
            np.testing.assert_allclose(bt[k], np.asarray(bj[k]), atol=1e-6)
