"""The query and evaluation CLIs of gags_torch on the CPU: the tiny COLMAP
fixture of test_torch_train_cli after 3 CPU GAD steps, then
cli.relevancy (image mode, --video, pcd mode with and without the
neighbour vote), cli.evaluate (--text_embeds, and --clip_ckpt --bpe on a
tiny random CLIP with a written merge table) and cli.edit (all three
operations). Each output equals what the port's functions give on the
same arrays: PNG bytes, PLY fields, IoUs and hit counts exactly."""

import os
import shutil

import numpy as np
import pytest
import torch

from gags_torch.cli import edit as edit_cli
from gags_torch.cli import encode_text
from gags_torch.cli import evaluate as eval_cli
from gags_torch.cli import relevancy as rel_cli
from gags_torch.cli.train_gad import RunConfig, run as train_run
from gags_torch.core.sh import sh_to_rgb
from gags_torch.gad.train import GadConfig
from gags_torch.models.clip import CLIPConfig
from gags_torch.query import edit as qedit
from gags_torch.query import eval_iou, grounding
from gags_torch.scene.dataset import camera_from_info, detect_and_load
from gags_torch.scene.gaussian_data import GaussianScene
from gags_torch.scene.ply import read_ply
from gags_torch.splat.rasterizer import RasterizeConfig
from gags_torch.utils.campath import interpolate_path, novel_camera
from gags_torch.utils.colormaps import turbo
from gags_torch.utils.image import encode_png
from test_torch_clip import random_openclip_state, write_bpe
from test_torch_eval_iou import _write_labelme
from test_torch_train_cli import CLIP, build_fixture

STEPS = 3
LABELS = ["hello world", "a photo", "teapot"]
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Scene, model dir after 3 CPU GAD steps, a tiny CLIP text tower at the
    fixture's CLIP width, its merge table and its encode_text npz."""
    tmp = tmp_path_factory.mktemp("query_cli")
    root, model = str(tmp / "scene"), str(tmp / "model")
    ply = build_fixture(root, n_cams=4)
    cfg = GadConfig(feature_dim=8, clip_dim=CLIP, max_segments=16,
                    raster=RasterizeConfig(tile_h=8, tile_w=16, chunk=8))
    train_run(RunConfig(source_path=root, model_path=model, ply_path=ply, resolution=1,
                        iterations=STEPS, save_iterations=str(STEPS), test_iterations="",
                        device="cpu"), cfg)
    ccfg = CLIPConfig(**{**CLIPConfig.tiny().__dict__, "embed_dim": CLIP, "vocab_size": 600,
                         "context_length": 77})
    torch.save({k: torch.from_numpy(v) for k, v in random_openclip_state(ccfg, seed=5).items()},
               tmp / "clip.pt")
    bpe = write_bpe(str(tmp / "bpe.txt.gz"))
    npz = str(tmp / "embeds.npz")
    encode_text.run(str(tmp / "clip.pt"), LABELS, npz, bpe=bpe, clip_cfg=ccfg, device="cpu")
    return dict(root=root, model=model, tmp=tmp, npz=npz, bpe=bpe, clip=str(tmp / "clip.pt"),
                ccfg=ccfg)


def _text(npz):
    return rel_cli.load_text_embeds(npz)


def test_load_query_model_rule(trained, tmp_path):
    """The newest checkpoint's features and decoder; without a checkpoint
    the PLY's features and decoders.pt, the same values at the same step."""
    scene, dec = rel_cli.load_query_model(trained["model"], STEPS, CPU)
    blob = torch.load(os.path.join(trained["model"], f"chkpnt{STEPS}", "state.pt"),
                      weights_only=True)
    assert torch.equal(scene.semantic_features, blob["features"])
    bare = str(tmp_path / "bare")
    shutil.copytree(trained["model"], bare,
                    ignore=lambda d, names: [n for n in names if n.startswith("chkpnt")])
    scene2, dec2 = rel_cli.load_query_model(bare, STEPS, CPU)
    np.testing.assert_allclose(scene2.semantic_features.numpy(), blob["features"].numpy(),
                               atol=1e-7, rtol=0)
    x = torch.randn(5, 8, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(dec(x), dec2(x))


def _expected_pngs(trained, cams, thresh=0.5):
    scene, dec = rel_cli.load_query_model(trained["model"], STEPS, CPU)
    labels, pos, neg = _text(trained["npz"])
    raster = rel_cli.inference_config(trained["model"])
    out = {}
    for cam in cams:
        masks, heats = rel_cli.relevancy_maps(scene, dec, cam, torch.from_numpy(pos),
                                              torch.from_numpy(neg), thresh, raster, CPU)
        for k, label in enumerate(labels):
            mask = masks[k].numpy()[..., None].astype(np.float32)
            heat = turbo(heats[k].numpy())
            out[("heatmap", label, cam.name)] = encode_png(heat)
            out[("mask", label, cam.name)] = encode_png(mask.repeat(3, -1))
            out[("composited", label, cam.name)] = encode_png(heat * mask + 0.3 * heat * (1 - mask))
    return out


def _read(model, key):
    kind, label, name = key
    with open(os.path.join(model, "relevancy", kind, label, name + ".png"), "rb") as f:
        return f.read()


def test_relevancy_image_mode(trained):
    rep = rel_cli.run(trained["model"], trained["root"], STEPS, text_embeds=trained["npz"],
                      resolution=1, device="cpu")
    assert rep["frames"] == 4 and rep["frames_per_s"] > 0 and rep["videos"] == []
    assert not rep["config"]["aligned"]
    info = detect_and_load(trained["root"], foundation_model="none")
    cams = [camera_from_info(ci, 1) for ci in info.train_cameras]
    want = _expected_pngs(trained, cams)
    assert len(want) == 4 * 3 * len(LABELS)
    for key, png in want.items():
        assert _read(trained["model"], key) == png, key


def test_relevancy_video_mode(trained):
    rep = rel_cli.run(trained["model"], trained["root"], STEPS, text_embeds=trained["npz"],
                      video=True, video_frames=4, resolution=1, device="cpu")
    assert rep["frames"] == 4
    info = detect_and_load(trained["root"], foundation_model="none")
    cams = [camera_from_info(ci, 1) for ci in info.train_cameras]
    path = interpolate_path(np.linalg.inv(np.stack([c.viewmat.numpy() for c in cams])), 4)
    novel = [novel_camera(vm, cams[0], f"novel_{i:04d}") for i, vm in enumerate(path)]
    for key, png in _expected_pngs(trained, novel).items():
        assert _read(trained["model"], key) == png, key
    try:
        import cv2  # noqa: F401
        assert len(rep["videos"]) == len(LABELS)
        assert all(os.path.getsize(v) > 0 for v in rep["videos"])
    except ImportError:  # no encoder: the PNGs stand
        assert rep["videos"] == []


@pytest.mark.parametrize("smooth", [True, False], ids=["smooth", "raw"])
def test_relevancy_pcd_mode(trained, smooth):
    """k = 8 votes within a radius that reaches the fixture's neighbours."""
    scene, dec = rel_cli.load_query_model(trained["model"], STEPS, CPU)
    text = _text(trained["npz"])
    rep = rel_cli.pcd_mode(trained["model"], scene, dec, text, 0.5, smooth, CPU, k=8)
    assert set(rep["seconds"]) == {"decode", "relevancy", "knn", "select"}
    labels, pos, neg = text
    rel = grounding.point_relevancy(grounding.decode_features_chunked(dec, scene.semantic_features),
                                    torch.from_numpy(pos), torch.from_numpy(neg))
    base = sh_to_rgb(scene.sh[:, 0, :]).numpy()
    for i, label in enumerate(labels):
        mask = grounding.select_gaussians(rel, i, 0.5, smooth=False)
        if smooth:
            mask = grounding.smooth_point_mask(scene.means, mask, k=8)
        mask = mask.numpy()
        np.testing.assert_array_equal(rep["masks"][label], mask)
        v = read_ply(os.path.join(trained["model"], "relevancy_pcd", f"{label}.ply"))
        rgb = base * 0.25
        rgb[mask] = [1.0, 0.1, 0.1]
        np.testing.assert_array_equal(v["red"], (np.clip(rgb[:, 0], 0, 1) * 255).astype(np.uint8))
        np.testing.assert_array_equal(v["x"], scene.means[:, 0].numpy())
        assert rep["selected"][label] == int(mask.sum())


def test_relevancy_cli_main_pcd(trained):
    rel_cli.main(["-m", trained["model"], "-s", trained["root"], "--iteration", str(STEPS),
                  "--text_embeds", trained["npz"], "--pcd_mode", "--no_smooth", "--device",
                  "cpu"])
    assert all(os.path.exists(os.path.join(trained["model"], "relevancy_pcd", f"{l}.ply"))
               for l in LABELS)


def _labels_dir(trained):
    """Labelme frames 1 and 3 (cameras 0 and 2) at 24x12, labelled with the
    npz's prompts."""
    root = str(trained["tmp"] / "labels")
    if not os.path.exists(root):
        _write_labelme(root, h=12, w=24, frames=(1, 3))
        import json

        names = {"teapot": "hello world", "bear": "a photo", "sheep": "teapot"}
        for f in os.listdir(root):
            p = os.path.join(root, f)
            data = json.load(open(p))
            for obj in data["objects"]:
                obj["category"] = names[obj["category"]]
            json.dump(data, open(p, "w"))
    return root


def test_evaluate_text_embeds_and_clip(trained):
    labels_dir = _labels_dir(trained)
    seen = {}
    s1 = eval_cli.run(trained["model"], trained["root"], labels_dir, STEPS,
                      text_embeds=trained["npz"], device="cpu",
                      on_frame=lambda i, dec, r: seen.setdefault(i, dec))
    assert sorted(s1["frames"]) == ["0", "2"] and s1["seconds_per_frame"] > 0
    gt, _, _ = eval_iou.load_lerf_gt(labels_dir)
    labels_all, pos_all, neg = _text(trained["npz"])
    for idx, r in s1["frames"].items():
        pos = pos_all[[labels_all.index(l) for l in r["labels"]]]
        assert r["ious"] == eval_iou.eval_frame_iou(seen[idx], pos, neg, gt[idx], r["labels"])
        assert r["loc_hits"] == eval_iou.eval_frame_localization(seen[idx], pos, neg, gt[idx],
                                                                 r["labels"])
        assert seen[idx].shape == (12, 24, CLIP)
    ious = [v for r in s1["frames"].values() for v in r["ious"]]
    assert s1["miou"] == pytest.approx(float(np.mean(ious)), abs=0)
    s2 = eval_cli.run(trained["model"], trained["root"], labels_dir, STEPS,
                      clip_ckpt=trained["clip"], bpe=trained["bpe"], clip_cfg=trained["ccfg"],
                      device="cpu")
    np.testing.assert_allclose([v for r in s2["frames"].values() for v in r["ious"]], ious,
                               atol=1e-6, rtol=0)
    assert os.path.exists(os.path.join(trained["model"], f"iou_loc_{STEPS}.json"))


@pytest.mark.parametrize("op", ["color_func", "deletion", "extraction"])
def test_edit_cli(trained, op, tmp_path):
    """Threshold mode at the median similarity to the target, so about half
    the Gaussians are selected (3 steps from zero features leave every
    Gaussian's argmax object the same)."""
    scene, dec = rel_cli.load_query_model(trained["model"], STEPS, CPU)
    labels, pos, _ = _text(trained["npz"])
    decoded = grounding.decode_features_chunked(dec, scene.semantic_features)
    e = torch.from_numpy(pos[[labels.index(o) for o in LABELS]])
    sims = (decoded / decoded.norm(dim=-1, keepdim=True)) @ (e / e.norm(dim=-1, keepdim=True)).T
    thr = float(torch.median(sims[:, 1]))
    cfg_path = tmp_path / "edit.yaml"
    extra = '  colorFunc: "lambda c: np.clip(c[..., [2, 0, 1]] * 0.8, 0, 1)"\n' \
        if op == "color_func" else ""
    cfg_path.write_text(f"edit:\n  objects: {LABELS}\n  operations: \"{op}\"\n"
                        f"  targets: [\"a photo\"]\n  threshold: {thr!r}\n{extra}")
    out = str(tmp_path / "out.ply")
    edit_cli.main(["-m", trained["model"], "--config", str(cfg_path), "--text_embeds",
                   trained["npz"], "--iteration", str(STEPS), "-o", out, "--device", "cpu"])
    cfg = qedit.EditConfig.from_yaml(str(cfg_path))
    assert cfg.threshold == thr and cfg.targets == ["a photo"]
    mask = qedit.select_by_text(decoded, e, [1], cfg.threshold)
    want = qedit.apply_edit(scene, mask, op, qedit.parse_color_func(cfg.color_func)
                            if op == "color_func" else None)
    got = GaussianScene.from_ply(out)
    for name in ("means", "sh", "opacities_raw", "scales_raw", "quats", "semantic_features"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(want, name).numpy())
    rep = edit_cli.run(trained["model"], cfg, trained["npz"], STEPS, str(tmp_path / "o2.ply"),
                       device="cpu")
    assert rep["selected"] == int(mask.sum()) and rep["n_in"] == scene.num_gaussians
    assert 0 < rep["selected"] < scene.num_gaussians
    if op == "deletion":
        assert rep["n_out"] == scene.num_gaussians - rep["selected"]
    elif op == "extraction":
        assert rep["n_out"] == rep["selected"]


def test_empty_selection_writes_an_empty_ply(tmp_path):
    """Extracting nothing writes a readable PLY of 0 Gaussians."""
    _, scene = _scenes_small()
    empty = qedit.apply_edit(scene, torch.zeros(scene.num_gaussians, dtype=torch.bool),
                             "extraction")
    empty.save_ply(str(tmp_path / "e.ply"))
    back = GaussianScene.from_ply(str(tmp_path / "e.ply"))
    assert back.num_gaussians == 0 and back.sh.shape == (0, 16, 3)


def _scenes_small():
    from test_torch_query import _scenes

    return _scenes(6)


@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_query_entry_points_default_to_cuda(no_cuda, tmp_path):
    for fn in (lambda: rel_cli.run("/x", "/y", text_embeds="e.npz"),
               lambda: rel_cli.main(["-m", "/x", "-s", "/y", "--text_embeds", "e.npz"]),
               lambda: eval_cli.run("/x", "/y", "/z", text_embeds="e.npz"),
               lambda: eval_cli.main(["-m", "/x", "-s", "/y", "--gt_json", "/z"]),
               lambda: edit_cli.run("/x", qedit.EditConfig(["a"], "deletion", ["a"]), "e.npz"),
               lambda: edit_cli.main(["-m", "/x", "--config", "/c", "--text_embeds", "e"])):
        with pytest.raises((RuntimeError, FileNotFoundError)) as exc:
            fn()
        if exc.type is FileNotFoundError:  # the yaml is read before the device
            assert "/c" in str(exc.value)
        else:
            assert "CUDA" in str(exc.value)


def test_relevancy_maps_match_jax(trained):
    """Camera 0's heat maps and masks, the image mode's chain, against
    gags_tpu's render (Pallas in interpret mode), flax decoder (the
    checkpoint's weights carried over), relevancy, threshold and majority
    smoothing on the same PLY: heat maps to 2e-5, smoothed masks equal."""
    import jax.numpy as jnp

    from gags_tpu.models.decoders import FeatureDecoder as JFeat
    from gags_tpu.query.relevancy import heatmap_to_mask as jheatmap_to_mask
    from gags_tpu.query.relevancy import majority_smooth as jmajority_smooth
    from gags_tpu.query.relevancy import max_across_levels as jmax_across_levels
    from gags_tpu.query.grounding import decode_map_rows as jdecode
    from gags_tpu.scene.dataset import camera_from_info as jcamera_from_info
    from gags_tpu.scene.dataset import detect_and_load as jdetect_and_load
    from gags_tpu.scene.gaussian_data import GaussianScene as JScene
    from gags_tpu.splat.rasterizer import RasterizeConfig as JConfig
    from gags_tpu.splat.render import render as jrender

    scene, dec = rel_cli.load_query_model(trained["model"], STEPS, CPU)
    labels, pos, neg = _text(trained["npz"])
    info = detect_and_load(trained["root"], foundation_model="none")
    cam = camera_from_info(info.train_cameras[0], 1)
    masks, heats = rel_cli.relevancy_maps(scene, dec, cam, torch.from_numpy(pos),
                                          torch.from_numpy(neg), 0.5,
                                          rel_cli.inference_config(trained["model"]), CPU)
    js = JScene.from_ply(os.path.join(trained["model"], "point_cloud", f"iteration_{STEPS}",
                                      "point_cloud.ply"))
    feats = jnp.asarray(scene.semantic_features.numpy())
    jcam = jcamera_from_info(jdetect_and_load(trained["root"], foundation_model="none")
                             .train_cameras[0], 1)
    fmap = jrender(jcam, means=js.means, quats=js.quats, scales=js.scales,
                   opacities=js.opacities, semantic_features=feats, feature_mode=True,
                   bg_color=jnp.zeros((3,)),
                   config=JConfig(aligned=False, interpret=True, mxu_sigma=False)).render
    params = {"params": {k: {"kernel": v.weight.detach().numpy().T, "bias": v.bias.detach().numpy()}
                         for k, v in dec.named_children()}}
    jd = JFeat(output_dim=CLIP)
    decoded = jdecode(jd.apply, params, fmap)
    rel = jmax_across_levels(jnp.asarray(decoded)[None], jnp.asarray(pos),
                                 jnp.asarray(neg))[0]
    for k in range(len(labels)):
        jmask, jvm = jheatmap_to_mask(rel[k], 0.5)
        jvm = np.asarray(jvm)
        np.testing.assert_allclose(heats[k].numpy(), jvm, atol=2e-5, rtol=0)
        np.testing.assert_array_equal(
            masks[k].numpy(), np.asarray(jmajority_smooth(jmask)))


def test_relevancy_config_reuses_persisted_winner(trained, tmp_path, monkeypatch):
    """Without --autotune the image mode takes the persisted winner of its
    shape (bf16 variants allowed, as in JAX), else the model dir's
    settings with the unaligned binning; --autotune on the CPU returns
    the base (no timing without a card)."""
    from gags_torch.splat import autotune

    monkeypatch.setattr(autotune, "PERSIST_PATH", tmp_path / "tune.json")
    autotune._CACHE.clear()
    scene, _ = rel_cli.load_query_model(trained["model"], STEPS, CPU)
    info = detect_and_load(trained["root"], foundation_model="none")
    cam = camera_from_info(info.train_cameras[0], 1)
    base = rel_cli.inference_config(trained["model"])
    assert not base.aligned and (base.tile_h, base.tile_w) == (8, 16)
    assert rel_cli.relevancy_config(scene, cam, base, False, CPU) == base
    assert rel_cli.relevancy_config(scene, cam, base, True, CPU) == base
    won = RasterizeConfig(aligned=False, fused_keys=True, blend_bf16=True, budget_factor=4)
    autotune.persist(cam.width, cam.height, scene.num_gaussians, 8, won)
    assert rel_cli.relevancy_config(scene, cam, base, False, CPU) == won
