"""The GAS CLIs of the port on a tiny COLMAP fixture, end to end on the
CPU, against the JAX package's functions on the same inputs:

render RGB+ED (the port) → depth_sample.run (maps to 1e-6 of JAX's, the
same pixels set) → gas.run with tiny SAM and CLIP checkpoint files and
lowered thresholds (seg maps exact; embeddings within one float16 step of
JAX's) → the port's GAD loader and two GAD steps on the written features
→ encode_text.run (embeddings to 2e-5 of JAX's) → the server answers a
relevancy query with them. Also: every new entry point defaults to CUDA
and raises without it, and the new modules import with JAX blocked.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gags_tpu.cli.gas import load_image_1080p as jload_image
from gags_tpu.gas import depth_sampler as jds
from gags_tpu.gas import masks as jm
from gags_tpu.gas.data_utils import resize_map
from gags_tpu.gas.generator import AutomaticMaskGenerator as JGen
from gags_tpu.gas.generator import GeneratorConfig as JGenCfg
from gags_tpu.gas.prompts import build_all_layer_mindepth_point_grids
from gags_tpu.models import clip as jc
from gags_tpu.models import sam as js
from gags_tpu.models.sam_weights import load_sam_state_dict as jload_sam
from gags_tpu.models.tokenizer import ClipTokenizer as JTokenizer
from gags_tpu.scene.dataset import camera_from_info as jcamera_from_info
from gags_tpu.scene.dataset import detect_and_load as jdetect_and_load
from gags_tpu.scene.gaussian_data import GaussianScene as JScene
from gags_torch.cli import depth_sample, encode_text, gas
from gags_torch.cli import render as render_cli
from gags_torch.cli.serve import load_server
from gags_torch.cli.train_gad import RunConfig, run as train_run
from gags_torch.gad.data import GadDataset
from gags_torch.gad.train import GadConfig
from gags_torch.gas.generator import GeneratorConfig
from gags_torch.models.clip import CLIPConfig
from gags_torch.models.sam import SAMConfig
from gags_torch.scene.dataset import detect_and_load
from gags_torch.splat.rasterizer import RasterizeConfig
from gags_torch.utils.image import encode_png
from test_torch_clip import random_openclip_state, write_bpe
from test_torch_sam import random_sam_state
from test_torch_train_cli import build_fixture

ITER, SEED = 5, 42
GEN = dict(points_per_batch=8, pred_iou_thresh=-10.0, stability_score_thresh=-1.0,
           min_mask_region_area=4)  # tests/test_gas_to_gad.py's lowered thresholds
FILTER = dict(iou_thr=0.95, score_thr=-10.0, inner_thr=0.9)
TEXT_TOL = 2e-5


def _f16_step(a, b):
    """|a - b| in units of the float16 spacing at their magnitude."""
    a, b = a.astype(np.float32), b.astype(np.float32)
    step = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float16)).astype(np.float32)
    return np.abs(a - b) / step


@pytest.fixture(scope="module")
def gas_run(tmp_path_factory):
    """The fixture scene, rendered, depth-sampled and GAS-processed by the
    port; the checkpoints written as files."""
    tmp = tmp_path_factory.mktemp("gas")
    root, model = str(tmp / "scene"), str(tmp / "model")
    ply = build_fixture(root, n_cams=3, feature_dim=8, clip=CLIPConfig.tiny().embed_dim)
    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, "images"))
    for ci in detect_and_load(root, foundation_model="none").train_cameras:
        img = rng.uniform(0, 1, (ci.height, ci.width, 3))
        img[: ci.height // 2] *= 0.3  # two regions of different brightness
        with open(ci.image_path, "wb") as f:
            f.write(encode_png(img))
    snap = os.path.join(model, "point_cloud", f"iteration_{ITER}")
    os.makedirs(snap)
    shutil.copy(ply, os.path.join(snap, "point_cloud.ply"))
    render_cli.run(model, root, ITER, render_mode="RGB+ED", device="cpu")
    ds = depth_sample.run(root, model, ITER, device="cpu")
    sam_sd = random_sam_state(SAMConfig.tiny())
    clip_sd = random_openclip_state(CLIPConfig.tiny())
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sam_sd.items()}}, tmp / "sam.pth")
    torch.save({k: torch.from_numpy(v) for k, v in clip_sd.items()}, tmp / "clip.pt")
    report = gas.run(root, model, ITER, sam_ckpt=str(tmp / "sam.pth"),
                     clip_ckpt=str(tmp / "clip.pt"), seed=SEED, gen_cfg=GeneratorConfig(**GEN),
                     filter_thresholds=FILTER, sam_cfg=SAMConfig.tiny(),
                     clip_cfg=CLIPConfig.tiny(), device="cpu")
    return dict(tmp=tmp, root=root, model=model, ply=ply, depth=ds, gas=report, sam_sd=sam_sd,
                clip_sd=clip_sd)


def test_depth_samples_match_jax(gas_run):
    root, model = gas_run["root"], gas_run["model"]
    info = jdetect_and_load(root, foundation_model="none")
    scene = JScene.from_ply(os.path.join(model, "point_cloud", f"iteration_{ITER}",
                                         "point_cloud.ply"))
    cams = [jcamera_from_info(ci, -1) for ci in info.train_cameras]
    names = [os.path.splitext(ci.name)[0] for ci in info.train_cameras]
    dmaps = np.stack([np.load(os.path.join(model, "train", f"ours_{ITER}", "depth",
                                           n + "_depth.npy")) for n in names])
    mind, vis, uv = jds.min_depth_over_cameras(
        scene.means, jnp.stack([c.viewmat for c in cams]), jnp.stack([c.K for c in cams]),
        jnp.asarray(dmaps))
    assert gas_run["depth"]["maps"] == 3 and int(np.asarray(vis).sum()) > 0
    assert gas_run["depth"]["visible"] == np.asarray(vis).sum(0).tolist()
    for i, (n, c) in enumerate(zip(names, cams)):
        want = np.asarray(jds.splat_depth_samples(mind, vis[:, i], uv[:, i], c.height, c.width))
        got = np.load(os.path.join(root, "depths_sample", n + "_depth_sample.npy"))
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got > 0, want > 0)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _jax_gas(gas_run):
    """The JAX package's GAS loop (cli/gas.py) on the same files, with the
    same tiny models and lowered thresholds: {name: (f, s)}."""
    root, model = gas_run["root"], gas_run["model"]
    jcfg, ccfg = js.SAMConfig.tiny(), jc.CLIPConfig.tiny()
    sam = js.SAM(jcfg)
    gen = JGen(sam, jload_sam(gas_run["sam_sd"], jcfg), jcfg, JGenCfg(**GEN))
    clip, cparams = jc.CLIP(ccfg), jc.load_openclip_state_dict(gas_run["clip_sd"], ccfg)
    embed = jax.jit(lambda x: clip.apply(cparams, method="encode_image", images=x))
    rng = np.random.default_rng(SEED)
    out = {}
    for ci in jdetect_and_load(root, foundation_model="none").train_cameras:
        name = os.path.splitext(ci.name)[0]
        image = jload_image(ci.image_path)
        h, w = image.shape[:2]
        depth = resize_map(np.load(os.path.join(model, "train", f"ours_{ITER}", "depth",
                                                name + "_depth.npy")), (h, w))
        sample = resize_map(np.load(os.path.join(root, "depths_sample",
                                                 name + "_depth_sample.npy")), (h, w), nearest=True)
        grids = build_all_layer_mindepth_point_grids(8, 0, 1, 4, depth, sample, rng)
        levels = [jm.filter_masks(lv, **FILTER) for lv in gen.generate(image, grids[0])]
        embeds, segs = {}, {}
        for lname, lv in zip(["default", "s", "m", "l"], levels):
            if lv:
                crops = jm.extract_mask_crops(lv, image)
                e = np.asarray(embed(jc.preprocess_images(jnp.asarray(crops), ccfg.image_size)))
                embeds[lname] = (e / np.linalg.norm(e, axis=-1, keepdims=True)).astype(np.float16)
                segs[lname] = jm.masks_to_seg_map(lv, (h, w))
        out[name] = jm.pack_granularities(embeds, segs)
    return out


def test_gas_language_features_match_jax(gas_run):
    rep = gas_run["gas"]
    assert rep["written"] == 3 and len(rep["images"]) == 3
    want = _jax_gas(gas_run)
    feat = os.path.join(gas_run["root"], "language_features")
    for name, (f_j, s_j) in want.items():
        f = np.load(os.path.join(feat, name + "_f.npy"))
        s = np.load(os.path.join(feat, name + "_s.npy"))
        assert f.dtype == np.float16 and s.dtype == np.float32 and s.shape == (4, 16, 32)
        assert f.shape == f_j.shape and f.shape[0] == int(s.max()) + 1  # the packing invariant
        np.testing.assert_array_equal(s, s_j.astype(np.float32))
        assert _f16_step(f, f_j).max() <= 1.0
        assert sum(rep["images"][name].values()) == f.shape[0]


def test_gas_output_feeds_gad(gas_run):
    """The port's GAD loader reads the GAS files; two GAD steps train on them
    and the result serves a relevancy query with encode_text's embeddings."""
    root, tmp = gas_run["root"], gas_run["tmp"]
    info = detect_and_load(root)
    ds = GadDataset(info.train_cameras, resolution=1)
    ex = ds.examples[0]
    assert ex.img_embed.dtype == np.float16 and ex.img_embed.shape[1] == CLIPConfig.tiny().embed_dim
    gad = str(tmp / "gad")
    cfg = GadConfig(feature_dim=8, clip_dim=CLIPConfig.tiny().embed_dim, max_segments=64,
                    raster=RasterizeConfig(tile_h=8, tile_w=16, chunk=8))
    losses = []
    state = train_run(RunConfig(source_path=root, model_path=gad, ply_path=gas_run["ply"],
                                resolution=1, iterations=2, save_iterations="2",
                                test_iterations="", device="cpu"), cfg,
                      on_step=lambda it, st, m: m is not None and losses.append(float(m["loss"])))
    assert state.step == 2 and len(losses) == 2 and np.all(np.isfinite(losses))

    # the tokenizer's ids need the vocabulary of its merge table and 77 positions
    ccfg_t = CLIPConfig(**{**CLIPConfig.tiny().__dict__, "vocab_size": 600, "context_length": 77})
    text_sd = random_openclip_state(ccfg_t, seed=4)
    torch.save({k: torch.from_numpy(v) for k, v in text_sd.items()}, tmp / "clip_text.pt")
    bpe = write_bpe(str(tmp / "bpe.txt.gz"))
    npz = str(tmp / "embeds.npz")
    out = encode_text.run(str(tmp / "clip_text.pt"), ["hello world", "a photo"], npz, bpe=bpe,
                          clip_cfg=ccfg_t, device="cpu")
    ccfg = jc.CLIPConfig(**ccfg_t.__dict__)
    params = jc.load_openclip_state_dict(text_sd, ccfg)
    tok = JTokenizer(bpe)
    for key, texts in (("pos", ["hello world", "a photo"]),
                       ("neg", ["object", "things", "stuff", "texture"])):
        e = np.array(jc.CLIP(ccfg).apply(params, jnp.asarray(tok(texts)), method="encode_text"))
        e /= np.linalg.norm(e, axis=-1, keepdims=True)
        np.testing.assert_allclose(out[key], e, rtol=0, atol=TEXT_TOL)
    server = load_server(gad, 2, text_embeds=npz, device="cpu")
    cam = info.train_cameras[0]
    from gags_torch.scene.dataset import camera_from_info

    c = camera_from_info(cam, 1)
    reply = server.relevancy(dict(viewmat=c.viewmat.reshape(-1).tolist(),
                                  K=c.K.reshape(-1).tolist(), width=c.width, height=c.height,
                                  label="hello world"))
    assert 0.0 <= reply["relevancy_max"] <= 1.0


@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_gas_entry_points_default_to_cuda(no_cuda, tmp_path):
    from gags_torch.cli import convert_weights

    with pytest.raises(RuntimeError, match="CUDA"):
        depth_sample.run("/nonexistent", "/nonexistent")
    with pytest.raises(RuntimeError, match="CUDA"):
        depth_sample.main(["-s", "/nonexistent", "-m", "/nonexistent"])
    with pytest.raises(RuntimeError, match="CUDA"):
        gas.run("/nonexistent", "/nonexistent", sam_ckpt="x", clip_ckpt="y")
    with pytest.raises(RuntimeError, match="CUDA"):
        gas.main(["-s", "/x", "-m", "/y", "--sam_ckpt", "a", "--clip_ckpt", "b"])
    with pytest.raises(RuntimeError, match="CUDA"):
        encode_text.run("x", ["a"], str(tmp_path / "e.npz"))
    with pytest.raises(RuntimeError, match="CUDA"):
        encode_text.main(["--clip_ckpt", "x", "--labels", "a", "-o", str(tmp_path / "e.npz")])
    with pytest.raises(RuntimeError, match="CUDA"):
        convert_weights.main(["--sam", "x"])


def test_gas_modules_import_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'gags_tpu', 'PIL'):\n"
        "    sys.modules[m] = None\n"
        "import gags_torch.cli.gas, gags_torch.cli.depth_sample, gags_torch.cli.encode_text\n"
        "import gags_torch.cli.convert_weights, gags_torch.models.ckpt_inventory\n"
        "import gags_torch.gas.generator, gags_torch.models.tokenizer\n"
        "print('ok')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_visualize_prompts_writes_a_panel_per_image(gas_run, tmp_path, monkeypatch, capsys):
    """One 2x2 panel PNG per image from the render's depth maps and the
    depth samples, with the prompt counts of gags_tpu's tool (same seed)."""
    import gags_tpu.cli.visualize_prompts as jvis
    from gags_torch.cli import visualize_prompts

    root, model = gas_run["root"], gas_run["model"]
    out = str(tmp_path / "vis")
    paths = visualize_prompts.run(root, model, ITER, num_images=4, output=out)
    lines = capsys.readouterr().out.strip().splitlines()
    names = [os.path.splitext(ci.name)[0]
             for ci in detect_and_load(root, foundation_model="none").train_cameras]
    assert sorted(os.listdir(out)) == sorted(n + "_prompts.png" for n in names)
    assert paths == [os.path.join(out, n + "_prompts.png") for n in names]
    for p in paths:
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    monkeypatch.setattr(sys, "argv", ["visualize_prompts", "-s", root, "-m", model,
                                      "--iteration", str(ITER), "-o", str(tmp_path / "jvis")])
    jvis.main()
    assert capsys.readouterr().out.strip().splitlines() == lines
