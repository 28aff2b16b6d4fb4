"""gags_torch.cli.train_rgb on the CPU, and the PNG decoder it reads
images with: read_png against PIL for every colour type and filter type;
the CLI end to end on a tiny COLMAP fixture with PNG images and an SfM
seed cloud, its PLY snapshot read back by both packages and distilled by
the GAD CLI."""

import os
import struct
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from gags_tpu.scene.gaussian_data import GaussianScene as JScene
from gags_torch.cli.train_gad import main as train_gad_main
from gags_torch.cli.train_rgb import RunConfig, main, run
from gags_torch.rgb.train import RgbConfig
from gags_torch.scene.dataset import camera_from_info, detect_and_load
from gags_torch.scene.gaussian_data import GaussianScene
from gags_torch.splat.rasterizer import RasterizeConfig
from gags_torch.splat.render import render
from gags_torch.utils.image import encode_png, load_rgb, read_png
from gags_torch.utils.synthetic import make_scene

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_train_cli import build_fixture  # noqa: E402

PNG_TYPES = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> colour type


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _encode_filtered(px: np.ndarray) -> bytes:
    """An 8-bit PNG of (H, W, C) uint8 whose row y uses filter type y % 5."""
    h, w, c = px.shape
    rows = px.reshape(h, w * c).astype(np.int64)
    out = bytearray()
    for y in range(h):
        f = y % 5
        cur, up = rows[y], rows[y - 1] if y else np.zeros(w * c, np.int64)
        line = [f]
        for x in range(w * c):
            a = cur[x - c] if x >= c else 0
            b = up[x]
            cc = up[x - c] if x >= c else 0
            pred = [0, a, b, (a + b) // 2, _paeth(a, b, cc)][f]
            line.append((cur[x] - pred) % 256)
        out += bytes(line)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, PNG_TYPES[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(bytes(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_read_png_every_filter_matches_pil(tmp_path, channels):
    px = np.random.default_rng(channels).integers(0, 256, size=(11, 7, channels), dtype=np.uint8)
    p = tmp_path / "f.png"
    p.write_bytes(_encode_filtered(px))
    want = np.asarray(Image.open(p))
    got = read_png(str(p))
    np.testing.assert_array_equal(got, px)
    np.testing.assert_array_equal(got.reshape(want.shape), want)


def _png_filters(path) -> set:
    """The filter types of a non-interlaced 8-bit PNG's rows."""
    data = open(path, "rb").read()
    w, h = struct.unpack(">II", data[16:24])
    pos, idat = 8, b""
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return set(raw.reshape(h, -1)[:, 0].tolist())


@pytest.mark.parametrize("mode,hw", [("L", (24, 40)), ("RGB", (24, 40)), ("RGBA", (24, 40)),
                                     ("RGB", (720, 1280))])
def test_read_png_of_pil_files(tmp_path, mode, hw):
    """PNGs as PIL writes them (its own adaptive filter choice, at 1280x720
    Paeth rows among them), and load_rgb's conversion to RGB against PIL's
    convert("RGB")."""
    rng = np.random.default_rng(3)
    steps = rng.integers(0, 9, size=hw + (4,))
    smooth = (np.cumsum(steps, axis=0) + np.cumsum(steps, axis=1)) % 256  # compressible
    img = Image.fromarray(smooth.astype(np.uint8)[..., :len(mode)].squeeze(-1) if mode == "L"
                          else smooth.astype(np.uint8)[..., :len(mode)], mode)
    p = tmp_path / f"{mode}.png"
    img.save(p)
    if hw[1] > 1000:
        assert 4 in _png_filters(p)
    want = np.asarray(Image.open(p))
    np.testing.assert_array_equal(read_png(str(p)).reshape(want.shape), want)
    np.testing.assert_array_equal(load_rgb(str(p), hw[1], hw[0]),
                                  np.asarray(Image.open(p).convert("RGB")))


def test_load_rgb_resizes_only_with_pil(tmp_path, monkeypatch):
    p = tmp_path / "a.png"
    px = np.random.default_rng(0).integers(0, 256, size=(10, 12, 3), dtype=np.uint8)
    Image.fromarray(px).save(p)
    want = np.asarray(Image.open(p).convert("RGB").resize((6, 5)))
    np.testing.assert_array_equal(load_rgb(str(p), 6, 5), want)
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(load_rgb(str(p), 12, 10), px)  # the camera's size: no PIL
    with pytest.raises(ValueError, match=r"a\.png.*\(12, 10\).*\(6, 5\)"):
        load_rgb(str(p), 6, 5)


def _rgb_fixture(root, n_cams=4):
    """build_fixture's COLMAP scene and SfM cloud plus PNG images rendered
    from a synthetic scene."""
    build_fixture(root, n_cams=n_cams, feature_dim=16, clip=512)
    raw = make_scene(40, seed=5)
    t = {k: torch.as_tensor(v) for k, v in raw.items()}
    os.makedirs(os.path.join(root, "images"))
    for ci in detect_and_load(root, foundation_model="none").train_cameras:
        cam = camera_from_info(ci, 1)
        out = render(cam, means=t["means"], quats=t["quats"], scales=t["scales"],
                     opacities=t["opacities"], sh=t["sh"], sh_degree=3, bg_color=torch.zeros(3),
                     config=RasterizeConfig(tile_h=8, tile_w=16, chunk=8), device="cpu")
        with open(ci.image_path, "wb") as f:
            f.write(encode_png(out.render.numpy()))


def test_train_rgb_cli_end_to_end(tmp_path):
    root, model = str(tmp_path / "scene"), str(tmp_path / "model")
    _rgb_fixture(root)
    main(["-s", root, "-m", model, "--iterations", "5", "--save_iterations", "3",
          "--device", "cpu"])
    for it in (3, 5):
        ply = os.path.join(model, "point_cloud", f"iteration_{it}", "point_cloud.ply")
        port = GaussianScene.from_ply(ply)
        jax_scene = JScene.from_ply(ply)
        assert port.num_gaussians == jax_scene.num_gaussians == 30  # the seed cloud, all alive
        assert port.sh.shape == (30, 16, 3)
        np.testing.assert_array_equal(port.means.numpy(), np.asarray(jax_scene.means))
    assert os.path.exists(os.path.join(model, "metrics.jsonl"))
    # the snapshot is the pretrained scene of GAD distillation (--ply)
    gad = str(tmp_path / "gad")
    train_gad_main(["-s", root, "-m", gad, "--ply", ply, "-r", "1", "--iterations", "2",
                    "--save_iterations", "2", "--test_iterations", "", "--device", "cpu"])
    out = GaussianScene.from_ply(os.path.join(gad, "point_cloud", "iteration_2", "point_cloud.ply"))
    assert out.num_gaussians == 30 and out.semantic_features.shape == (30, 16)


def test_train_rgb_run_densifies(tmp_path):
    """run() with a short densify schedule: densify at 4 and 8, counts
    reported through on_step, finite losses."""
    root, model = str(tmp_path / "scene"), str(tmp_path / "model")
    _rgb_fixture(root, n_cams=3)
    cfg = RgbConfig(densify_from_iter=2, densification_interval=4, densify_until_iter=10,
                    densify_grad_threshold=0.0, raster=RasterizeConfig(
                        tile_h=8, tile_w=16, chunk=8, geometry_grads=True))
    seen = []
    state = run(RunConfig(source_path=root, model_path=model, iterations=10, save_iterations="",
                          capacity_factor=3, device="cpu"), cfg,
                on_step=lambda it, st, m: seen.append(
                    (it, int(st.alive.sum()), None if m is None else float(m["loss"]))))
    assert [s[0] for s in seen] == list(range(11))
    assert all(np.isfinite(s[2]) for s in seen[1:])
    alive = [s[1] for s in seen]
    # threshold 0: every visible seed Gaussian clones or splits at 4 (the
    # counts seen at a step are taken before that step's densification)
    assert alive[0] == alive[4] == 30 and alive[5] > 30
    assert state.step == 10 and state.capacity == 90
    ply = os.path.join(model, "point_cloud", "iteration_10", "point_cloud.ply")
    assert GaussianScene.from_ply(ply).num_gaussians == int(state.alive.sum())


def test_train_rgb_defaults_to_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["-s", str(tmp_path), "-m", str(tmp_path / "m")])
