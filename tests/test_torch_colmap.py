"""gags_torch.scene.colmap / scene.dataset vs gags_tpu: COLMAP files
written by one package and read by the other, scene detection, the
resolution policy, the eval split and the Blender reader's PNG sizes."""

import json
import os
import struct
import zlib

import numpy as np
import pytest

from gags_tpu.scene import colmap as jcm
from gags_tpu.scene import dataset as jds
from gags_torch.scene import colmap as tcm
from gags_torch.scene import dataset as tds
from gags_torch.utils.image import encode_png
from test_torch_train_cli import build_fixture

PACKAGES = {"jax": jcm, "torch": tcm}


def _cams(cm):
    return {
        1: cm.ColmapCamera(1, "PINHOLE", 64, 32, np.array([40.0, 41.0, 32.0, 16.0])),
        2: cm.ColmapCamera(2, "SIMPLE_PINHOLE", 50, 20, np.array([30.0, 25.0, 10.0])),
    }


def _imgs(cm, rng):
    out = {}
    for i in range(5):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        out[i + 1] = cm.ColmapImage(i + 1, q, rng.normal(size=3), 1 + i % 2, f"im{i:02d}.jpg")
    return out


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_colmap_binary_cross_read(tmp_path, writer, reader):
    w, r = PACKAGES[writer], PACKAGES[reader]
    rng = np.random.default_rng(0)
    imgs = _imgs(w, rng)
    xyz = rng.normal(size=(20, 3))
    rgb = rng.integers(0, 255, (20, 3))
    w.write_cameras_binary(str(tmp_path / "cameras.bin"), _cams(w))
    w.write_images_binary(str(tmp_path / "images.bin"), imgs)
    w.write_points3d_binary(str(tmp_path / "points3D.bin"), xyz, rgb)
    cams = r.read_cameras_binary(str(tmp_path / "cameras.bin"))
    back = r.read_images_binary(str(tmp_path / "images.bin"))
    x2, c2, _ = r.read_points3d_binary(str(tmp_path / "points3D.bin"))
    assert {k: (c.model, c.width, c.height) for k, c in cams.items()} == {
        1: ("PINHOLE", 64, 32), 2: ("SIMPLE_PINHOLE", 50, 20)}
    np.testing.assert_array_equal(cams[2].params, [30.0, 25.0, 10.0])
    for k, im in imgs.items():
        np.testing.assert_array_equal(back[k].qvec, im.qvec)
        np.testing.assert_array_equal(back[k].tvec, im.tvec)
        assert (back[k].camera_id, back[k].name) == (im.camera_id, im.name)
    np.testing.assert_array_equal(x2, xyz)
    np.testing.assert_array_equal(c2, rgb)
    # the two writers produce the same bytes
    other = PACKAGES[reader]
    other.write_images_binary(str(tmp_path / "again.bin"), imgs)
    assert (tmp_path / "again.bin").read_bytes() == (tmp_path / "images.bin").read_bytes()


def test_colmap_text_readers_match(tmp_path):
    (tmp_path / "cameras.txt").write_text(
        "# comment\n1 PINHOLE 64 32 40 41 32 16\n2 SIMPLE_PINHOLE 50 20 30 25 10\n")
    (tmp_path / "images.txt").write_text(
        "# images\n1 0.9 0.1 0.3 0.2 0.5 -1 2 1 a.png\n1 2 3\n"
        "2 1 0 0 0 0 0 0 2 b.png\n\n")
    (tmp_path / "points3D.txt").write_text("1 0.5 1 2 10 20 30 0.1\n2 -1 0 3 1 2 3 0.5\n")
    for fn in ("read_cameras_text", "read_images_text"):
        path = str(tmp_path / ("cameras.txt" if "cameras" in fn else "images.txt"))
        a, b = getattr(jcm, fn)(path), getattr(tcm, fn)(path)
        assert a.keys() == b.keys()
        for k in a:
            for x, y in zip(a[k], b[k]):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for x, y in zip(jcm.read_points3d_text(str(tmp_path / "points3D.txt")),
                    tcm.read_points3d_text(str(tmp_path / "points3D.txt"))):
        np.testing.assert_array_equal(x, y)


def test_quaternion_conversions_match():
    rng = np.random.default_rng(1)
    for _ in range(10):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        R = tcm.qvec_to_rotmat(q)
        np.testing.assert_allclose(R, jcm.qvec_to_rotmat(q), atol=1e-12)
        np.testing.assert_allclose(tcm.rotmat_to_qvec(R), jcm.rotmat_to_qvec(R), atol=1e-9)
        np.testing.assert_allclose(tcm.qvec_to_rotmat(tcm.rotmat_to_qvec(R)), R, atol=1e-9)


@pytest.mark.parametrize("eval_split", [False, True])
def test_detect_and_load_matches_jax(tmp_path, eval_split):
    root = str(tmp_path / "scene")
    build_fixture(root, n_cams=11)
    a = jds.detect_and_load(root, eval_split=eval_split)
    b = tds.detect_and_load(root, eval_split=eval_split)
    if eval_split:
        assert [c.name for c in b.test_cameras] == ["img002.png", "img010.png"]
    assert len(b.train_cameras) == len(a.train_cameras)
    assert [c.name for c in b.test_cameras] == [c.name for c in a.test_cameras]
    np.testing.assert_allclose(b.radius, a.radius, rtol=1e-12)
    np.testing.assert_allclose(b.translate, a.translate, rtol=1e-12)
    assert os.path.basename(b.points_path) == "points3D.ply"
    for ca, cb in zip(a.train_cameras, b.train_cameras):
        np.testing.assert_allclose(cb.R, ca.R, atol=1e-12)
        np.testing.assert_allclose(cb.T, ca.T, atol=1e-12)
        assert (cb.fovx, cb.fovy, cb.width, cb.height, cb.f_path, cb.s_path) == (
            ca.fovx, ca.fovy, ca.width, ca.height, ca.f_path, ca.s_path)
        assert tds.camera_to_json(3, cb) == jds.camera_to_json(3, ca)
        for res in (1, 2, 4, 8, -1, -2):
            jc, tc = jds.camera_from_info(ca, res), tds.camera_from_info(cb, res)
            assert (tc.width, tc.height) == (jc.width, jc.height)
            np.testing.assert_allclose(tc.viewmat.numpy(), np.asarray(jc.viewmat), atol=1e-6)
            np.testing.assert_allclose(tc.K.numpy(), np.asarray(jc.K), rtol=1e-6)


@pytest.mark.parametrize("w,h,res,feature_hw", [
    (1957, 1091, -1, None), (1200, 700, -1, None), (640, 480, -2, None),
    (640, 480, 0, (240, 320)), (979, 545, 1, None), (979, 545, 2, None),
    (979, 545, 4, None), (979, 545, 8, None), (1000, 600, 3, None),
])
def test_resolution_policy_matches_jax(w, h, res, feature_hw):
    assert tds.resolve_resolution(w, h, res, feature_hw) == jds.resolve_resolution(
        w, h, res, feature_hw)


def test_resolution_zero_needs_feature_size():
    with pytest.raises(ValueError):
        tds.resolve_resolution(640, 480, 0)


def _write_png_rgba(path, w, h):
    """A PNG written with the standard library alone (8-bit RGBA)."""
    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    rows = b"".join(b"\x00" + bytes(4 * w) for _ in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


def test_blender_reader_png_sizes(tmp_path):
    root = tmp_path / "lego"
    (root / "train").mkdir(parents=True)
    frames = []
    for i in range(3):
        ang = 2 * np.pi * i / 3
        c2w = np.eye(4)
        c2w[:3, 3] = [4 * np.cos(ang), 0.0, 4 * np.sin(ang)]
        frames.append(dict(file_path=f"./train/r_{i}", transform_matrix=c2w.tolist()))
    (root / "transforms_train.json").write_text(json.dumps(dict(camera_angle_x=0.6911,
                                                                frames=frames)))
    _write_png_rgba(str(root / "train" / "r_0.png"), 37, 21)
    with open(root / "train" / "r_1.png", "wb") as f:
        f.write(encode_png(np.zeros((9, 13, 3))))
    info = tds.detect_and_load(str(root))
    sizes = [(c.width, c.height) for c in info.train_cameras]
    assert sizes == [(37, 21), (13, 9), (800, 800)]  # r_2.png is absent: the default
    assert tds.png_size(str(root / "train" / "r_0.png")) == (37, 21)
    cam = info.train_cameras[0]
    assert abs(cam.fovx - 0.6911) < 1e-6
    np.testing.assert_allclose(cam.fovy, 2 * np.arctan(21 / (2 * 0.5 * 37 / np.tan(0.5 * 0.6911))))
    (root / "bad.png").write_bytes(b"not a png at all, no header here")
    with pytest.raises(ValueError):
        tds.png_size(str(root / "bad.png"))
