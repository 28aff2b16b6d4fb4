"""gags_torch.cli.convert against gags_tpu.cli.convert with a fake `colmap`
executable that logs its argv: the same command sequence (the source dir
written as <src>), the undistorted model moved into sparse/0, and --resize
where PIL cannot be imported: the pyramid the JAX CLI's PIL writes."""

import io
import json
import os
import stat
import sys

import numpy as np
import pytest

from gags_torch.cli import convert


def _fake_colmap(tmp_path):
    """An executable that appends its argv to log.jsonl and, as
    image_undistorter, writes sparse/cameras.bin under --output_path."""
    path = tmp_path / "colmap"
    log = tmp_path / "log.jsonl"
    path.write_text(
        f"#!{sys.executable}\n"
        "import json, os, sys\n"
        f"with open({str(log)!r}, 'a') as f:\n"
        "    f.write(json.dumps(sys.argv[1:]) + '\\n')\n"
        "if sys.argv[1] == 'image_undistorter':\n"
        "    out = sys.argv[sys.argv.index('--output_path') + 1]\n"
        "    os.makedirs(os.path.join(out, 'sparse'), exist_ok=True)\n"
        "    open(os.path.join(out, 'sparse', 'cameras.bin'), 'wb').close()\n")
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return str(path), log


def _commands(log, src):
    cmds = [json.loads(line) for line in open(log)]
    return [[a.replace(src, "<src>") for a in c] for c in cmds]


@pytest.mark.parametrize("flags", [[], ["--no_gpu", "--camera", "PINHOLE"], ["--skip_matching"]],
                         ids=["default", "no_gpu_pinhole", "skip_matching"])
def test_convert_runs_the_jax_command_sequence(tmp_path, monkeypatch, flags):
    import gags_tpu.cli.convert as jconvert

    seqs = []
    for name, call in (("torch", lambda argv: convert.main(argv)),
                       ("jax", lambda argv: (monkeypatch.setattr(sys, "argv", ["convert"] + argv),
                                             jconvert.main()))):
        d = tmp_path / name
        d.mkdir()
        colmap, log = _fake_colmap(d)
        src = str(d / "scene")
        os.makedirs(os.path.join(src, "input"))
        call(["-s", src, "--colmap_executable", colmap] + flags)
        seqs.append(_commands(log, src))
        assert os.listdir(os.path.join(src, "sparse")) == ["0"]
        assert os.path.exists(os.path.join(src, "sparse", "0", "cameras.bin"))
    assert seqs[0] == seqs[1]
    steps = [c[0] for c in seqs[0]]
    if "--skip_matching" in flags:
        assert steps == ["image_undistorter"]
    else:
        assert steps == ["feature_extractor", "exhaustive_matcher", "mapper", "image_undistorter"]


def test_convert_fails_on_a_colmap_error(tmp_path):
    bad = tmp_path / "colmap"
    bad.write_text(f"#!{sys.executable}\nimport sys\nsys.exit(3)\n")
    bad.chmod(bad.stat().st_mode | stat.S_IXUSR)
    with pytest.raises(SystemExit, match=r"command failed \(3\)"):
        convert.run(str(tmp_path / "scene"), colmap_executable=str(bad))


def test_resize_without_pil_says_so(tmp_path, monkeypatch):
    """--resize with PIL unimportable writes what the JAX CLI's PIL writes
    (LANCZOS, saved in the source's format): the same JPEG bytes and PNG
    pixels."""
    from PIL import Image

    from gags_torch.utils.image import read_rgb

    colmap, _ = _fake_colmap(tmp_path)
    src = tmp_path / "scene"
    os.makedirs(src / "images")
    a = np.random.default_rng(0).integers(0, 256, (37, 53, 3), np.uint8)
    Image.fromarray(a).save(src / "images" / "a.jpg")
    Image.fromarray(a).save(src / "images" / "b.png")
    want = {}
    for name, fmt in (("a.jpg", "JPEG"), ("b.png", "PNG")):
        img = Image.open(src / "images" / name)
        for div in (2, 4, 8):
            buf = io.BytesIO()
            img.resize((img.width // div, img.height // div), Image.LANCZOS).save(buf, fmt)
            want[name, div] = (buf.getvalue(), np.asarray(Image.open(buf).convert("RGB")))
    monkeypatch.setitem(sys.modules, "PIL", None)
    convert.run(str(src), colmap_executable=colmap, skip_matching=True, resize=True,
                device="cpu")
    for (name, div), (data, px) in want.items():
        path = src / f"images_{div}" / name
        if name.endswith(".jpg"):
            assert path.read_bytes() == data
        np.testing.assert_array_equal(read_rgb(str(path), "cpu").numpy(), px)
