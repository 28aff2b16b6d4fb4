"""The port's image I/O without PIL against PIL (Pillow 12 with libjpeg-turbo
3), bit for bit, on the CPU: the JPEG decoder (gags_torch.utils.jpeg) over a
seeded grid of sizes, samplings, qualities, Huffman optimisation,
progression and restart intervals, and on files with h1v2 / h4v1 sampling
that Pillow cannot write; Pillow's BILINEAR, BICUBIC and LANCZOS resamples
(utils.image.resize_uint8); encode_jpeg against Pillow's own file (equal
bytes); the committed fixtures of tests/data/torch_jpeg against their
stored PIL pixels, in this process and in one where PIL cannot be
imported (read_rgb, load_rgb with a resize, gas.load_image_1080p and
convert's pyramid); and the files the decoder refuses."""

import io
import itertools
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from gags_torch.utils import jpeg
from gags_torch.utils.image import load_rgb, read_rgb, resize_uint8

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data", "torch_jpeg")
FIXTURES = sorted(f for f in os.listdir(DATA) if f.endswith(".jpg"))


def _pixels(h, w, seed):
    """Gradients plus noise: busy in every coefficient band."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx * 7 + yy * 3) % 256, (yy * 11) % 256, (xx * yy) % 256], -1)
    return np.clip(base + rng.normal(0, 40, base.shape), 0, 255).astype(np.uint8)


def _pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


# -- the decoder against PIL: a seeded grid ---------------------------------

SIZES = [(1, 1), (1, 2), (2, 1), (2, 3), (3, 5), (7, 9), (8, 8), (9, 17), (16, 16),
         (17, 33), (31, 47), (50, 70), (64, 48), (13, 21), (40, 3)]
QUALITIES = [1, 10, 50, 75, 95, 100]
MODES = ["baseline", "optimize", "progressive", "restart_blocks", "restart_rows"]
SAMPLINGS = ["444", "422", "420", "grey"]


def _grid():
    """Three cases for each (mode, sampling), sizes and qualities drawn
    from a seeded generator so every size and quality occurs."""
    rng = np.random.default_rng(13)
    cases = []
    for i, (mode, samp) in enumerate(itertools.product(MODES, SAMPLINGS)):
        for j in range(3):
            k = 3 * i + j
            pick = k % len(SIZES) if k < 2 * len(SIZES) else int(rng.integers(len(SIZES)))
            h, w = SIZES[pick]
            cases.append((h, w, QUALITIES[int(rng.integers(len(QUALITIES)))], mode, samp))
    return cases


@pytest.mark.parametrize("h,w,quality,mode,sampling", _grid())
def test_decoder_matches_pil(h, w, quality, mode, sampling):
    a = _pixels(h, w, 1000 * h + w + quality)
    kw = dict(quality=quality)
    if sampling != "grey":
        kw["subsampling"] = {"444": 0, "422": 1, "420": 2}[sampling]
    kw.update({"baseline": {}, "optimize": dict(optimize=True),
               "progressive": dict(progressive=True),
               "restart_blocks": dict(restart_marker_blocks=2),
               "restart_rows": dict(restart_marker_rows=1, progressive=True)}[mode])
    buf = io.BytesIO()
    Image.fromarray(a[..., 0] if sampling == "grey" else a).save(buf, "JPEG", **kw)
    got = jpeg.decode_jpeg(buf.getvalue(), "cpu")
    assert got.dtype == torch.uint8 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got.numpy(), _pil_rgb(buf.getvalue()))


@pytest.mark.parametrize("sampling", [((1, 2), (1, 1), (1, 1)), ((4, 1), (1, 1), (1, 1)),
                                      ((1, 4), (1, 1), (1, 1)), ((4, 2), (1, 1), (1, 1)),
                                      ((2, 2), (1, 2), (2, 1))],
                         ids=["h1v2", "h4v1", "h1v4", "h4v2", "mixed"])
def test_decoder_other_samplings_match_pil(sampling):
    """Samplings Pillow cannot write, written by encode_jpeg: h1v2 fancy
    upsampling, box replication for the others."""
    for h, w in [(1, 1), (2, 3), (5, 4), (7, 9), (9, 17), (17, 33), (31, 47), (40, 3)]:
        data = jpeg.encode_jpeg(_pixels(h, w, h + w), quality=90, sampling=sampling)
        np.testing.assert_array_equal(jpeg.decode_jpeg(data, "cpu").numpy(), _pil_rgb(data),
                                      err_msg=f"{h}x{w}")


def test_scan_blocks_cover_each_block_once():
    """Both entropy decoders walk `JpegFile.scan_plan`: a scan's blocks,
    in coding order, name each coefficient block once, in as many restart
    intervals as the file holds."""
    for kw in (dict(progressive=True), dict(restart_marker_blocks=3), {}):
        buf = io.BytesIO()
        Image.fromarray(_pixels(21, 37, 3)).save(buf, "JPEG", **kw)
        jf = jpeg.parse_jpeg(buf.getvalue())
        for scan in jf.scans:
            blocks = jf.scan_blocks(scan)
            assert len(np.unique(blocks)) == blocks.size
            assert len(scan.segments) == -(-blocks.shape[0] // (scan.restart or blocks.shape[0]))


# -- Pillow's resamples -----------------------------------------------------

RESIZES = [((10, 12), (5, 6)), ((10, 12), (23, 31)), ((33, 47), (33, 20)),
           ((33, 47), (70, 47)), ((64, 48), (1, 1)), ((9, 1), (1, 5)), ((1, 7), (3, 1)),
           ((100, 37), (25, 74)), ((720, 1280), (360, 640))]


@pytest.mark.parametrize("filt", ["bilinear", "bicubic", "lanczos"])
@pytest.mark.parametrize("hw,out", RESIZES)
def test_resize_matches_pil(filt, hw, out):
    """Down and up, each axis alone, 1-pixel outputs: every pixel equal."""
    rng = np.random.default_rng(sum(hw) + sum(out))
    img = rng.integers(0, 256, (*hw, 3), np.uint8)
    img[: hw[0] // 3] = np.linspace(0, 255, hw[1])[None, :, None].astype(np.uint8)
    want = np.asarray(Image.fromarray(img).resize(out[::-1], getattr(Image, filt.upper())))
    np.testing.assert_array_equal(resize_uint8(img, out, filt), want)
    got_t = resize_uint8(torch.from_numpy(img), out, filt)
    assert isinstance(got_t, torch.Tensor)
    np.testing.assert_array_equal(got_t.numpy(), want)


# -- encode_jpeg --------------------------------------------------------------


@pytest.mark.parametrize("h,w,quality", [(1, 1, 75), (7, 9, 75), (13, 21, 75), (16, 16, 1),
                                         (31, 47, 50), (50, 70, 95), (33, 1, 100),
                                         (1, 40, 10), (720, 1280, 75)])
def test_encode_jpeg_is_pillows_file(h, w, quality):
    """Pillow's save at its defaults (4:2:0, the standard tables) and the
    given quality: the same bytes, so the same pixels; also grey."""
    a = _pixels(h, w, h * w + quality)
    if h == 720:
        a = (a // 8 + np.arange(w, dtype=np.uint8)[None, :, None] // 6).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, "JPEG", quality=quality)
    data = jpeg.encode_jpeg(a, quality=quality)
    assert data == buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray(a[..., 1]).save(buf, "JPEG", quality=quality)
    assert jpeg.encode_jpeg(a[..., 1], quality=quality) == buf.getvalue()


def test_encode_jpeg_refuses_what_libjpeg_refuses():
    with pytest.raises(ValueError, match="more than 10 blocks"):
        jpeg.encode_jpeg(_pixels(8, 8, 0), sampling=((2, 4), (1, 2), (1, 1)))
    with pytest.raises(ValueError, match="uint8"):
        jpeg.encode_jpeg(np.zeros((4, 4, 3), np.float32))


# -- the committed fixtures ---------------------------------------------------


@pytest.fixture(scope="module")
def stored():
    with np.load(os.path.join(DATA, "pixels.npz")) as d:
        return {k: d[k] for k in d.files}


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_matches_stored_pixels(name, stored):
    path = os.path.join(DATA, name)
    np.testing.assert_array_equal(np.asarray(Image.open(path).convert("RGB")), stored[name])
    got = read_rgb(path, "cpu")
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), stored[name])


def test_fixtures_cover_every_mode():
    kinds = set()
    for name in FIXTURES:
        with open(os.path.join(DATA, name), "rb") as f:
            jf = jpeg.parse_jpeg(f.read(), name)
        kinds.add(jf.colour)
        kinds.add("progressive" if jf.progressive else "sequential")
        kinds.update("restart" for s in jf.scans if s.restart)
        kinds.add(tuple((c.h, c.v) for c in jf.comps))
    assert {"grey", "ycc", "rgb", "progressive", "sequential", "restart", ((1, 1),),
            ((2, 2), (1, 1), (1, 1)), ((2, 1), (1, 1), (1, 1)), ((1, 1), (1, 1), (1, 1)),
            ((1, 2), (1, 1), (1, 1)), ((4, 1), (1, 1), (1, 1))} <= kinds


_NO_PIL = r"""
import os, sys
sys.modules["PIL"] = None
import numpy as np
from gags_torch.cli import convert, gas
from gags_torch.utils.image import load_rgb, read_rgb
data, work = sys.argv[1], sys.argv[2]
with np.load(os.path.join(data, "pixels.npz")) as d:
    want = {k: d[k] for k in d.files}
names = sorted(f for f in os.listdir(data) if f.endswith(".jpg"))
for n in names:
    assert np.array_equal(read_rgb(os.path.join(data, n), "cpu").numpy(), want[n]), n
for key in [k for k in want if k.startswith("load_rgb/")]:
    _, n, size = key.split("/")
    w, h = map(int, size.split("x"))
    assert np.array_equal(load_rgb(os.path.join(data, n), w, h, "cpu").numpy(), want[key]), key
tall = "tall_1090x16.jpg"
assert np.array_equal(gas.load_image_1080p(os.path.join(data, tall), "cpu"), want["1080p/" + tall])
os.makedirs(os.path.join(work, "images"))
pyr = sorted({k.split("/")[1] for k in want if k.startswith("pyramid/")})
for n in pyr:
    with open(os.path.join(data, n), "rb") as src, open(os.path.join(work, "images", n), "wb") as dst:
        dst.write(src.read())
convert._resize_pyramid(work, "cpu")
for n in pyr:
    for div in (2, 4, 8):
        got = read_rgb(os.path.join(work, f"images_{div}", n), "cpu").numpy()
        assert np.array_equal(got, want[f"pyramid/{n}/{div}"]), (n, div)
assert sys.modules["PIL"] is None
print("ok", len(names))
"""


def test_fixtures_without_pil(tmp_path):
    out = subprocess.run([sys.executable, "-c", _NO_PIL, DATA, str(tmp_path)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ok", str(len(FIXTURES))]


def test_convert_pyramid_writes_pillows_files(tmp_path, stored):
    """The pyramid's files are the bytes the JAX CLI's Pillow writes."""
    names = ["rgb420_progressive_50x70.jpg", "grey_q75_31x47.jpg"]
    os.makedirs(tmp_path / "images")
    for n in names:
        shutil.copy(os.path.join(DATA, n), tmp_path / "images" / n)
    from gags_torch.cli import convert

    convert._resize_pyramid(str(tmp_path), "cpu")
    for n in names:
        img = Image.open(os.path.join(DATA, n))
        for div in (2, 4, 8):
            buf = io.BytesIO()
            img.resize((img.width // div, img.height // div), Image.LANCZOS).save(buf, "JPEG")
            with open(tmp_path / f"images_{div}" / n, "rb") as f:
                assert f.read() == buf.getvalue(), (n, div)


# -- what the decoder refuses -------------------------------------------------


def _base_file(**kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(_pixels(24, 40, 5)).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _sof_patched(marker: int = None, precision: int = None) -> bytes:
    d = bytearray(_base_file())
    i = d.index(b"\xff\xc0")
    if marker is not None:
        d[i + 1] = marker
    if precision is not None:
        d[i + 4] = precision
    return bytes(d)


def _cmyk() -> bytes:
    buf = io.BytesIO()
    Image.fromarray(_pixels(16, 16, 2)).convert("CMYK").save(buf, "JPEG")
    return buf.getvalue()


def _incomplete_progressive() -> bytes:
    """Pillow's progressive file cut after its first four scans (the DC
    scan and the first AC bands, refinements missing): libjpeg would
    smooth its blocks."""
    d = _base_file(progressive=True)
    sos = [i for i in range(len(d) - 1) if d[i] == 0xFF and d[i + 1] == 0xDA]
    return d[:sos[4]] + b"\xff\xd9"


def _dht(tc: int, th: int, counts, symbols) -> bytes:
    body = bytes([tc << 4 | th]) + bytes(counts) + bytes(symbols)
    return b"\xff\xc4" + (len(body) + 2).to_bytes(2, "big") + body


def _table(data: bytes, tc: int, th: int):
    """(counts, symbols) of a table that `data` defines in a DHT marker."""
    i = 2
    while data[i + 1] != 0xDA:
        end = i + 2 + int.from_bytes(data[i + 2:i + 4], "big")
        j = i + 4
        while data[i + 1] == 0xC4 and j < end:
            counts = list(data[j + 1:j + 17])
            if data[j] == tc << 4 | th:
                return counts, list(data[j + 17:j + 17 + sum(counts)])
            j += 17 + sum(counts)
        i = end
    raise KeyError((tc, th))


def _tables_patched(*dhts: bytes) -> bytes:
    """Pillow's baseline file with DHT markers added before its scan (a
    table defined again replaces the earlier one)."""
    d = _base_file()
    sos = d.index(b"\xff\xda")
    return d[:sos] + b"".join(dhts) + d[sos:]


def _dc_symbol_16() -> bytes:
    counts, syms = _table(_base_file(), 0, 0)
    return _tables_patched(_dht(0, 0, counts, syms[:-1] + [16]))


def _all_ones_code() -> bytes:
    """The luminance DC table with one more symbol at its longest length:
    it takes the all-ones code, which libjpeg keeps free."""
    counts, syms = _table(_base_file(), 0, 0)
    longest = max(i for i in range(16) if counts[i])
    counts[longest] += 1
    return _tables_patched(_dht(0, 0, counts, syms + [max(syms) + 1]))


REFUSED = {
    "arithmetic": (lambda: _sof_patched(marker=0xC9), "arithmetic"),
    "12-bit": (lambda: _sof_patched(precision=12), "12-bit"),
    "lossless": (lambda: _sof_patched(marker=0xC3), "lossless"),
    "cmyk": (_cmyk, "CMYK"),
    "truncated": (lambda: _base_file()[:400], "truncated"),
    "no_eoi": (lambda: _base_file()[:-2], "truncated"),
    "smoothing": (_incomplete_progressive, "smoothing"),
    "dc_symbol": (_dc_symbol_16, "DC symbol above 15"),
    "code_overflow": (_all_ones_code, "overflow"),
}
# the refused files that Pillow (libjpeg) refuses too, and its message
PIL_REFUSES = {"truncated": "(?i)truncated", "no_eoi": "(?i)truncated",
               "dc_symbol": "broken data stream", "code_overflow": "broken data stream"}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_unsupported_jpeg_raises_naming_file(case, tmp_path):
    make, why = REFUSED[case]
    p = tmp_path / f"{case}.jpg"
    p.write_bytes(make())
    with pytest.raises(ValueError, match=rf"{case}\.jpg: .*{why}"):
        read_rgb(str(p), "cpu")
    if case in PIL_REFUSES:
        with pytest.raises(OSError, match=PIL_REFUSES[case]):
            Image.open(p).convert("RGB")


def _ac_eob_recoded() -> bytes:
    """The luminance AC table with its EOB symbol (0x00) renamed 0x30, a
    run of 3 with no bits: a sequential scan reads it as EOB."""
    counts, syms = _table(_base_file(), 1, 0)
    return _tables_patched(_dht(1, 0, counts, [0x30 if s == 0 else s for s in syms]))


@pytest.mark.parametrize("make", [
    lambda: _tables_patched(_dht(0, 2, [0, 1] + [0] * 14, [200]),
                            _dht(1, 3, [3] + [0] * 15, [1, 2, 3])),
    _ac_eob_recoded], ids=["unused_bad_tables", "ac_eob_recoded"])
def test_huffman_tables_libjpeg_accepts(make):
    """libjpeg checks a Huffman table when a scan uses it, and a sequential
    scan ends a block at any size-0 AC symbol other than ZRL: these files
    decode, to PIL's pixels."""
    data = make()
    np.testing.assert_array_equal(jpeg.decode_jpeg(data, "cpu").numpy(), _pil_rgb(data))


@pytest.mark.parametrize("fmt", ["WEBP", "BMP", "16-bit PNG"])
def test_other_formats_raise_naming_file(fmt, tmp_path):
    p = tmp_path / "img.bin"
    a = _pixels(8, 8, 1)
    if fmt == "16-bit PNG":
        Image.fromarray(a[..., 0].astype(np.uint16) * 257).save(p, "PNG")
    else:
        Image.fromarray(a).save(p, fmt)
    with pytest.raises(ValueError, match=r"img\.bin: neither a JPEG nor"):
        read_rgb(str(p), "cpu")
    with pytest.raises(ValueError, match=r"img\.bin"):
        load_rgb(str(p), 4, 4, "cpu")
