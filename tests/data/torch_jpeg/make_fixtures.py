"""Write the JPEG fixtures of tests/test_torch_jpeg.py and their pixels as
PIL gives them.

  python tests/data/torch_jpeg/make_fixtures.py   (from the repository root)

Each fixture is a small JPEG that Pillow writes (one of each mode the
decoder meets: sampling, quality, Huffman optimisation, progression,
restart intervals, an Adobe RGB file, images 1-3 pixels wide), plus two
that Pillow cannot write (h1v2 and h4v1 sampling, written by
gags_torch.utils.jpeg.encode_jpeg). `pixels.npz` holds, under each file
name, ``Image.open(f).convert("RGB")``; under "load_rgb/<name>/<w>x<h>"
that image resized with Pillow's default (BICUBIC) filter, as the JAX RGB
trainer loads it; under "1080p/<name>" the JAX GAS loader's image; and
under "pyramid/<name>/<div>" the pixels of the file the JAX convert CLI
writes into images_<div>/ (a LANCZOS resize saved in the source's format,
decoded by PIL).
"""

from __future__ import annotations

import io
import os
import sys

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "..", ".."))

from gags_torch.utils.jpeg import encode_jpeg  # noqa: E402

# name: (height, width, how): Pillow's save keywords; "L" ("L progressive") for a grey
# image; or the sampling factors encode_jpeg writes
FIXTURES = {
    "rgb420_q75_13x21.jpg": (13, 21, {}),
    "rgb444_q95_9x17.jpg": (9, 17, dict(quality=95, subsampling=0)),
    "rgb422_q50_17x33.jpg": (17, 33, dict(quality=50, subsampling=1)),
    "grey_q75_31x47.jpg": (31, 47, "L"),
    "rgb420_q1_50x70.jpg": (50, 70, dict(quality=1)),
    "rgb420_q100_16x16.jpg": (16, 16, dict(quality=100)),
    "rgb420_q10_optimize_33x47.jpg": (33, 47, dict(quality=10, optimize=True)),
    "rgb420_progressive_50x70.jpg": (50, 70, dict(progressive=True)),
    "grey_progressive_23x19.jpg": (23, 19, "L progressive"),
    "rgb444_progressive_q10_31x29.jpg": (31, 29, dict(progressive=True, quality=10,
                                                      subsampling=0)),
    "rgb420_restart_blocks_24x40.jpg": (24, 40, dict(restart_marker_blocks=3)),
    "rgb422_restart_rows_progressive_27x45.jpg": (27, 45, dict(
        restart_marker_rows=1, progressive=True, subsampling=1)),
    "rgb_adobe_37x23.jpg": (37, 23, dict(keep_rgb=True)),
    "rgb420_1x1.jpg": (1, 1, {}),
    "rgb420_2x2.jpg": (2, 2, {}),
    "rgb422_9x2.jpg": (9, 2, dict(subsampling=1)),
    "rgb420_5x3.jpg": (5, 3, {}),
    "h1v2_19x13.jpg": (19, 13, ((1, 2), (1, 1), (1, 1))),
    "h4v1_21x35.jpg": (21, 35, ((4, 1), (1, 1), (1, 1))),
    "tall_1090x16.jpg": (1090, 16, dict(quality=90)),
}
LOAD_RGB = {"rgb420_progressive_50x70.jpg": [(35, 25), (90, 64)],
            "rgb422_q50_17x33.jpg": [(16, 8)]}
PYRAMID = ("rgb420_progressive_50x70.jpg", "grey_q75_31x47.jpg")


def pixels(h: int, w: int, seed: int) -> np.ndarray:
    """Gradients with texture: every coefficient band is busy, and the
    tall image stays small."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx * 9 + yy * 2) % 256, (yy * 5) % 256, (xx * yy // 3) % 256], -1)
    noise = rng.normal(0, 24, base.shape) if h < 100 else 0
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def main() -> None:
    out = {}
    for i, (name, (h, w, how)) in enumerate(FIXTURES.items()):
        a = pixels(h, w, i)
        path = os.path.join(HERE, name)
        if isinstance(how, str):  # grey
            Image.fromarray(a[..., 0]).save(path, "JPEG", progressive="progressive" in how)
        elif isinstance(how, dict):
            Image.fromarray(a).save(path, "JPEG", **how)
        else:
            with open(path, "wb") as f:
                f.write(encode_jpeg(a, quality=90, sampling=how))
        out[name] = np.asarray(Image.open(path).convert("RGB"))
    for name, sizes in LOAD_RGB.items():
        for w, h in sizes:
            img = Image.open(os.path.join(HERE, name)).convert("RGB").resize((w, h))
            out[f"load_rgb/{name}/{w}x{h}"] = np.asarray(img)
    img = Image.open(os.path.join(HERE, "tall_1090x16.jpg")).convert("RGB")
    w, h = img.size
    out["1080p/tall_1090x16.jpg"] = np.asarray(
        img.resize((int(round(w * 1080 / h)), 1080), Image.BILINEAR))
    for name in PYRAMID:
        for div in (2, 4, 8):
            img = Image.open(os.path.join(HERE, name))
            buf = io.BytesIO()
            img.resize((img.width // div, img.height // div), Image.LANCZOS).save(buf, "JPEG")
            out[f"pyramid/{name}/{div}"] = np.asarray(Image.open(buf).convert("RGB"))
    np.savez_compressed(os.path.join(HERE, "pixels.npz"), **out)


if __name__ == "__main__":
    main()
