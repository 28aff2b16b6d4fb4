"""COLMAP SfM driver (port of gags_tpu.cli.convert), the reference's `convert.py`.

Runs feature extraction → exhaustive matching → mapping → undistortion
through the external `colmap` binary (a subprocess each, not os.system),
then moves the undistorted model into `sparse/0`; `--resize` writes the
half, quarter and eighth size image pyramids as the JAX CLI does (PIL's
LANCZOS in place of ImageMagick), without PIL: each image decoded and
resampled with Pillow's LANCZOS filter on the device (`--device`, default
cuda), then written in its own format by its extension, a JPEG by
`utils.jpeg.encode_jpeg` at Pillow's save defaults (a grey JPEG stays
grey), a PNG by `utils.image.encode_png` as 8-bit RGB.

  python -m gags_torch.cli.convert -s <dir with input/ images> [--no_gpu]
      [--resize] [--camera OPENCV] [--colmap_executable colmap] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess

from gags_torch import resolve_device
from gags_torch.utils.image import encode_png, read_rgb, resize_uint8
from gags_torch.utils.jpeg import encode_jpeg, is_jpeg, parse_jpeg


def _call(cmd) -> None:
    print("+", " ".join(cmd))
    res = subprocess.run(cmd)
    if res.returncode != 0:
        raise SystemExit(f"command failed ({res.returncode}): {' '.join(cmd)}")


def _resize_pyramid(src: str, device="cuda") -> None:
    dev = resolve_device(device)
    for name in sorted(os.listdir(os.path.join(src, "images"))):
        path = os.path.join(src, "images", name)
        with open(path, "rb") as f:
            data = f.read()
        grey = is_jpeg(data) and parse_jpeg(data, path).colour == "grey"
        img = read_rgb(path, dev)
        h, w = img.shape[:2]
        for div in (2, 4, 8):
            out_dir = os.path.join(src, f"images_{div}")
            os.makedirs(out_dir, exist_ok=True)
            small = resize_uint8(img, (h // div, w // div), "lanczos").cpu().numpy()
            if name.lower().endswith((".jpg", ".jpeg")):
                data = encode_jpeg(small[..., 0] if grey else small)
            elif name.lower().endswith(".png"):
                data = encode_png(small)
            else:
                raise SystemExit(f"{path}: --resize writes .jpg, .jpeg and .png files only")
            with open(os.path.join(out_dir, name), "wb") as f:
                f.write(data)


def run(source_path: str, camera: str = "OPENCV", colmap_executable: str = "colmap",
        no_gpu: bool = False, skip_matching: bool = False, resize: bool = False,
        device="cuda") -> None:
    src, colmap = source_path, colmap_executable
    dev = resolve_device(device) if resize else None  # refused before COLMAP runs
    gpu = "0" if no_gpu else "1"
    if not skip_matching:
        os.makedirs(os.path.join(src, "distorted", "sparse"), exist_ok=True)
        _call([colmap, "feature_extractor",
               "--database_path", f"{src}/distorted/database.db",
               "--image_path", f"{src}/input",
               "--ImageReader.single_camera", "1",
               "--ImageReader.camera_model", camera,
               "--SiftExtraction.use_gpu", gpu])
        _call([colmap, "exhaustive_matcher",
               "--database_path", f"{src}/distorted/database.db",
               "--SiftMatching.use_gpu", gpu])
        _call([colmap, "mapper",
               "--database_path", f"{src}/distorted/database.db",
               "--image_path", f"{src}/input",
               "--output_path", f"{src}/distorted/sparse",
               "--Mapper.ba_global_function_tolerance=0.000001"])
    _call([colmap, "image_undistorter",
           "--image_path", f"{src}/input",
           "--input_path", f"{src}/distorted/sparse/0",
           "--output_path", src,
           "--output_type", "COLMAP"])
    # the undistorted model into sparse/0 (the reference's convert.py:77-88)
    sparse = os.path.join(src, "sparse")
    os.makedirs(os.path.join(sparse, "0"), exist_ok=True)
    for f in os.listdir(sparse):
        if f != "0":
            shutil.move(os.path.join(sparse, f), os.path.join(sparse, "0", f))
    if resize:
        _resize_pyramid(src, dev)
    print("done.")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-s", "--source_path", required=True)
    p.add_argument("--camera", default="OPENCV")
    p.add_argument("--colmap_executable", default="colmap")
    p.add_argument("--no_gpu", action="store_true")
    p.add_argument("--skip_matching", action="store_true")
    p.add_argument("--resize", action="store_true")
    p.add_argument("--device", default="cuda", help="where --resize decodes and resamples")
    run(**vars(p.parse_args(argv)))


if __name__ == "__main__":
    main()
