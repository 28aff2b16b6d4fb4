"""COLMAP SfM driver (port of gags_tpu.cli.convert), the reference's `convert.py`.

Runs feature extraction → exhaustive matching → mapping → undistortion
through the external `colmap` binary (a subprocess each, not os.system),
then moves the undistorted model into `sparse/0`; `--resize` writes the
half, quarter and eighth size image pyramids (PIL's LANCZOS in place of
ImageMagick, so it needs PIL).

  python -m gags_torch.cli.convert -s <dir with input/ images> [--no_gpu]
      [--resize] [--camera OPENCV] [--colmap_executable colmap]
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess


def _call(cmd) -> None:
    print("+", " ".join(cmd))
    res = subprocess.run(cmd)
    if res.returncode != 0:
        raise SystemExit(f"command failed ({res.returncode}): {' '.join(cmd)}")


def _resize_pyramid(src: str) -> None:
    try:
        from PIL import Image
    except ImportError:
        raise SystemExit("--resize needs PIL (Pillow), which is not installed") from None
    for div in (2, 4, 8):
        out_dir = os.path.join(src, f"images_{div}")
        os.makedirs(out_dir, exist_ok=True)
        for name in os.listdir(os.path.join(src, "images")):
            img = Image.open(os.path.join(src, "images", name))
            img.resize((img.width // div, img.height // div), Image.LANCZOS).save(
                os.path.join(out_dir, name))


def run(source_path: str, camera: str = "OPENCV", colmap_executable: str = "colmap",
        no_gpu: bool = False, skip_matching: bool = False, resize: bool = False) -> None:
    src, colmap = source_path, colmap_executable
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
        _resize_pyramid(src)
    print("done.")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-s", "--source_path", required=True)
    p.add_argument("--camera", default="OPENCV")
    p.add_argument("--colmap_executable", default="colmap")
    p.add_argument("--no_gpu", action="store_true")
    p.add_argument("--skip_matching", action="store_true")
    p.add_argument("--resize", action="store_true")
    run(**vars(p.parse_args(argv)))


if __name__ == "__main__":
    main()
