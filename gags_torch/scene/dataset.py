"""Scene assembly: COLMAP/Blender reconstructions → posed cameras +
supervision paths (port of gags_tpu.scene.dataset, numpy only).

  * COLMAP layout detection (`sparse/0`), PINHOLE/SIMPLE_PINHOLE only;
  * Blender `transforms_train.json` layout; an image's size is read from
    its PNG header with struct (no imaging library);
  * eval split rule `idx % 8 == 2`;
  * scene radius = 1.1 x max camera-centre spread (`nerfpp_norm`);
  * resolution policy: -1 caps width at 1600, -2 is 800x450, 0 matches the
    language-feature map, and 1/2/4/8 divide;
  * each camera is paired with `language_features/<name>_{f,s}.npy`
    (lazy paths; the GAD loader pads and converts them once).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from gags_torch.core.camera import Camera, focal_to_fov, fov_to_focal
from gags_torch.scene import colmap as cm
from gags_torch.scene.ply import write_points3d_ply

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


@dataclasses.dataclass
class CameraInfo:
    uid: int
    name: str
    R: np.ndarray  # (3,3) camera-to-world rotation (reference convention)
    T: np.ndarray  # (3,) world-to-camera translation
    fovx: float
    fovy: float
    width: int
    height: int
    image_path: str = ""
    f_path: str = ""  # language feature embeddings (<name>_f.npy)
    s_path: str = ""  # seg maps (<name>_s.npy)


@dataclasses.dataclass
class SceneInfo:
    train_cameras: List[CameraInfo]
    test_cameras: List[CameraInfo]
    radius: float
    translate: np.ndarray
    points_path: str = ""


def nerfpp_norm(cams: List[CameraInfo]) -> Tuple[np.ndarray, float]:
    """Scene centre + radius (reference getNerfppNorm)."""
    centers = np.stack([c.R @ (-c.T) for c in cams], 0)
    avg = centers.mean(0)
    diag = np.linalg.norm(centers - avg, axis=1).max()
    return -avg, diag * 1.1


def png_size(path: str) -> Tuple[int, int]:
    """(width, height) from a PNG's IHDR chunk: the 8 bytes after the
    signature, the chunk length and the chunk tag."""
    with open(path, "rb") as f:
        head = f.read(24)
    if len(head) < 24 or head[:8] != PNG_MAGIC or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    w, h = struct.unpack(">II", head[16:24])
    return int(w), int(h)


def load_colmap_scene(
    source_path: str,
    images_dir: str = "images",
    eval_split: bool = False,
    foundation_model: str = "sam_clip",
    llffhold: int = 8,
) -> SceneInfo:
    sparse = os.path.join(source_path, "sparse", "0")
    if os.path.exists(os.path.join(sparse, "images.bin")):
        extr = cm.read_images_binary(os.path.join(sparse, "images.bin"))
        intr = cm.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    else:
        extr = cm.read_images_text(os.path.join(sparse, "images.txt"))
        intr = cm.read_cameras_text(os.path.join(sparse, "cameras.txt"))

    feat_dir = os.path.join(source_path, "language_features")
    cam_infos: List[CameraInfo] = []
    for img in sorted(extr.values(), key=lambda im: im.name):
        cam = intr[img.camera_id]
        if cam.model == "PINHOLE":
            fx, fy = cam.params[0], cam.params[1]
        elif cam.model == "SIMPLE_PINHOLE":
            fx = fy = cam.params[0]
        else:
            raise ValueError(
                f"unsupported COLMAP camera model {cam.model}; undistort first"
            )
        stem = os.path.splitext(img.name)[0]
        f_path = os.path.join(feat_dir, stem + "_f.npy")
        s_path = os.path.join(feat_dir, stem + "_s.npy")
        if foundation_model != "sam_clip":
            f_path = s_path = ""
        cam_infos.append(
            CameraInfo(
                uid=img.id,
                name=img.name,
                R=cm.qvec_to_rotmat(img.qvec).T,
                T=img.tvec.copy(),
                fovx=focal_to_fov(fx, cam.width),
                fovy=focal_to_fov(fy, cam.height),
                width=cam.width,
                height=cam.height,
                image_path=os.path.join(source_path, images_dir, img.name),
                f_path=f_path,
                s_path=s_path,
            )
        )

    if eval_split:
        train = [c for i, c in enumerate(cam_infos) if i % llffhold != 2]
        test = [c for i, c in enumerate(cam_infos) if i % llffhold == 2]
    else:
        train, test = cam_infos, []

    translate, radius = nerfpp_norm(train)

    pts_ply = os.path.join(source_path, "sparse", "0", "points3D.ply")
    if not os.path.exists(pts_ply):
        bin_path = os.path.join(sparse, "points3D.bin")
        txt_path = os.path.join(sparse, "points3D.txt")
        if os.path.exists(bin_path):
            xyz, rgb, _ = cm.read_points3d_binary(bin_path)
        elif os.path.exists(txt_path):
            xyz, rgb, _ = cm.read_points3d_text(txt_path)
        else:
            xyz = rgb = None
        if xyz is not None:
            write_points3d_ply(pts_ply, xyz.astype(np.float32), rgb / 255.0)

    return SceneInfo(
        train_cameras=train,
        test_cameras=test,
        radius=radius,
        translate=translate,
        points_path=pts_ply if os.path.exists(pts_ply) else "",
    )


def load_blender_scene(
    source_path: str, white_background: bool = False, eval_split: bool = True
) -> SceneInfo:
    """NeRF-synthetic transforms_{train,test}.json layout."""

    def read_split(fname):
        with open(os.path.join(source_path, fname)) as f:
            meta = json.load(f)
        fovx = meta["camera_angle_x"]
        out = []
        for i, frame in enumerate(meta["frames"]):
            c2w = np.array(frame["transform_matrix"], dtype=np.float64)
            c2w[:3, 1:3] *= -1  # blender → COLMAP axis convention
            w2c = np.linalg.inv(c2w)
            R = w2c[:3, :3].T
            T = w2c[:3, 3]
            img_path = os.path.join(source_path, frame["file_path"] + ".png")
            # default NeRF-synthetic size when the image is absent
            w = h = 800
            if os.path.exists(img_path):
                w, h = png_size(img_path)
            fovy = focal_to_fov(0.5 * w / math.tan(0.5 * fovx), h)
            out.append(
                CameraInfo(
                    uid=i,
                    name=os.path.basename(frame["file_path"]),
                    R=R,
                    T=T,
                    fovx=fovx,
                    fovy=fovy,
                    width=w,
                    height=h,
                    image_path=img_path,
                )
            )
        return out

    train = read_split("transforms_train.json")
    test = (
        read_split("transforms_test.json")
        if eval_split and os.path.exists(os.path.join(source_path, "transforms_test.json"))
        else []
    )
    translate, radius = nerfpp_norm(train)
    return SceneInfo(
        train_cameras=train,
        test_cameras=test,
        radius=radius,
        translate=translate,
        points_path=os.path.join(source_path, "points3d.ply"),
    )


def detect_and_load(source_path: str, **kw) -> SceneInfo:
    """COLMAP vs Blender autodetect (reference scene/__init__.py:43-49)."""
    if os.path.exists(os.path.join(source_path, "sparse")):
        return load_colmap_scene(source_path, **kw)
    if os.path.exists(os.path.join(source_path, "transforms_train.json")):
        return load_blender_scene(source_path, eval_split=kw.get("eval_split", True))
    raise ValueError(f"could not recognise scene layout at {source_path}")


def resolve_resolution(
    width: int, height: int, resolution: int, feature_hw: Optional[Tuple[int, int]] = None
) -> Tuple[int, int]:
    """Render resolution policy (reference utils/camera_utils.py:31-56)."""
    if resolution in (1, 2, 4, 8):
        scale = float(resolution)
    elif resolution == -1:
        scale = width / 1600.0 if width > 1600 else 1.0
    elif resolution == -2:
        return 800, 450
    elif resolution == 0:
        if feature_hw is None:
            raise ValueError("resolution=0 needs the language-feature map size")
        return feature_hw[1], feature_hw[0]
    else:
        scale = float(resolution)
    return int(round(width / scale)), int(round(height / scale))


def camera_from_info(info: CameraInfo, resolution: int = -1, feature_hw=None) -> Camera:
    w, h = resolve_resolution(info.width, info.height, resolution, feature_hw)
    return Camera.from_colmap(info.R, info.T, info.fovx, info.fovy, w, h, name=info.name)


def camera_to_json(idx: int, info: CameraInfo) -> Dict:
    """cameras.json entry (reference utils/camera_utils.py:90-110)."""
    Rt = np.eye(4)
    Rt[:3, :3] = info.R.T
    Rt[:3, 3] = info.T
    c2w = np.linalg.inv(Rt)
    return {
        "id": idx,
        "img_name": info.name,
        "width": info.width,
        "height": info.height,
        "position": c2w[:3, 3].tolist(),
        "rotation": [r.tolist() for r in c2w[:3, :3]],
        "fx": fov_to_focal(info.fovx, info.width),
        "fy": fov_to_focal(info.fovy, info.height),
    }
