"""The inputs every cell makes from its seed, and the on-disk layouts the
program's entry points read. Numpy and the standard library only (the
load generator's process imports this module too).

`make_scene` is a frozen copy of the fog-scene generator of the program's
`utils/synthetic.py`: uniform means in a box pushed 6 units in front of
the origin, random rotations, log-normal scales, uniform opacities and
SH colours. The writers produce a COLMAP text reconstruction, the 3DGS
point-cloud PLY and 8-bit PNGs (zlib and struct).
"""

from __future__ import annotations

import math
import os
import struct
import zlib

import numpy as np


def make_scene(n: int, seed: int, extent: float = 2.0, feature_dim: int = 16,
               scale_mean: float = -4.2, scale_std: float = 0.6) -> dict:
    rng = np.random.default_rng(seed)
    means = rng.uniform(-extent, extent, size=(n, 3)).astype(np.float32)
    means[:, 2] += 6.0
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(rng.normal(scale_mean, scale_std, size=(n, 3))).astype(np.float32)
    opacities = rng.uniform(0.2, 0.95, size=(n,)).astype(np.float32)
    sh = np.zeros((n, 16, 3), np.float32)
    sh[:, 0, :] = rng.uniform(-1.5, 1.5, size=(n, 3))
    sh[:, 1:, :] = 0.1 * rng.normal(size=(n, 15, 3))
    features = rng.normal(size=(n, feature_dim)).astype(np.float32) * 0.3
    return dict(means=means, quats=quats, scales=scales, opacities=opacities, sh=sh,
                features=features)


def look_at(eye, target, up=(0.0, -1.0, 0.0)) -> np.ndarray:
    """World-to-camera 4x4 (x right, y down, z forward), float64."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    r = np.stack([right, down, fwd])
    out = np.eye(4)
    out[:3, :3] = r
    out[:3, 3] = -r @ eye
    return out


def orbit_eye(t: float, radius_xy=(0.25, 0.15), z: float = -0.2) -> np.ndarray:
    """A point of the small ellipse the cameras sit on, t in [0, 1)."""
    a = 2 * math.pi * t
    return np.array([radius_xy[0] * math.cos(a), radius_xy[1] * math.sin(a), z])


def rotmat_to_qvec(r: np.ndarray) -> np.ndarray:
    """Unit quaternion (w, x, y, z) of a rotation matrix, w >= 0."""
    k = np.array([
        [r[0, 0] - r[1, 1] - r[2, 2], 0, 0, 0],
        [r[0, 1] + r[1, 0], r[1, 1] - r[0, 0] - r[2, 2], 0, 0],
        [r[0, 2] + r[2, 0], r[1, 2] + r[2, 1], r[2, 2] - r[0, 0] - r[1, 1], 0],
        [r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1], r[0, 0] + r[1, 1] + r[2, 2]],
    ]) / 3.0
    vals, vecs = np.linalg.eigh(k)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return q * np.sign(q[0]) if q[0] != 0 else q


def qvec_to_rotmat(q) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def write_colmap_text(sparse_dir: str, width: int, height: int, focal: float, poses) -> list:
    """cameras.txt (one PINHOLE camera) and images.txt; `poses` is a list
    of (name, world-to-camera 4x4). Returns [(name, qvec, tvec)] as
    written (the values a reader of the files gets back)."""
    os.makedirs(sparse_dir, exist_ok=True)
    with open(os.path.join(sparse_dir, "cameras.txt"), "w") as f:
        f.write(f"1 PINHOLE {width} {height} {focal!r} {focal!r} {width / 2.0!r} {height / 2.0!r}\n")
    out = []
    with open(os.path.join(sparse_dir, "images.txt"), "w") as f:
        for i, (name, vm) in enumerate(poses):
            q = rotmat_to_qvec(vm[:3, :3])
            t = vm[:3, 3]
            f.write(f"{i + 1} {' '.join(repr(float(x)) for x in q)} "
                    f"{' '.join(repr(float(x)) for x in t)} 1 {name}\n0 0 -1\n")
            out.append((name, np.array([float(x) for x in q]), np.array([float(x) for x in t])))
    return out


def write_gaussian_ply(path: str, means, sh, opacities_raw, scales_raw, quats, features=None):
    """The 3DGS point-cloud layout: x y z nx ny nz f_dc_0..2 f_rest_*
    (channel-major) opacity scale_0..2 rot_0..3 [semantic_*], binary
    little-endian float32."""
    n, k, _ = sh.shape
    cols = [means, np.zeros((n, 3), np.float32), sh[:, 0, :],
            sh[:, 1:, :].transpose(0, 2, 1).reshape(n, 3 * (k - 1)),
            opacities_raw.reshape(n, 1), scales_raw, quats]
    names = (["x", "y", "z", "nx", "ny", "nz", "f_dc_0", "f_dc_1", "f_dc_2"]
             + [f"f_rest_{i}" for i in range(3 * (k - 1))] + ["opacity"]
             + [f"scale_{i}" for i in range(3)] + [f"rot_{i}" for i in range(4)])
    if features is not None:
        cols.append(features)
        names += [f"semantic_{i}" for i in range(features.shape[1])]
    data = np.ascontiguousarray(np.concatenate([np.asarray(c, np.float32) for c in cols], 1))
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {name}" for name in names] + ["end_header"]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        f.write(data.astype("<f4").tobytes())


def _chunk(tag: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))


def encode_png(rgb8: np.ndarray) -> bytes:
    """(H, W, 3) uint8 → an 8-bit RGB PNG, every row filter 0."""
    h, w = rgb8.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb8.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + _chunk(b"IEND", b""))


def decode_png(data: bytes) -> np.ndarray:
    """8-bit RGB PNG → (H, W, 3) uint8; undoes all five row filters."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + ln]
        pos += 12 + ln
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    w, h, depth, ctype = hdr[0], hdr[1], hdr[2], hdr[3]
    if depth != 8 or ctype != 2 or hdr[6]:
        raise ValueError(f"unsupported PNG {hdr}")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + 3 * w)
    out = np.zeros((h + 1, 3 * w + 3), np.int32)
    for y in range(h):
        f, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        prev = out[y, 3:]
        if f == 0:
            cur = line
        elif f == 2:
            cur = (line + prev) & 255
        else:
            cur = np.zeros_like(line)
            for x in range(3 * w):
                a = cur[x - 3] if x >= 3 else 0
                b = prev[x]
                c = out[y, x] if x >= 3 else 0
                if f == 1:
                    p = a
                elif f == 3:
                    p = (a + b) // 2
                else:
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    p = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (line[x] + p) & 255
        out[y + 1, 3:] = cur
    return out[1:, 3:].astype(np.uint8).reshape(h, w, 3)
