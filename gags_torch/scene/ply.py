"""Self-contained PLY I/O (numpy only), a copy of gags_tpu.scene.ply.

Reads/writes the 3DGS point-cloud checkpoint format the reference produces
(`scene/gaussian_model.py:222-259` save / 266-318 load): a binary
little-endian `vertex` element with fields

  x y z nx ny nz f_dc_{0..2} f_rest_{0..K} opacity scale_{0..2} rot_{0..3}
  [semantic_{0..F-1}]

plus generic structured read/write of a single `vertex` element.
"""

from __future__ import annotations

import io
import os
from typing import Dict, List, Tuple

import numpy as np

_PLY_TO_NP = {
    "char": "i1",
    "int8": "i1",
    "uchar": "u1",
    "uint8": "u1",
    "short": "i2",
    "int16": "i2",
    "ushort": "u2",
    "uint16": "u2",
    "int": "i4",
    "int32": "i4",
    "uint": "u4",
    "uint32": "u4",
    "float": "f4",
    "float32": "f4",
    "double": "f8",
    "float64": "f8",
}
_NP_TO_PLY = {
    "int8": "char",
    "uint8": "uchar",
    "int16": "short",
    "uint16": "ushort",
    "int32": "int",
    "uint32": "uint",
    "float32": "float",
    "float64": "double",
}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read the `vertex` element of a PLY file → {field: (N,) array}.

    Supports binary_little_endian and ascii formats; list properties and
    non-vertex elements are skipped (faces are irrelevant for point clouds).
    """
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n")
    if header_end < 0:
        raise ValueError(f"{path}: not a PLY file (no end_header)")
    header = data[:header_end].decode("ascii", "replace").splitlines()
    body = data[header_end + len(b"end_header\n") :]

    if not header or header[0].strip() != "ply":
        raise ValueError(f"{path}: missing 'ply' magic")
    fmt = None
    elements: List[Tuple[str, int, List[Tuple[str, str]]]] = []
    cur = None
    for line in header[1:]:
        parts = line.strip().split()
        if not parts or parts[0] == "comment":
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            cur = (parts[1], int(parts[2]), [])
            elements.append(cur)
        elif parts[0] == "property":
            if cur is None:
                raise ValueError(f"{path}: property before element")
            if parts[1] == "list":
                cur[2].append(("__list__", " ".join(parts[2:])))
            else:
                cur[2].append((parts[-1], _PLY_TO_NP[parts[1]]))

    if fmt not in ("binary_little_endian", "ascii"):
        raise ValueError(f"{path}: unsupported format {fmt}")

    out: Dict[str, np.ndarray] = {}
    offset = 0
    text_lines = None
    if fmt == "ascii":
        text_lines = body.decode("ascii").splitlines()
        li = 0
    for name, count, props in elements:
        if any(p[0] == "__list__" for p in props):
            if name == "vertex":
                raise ValueError(f"{path}: list property on vertex unsupported")
            # skip non-vertex elements with lists (faces): only possible for
            # ascii reliably; for binary we must stop (vertex usually first)
            if fmt == "ascii":
                li += count
                continue
            break
        dtype = np.dtype([(n, "<" + t) for n, t in props])
        if fmt == "binary_little_endian":
            arr = np.frombuffer(body, dtype=dtype, count=count, offset=offset)
            offset += dtype.itemsize * count
        else:
            rows = [text_lines[li + i].split() for i in range(count)]
            li += count
            arr = np.array([tuple(r) for r in rows], dtype=dtype)
        if name == "vertex":
            for n, _ in props:
                out[n] = np.ascontiguousarray(arr[n])
    if not out:
        raise ValueError(f"{path}: no vertex element found")
    return out


def write_ply(path: str, fields: Dict[str, np.ndarray], comment: str = "") -> None:
    """Write a binary_little_endian PLY with a single `vertex` element."""
    names = list(fields.keys())
    n = len(fields[names[0]])
    dtype = np.dtype(
        [(name, "<" + fields[name].dtype.str.lstrip("<>|=")) for name in names]
    )
    arr = np.empty(n, dtype=dtype)
    for name in names:
        col = np.asarray(fields[name])
        if col.shape != (n,):
            raise ValueError(f"field {name}: expected shape ({n},), got {col.shape}")
        arr[name] = col

    buf = io.BytesIO()
    buf.write(b"ply\nformat binary_little_endian 1.0\n")
    if comment:
        buf.write(f"comment {comment}\n".encode())
    buf.write(f"element vertex {n}\n".encode())
    for name in names:
        ply_t = _NP_TO_PLY[np.dtype(fields[name].dtype).name]
        buf.write(f"property {ply_t} {name}\n".encode())
    buf.write(b"end_header\n")
    buf.write(arr.tobytes())
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(buf.getvalue())


# ---------------------------------------------------------------------------
# 3DGS checkpoint layout
# ---------------------------------------------------------------------------


def read_gaussian_ply(path: str, max_sh_degree: int = 3) -> Dict[str, np.ndarray]:
    """Load a 3DGS point_cloud.ply into raw (pre-activation) parameter arrays.

    Returns dict with keys: means (N,3), sh (N,K,3) [dc first, 3DGS coeff
    order], opacities_raw (N,), scales_raw (N,3), quats (N,4), and
    semantic_features (N,F) if `semantic_*` fields exist (reference
    gaussian_model.py:279-288).
    """
    v = read_ply(path)
    n = len(v["x"])
    means = np.stack([v["x"], v["y"], v["z"]], 1).astype(np.float32)

    k = (max_sh_degree + 1) ** 2
    n_rest = 3 * k - 3
    rest_names = sorted(
        (name for name in v if name.startswith("f_rest_")),
        key=lambda s: int(s.rsplit("_", 1)[1]),
    )
    if rest_names and len(rest_names) != n_rest:
        # infer the true degree from the file
        k = (len(rest_names) + 3) // 3
        n_rest = len(rest_names)
    sh = np.zeros((n, k, 3), np.float32)
    sh[:, 0, 0] = v["f_dc_0"]
    sh[:, 0, 1] = v["f_dc_1"]
    sh[:, 0, 2] = v["f_dc_2"]
    if rest_names:
        rest = np.stack([v[name] for name in rest_names], 1)  # (N, 3*(K-1))
        # 3DGS layout: f_rest is (3, K-1) flattened channel-major
        sh[:, 1:, :] = rest.reshape(n, 3, k - 1).transpose(0, 2, 1)

    scales_raw = np.stack(
        [v[f"scale_{i}"] for i in range(sum(1 for s in v if s.startswith("scale_")))], 1
    ).astype(np.float32)
    quats = np.stack(
        [v[f"rot_{i}"] for i in range(sum(1 for s in v if s.startswith("rot_")))], 1
    ).astype(np.float32)

    out = dict(
        means=means,
        sh=sh,
        opacities_raw=np.asarray(v["opacity"], np.float32),
        scales_raw=scales_raw,
        quats=quats,
    )
    n_sem = sum(1 for s in v if s.startswith("semantic_"))
    if n_sem:
        out["semantic_features"] = np.stack(
            [v[f"semantic_{i}"] for i in range(n_sem)], 1
        ).astype(np.float32)
    return out


def write_gaussian_ply(
    path: str,
    means: np.ndarray,
    sh: np.ndarray,  # (N, K, 3)
    opacities_raw: np.ndarray,
    scales_raw: np.ndarray,
    quats: np.ndarray,
    semantic_features: np.ndarray | None = None,
) -> None:
    """Write the 3DGS checkpoint layout (reference gaussian_model.py:240-259),
    including `semantic_{i}` fields for distilled features."""
    n, k, _ = sh.shape
    fields: Dict[str, np.ndarray] = {}
    for i, name in enumerate("xyz"):
        fields[name] = means[:, i].astype(np.float32)
    for name in ("nx", "ny", "nz"):
        fields[name] = np.zeros(n, np.float32)
    for i in range(3):
        fields[f"f_dc_{i}"] = sh[:, 0, i].astype(np.float32)
    rest = sh[:, 1:, :].transpose(0, 2, 1).reshape(n, -1)  # channel-major
    for i in range(rest.shape[1]):
        fields[f"f_rest_{i}"] = rest[:, i].astype(np.float32)
    fields["opacity"] = opacities_raw.reshape(n).astype(np.float32)
    for i in range(scales_raw.shape[1]):
        fields[f"scale_{i}"] = scales_raw[:, i].astype(np.float32)
    for i in range(quats.shape[1]):
        fields[f"rot_{i}"] = quats[:, i].astype(np.float32)
    if semantic_features is not None:
        for i in range(semantic_features.shape[1]):
            fields[f"semantic_{i}"] = semantic_features[:, i].astype(np.float32)
    write_ply(path, fields, comment="gags gaussian checkpoint")
