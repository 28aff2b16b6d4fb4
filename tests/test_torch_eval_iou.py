"""Evaluation (query/eval_iou.py) of gags_torch against gags_tpu and PIL:
polygon_to_mask against Pillow's ImageDraw.polygon bit for bit (seeded
convex and concave polygons with float vertices, partly outside the
image too), load_lerf_gt on a written labelme folder (masks and boxes
equal), eval_frame_iou / eval_frame_localization on one decoded map
(IoUs equal to 1e-6, hit counts equal)."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

from gags_tpu.query import eval_iou as jev
from gags_torch.query import eval_iou as ev


def _pil_fill(h, w, pts):
    img = Image.new("L", (w, h), 0)
    ImageDraw.Draw(img).polygon([tuple(map(float, p)) for p in pts], outline=1, fill=1)
    return np.asarray(img, np.uint8)


def _polygon(rng, h, w, concave):
    """A convex polygon (sorted angles, one radius) or a star (one radius
    a vertex), float vertices, centred anywhere in the image."""
    n = int(rng.integers(3, 40))
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    r = rng.uniform(2, min(h, w) / 1.5, n) if concave else rng.uniform(3, min(h, w) / 2)
    c = rng.uniform([0, 0], [w, h])
    return np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], 1)


@pytest.mark.parametrize("concave", [False, True], ids=["convex", "concave"])
def test_polygon_to_mask_equals_pil(concave):
    rng = np.random.default_rng(int(concave))
    for _ in range(300):
        h, w = (int(v) for v in rng.integers(20, 300, 2))
        pts = _polygon(rng, h, w, concave)
        got = ev.polygon_to_mask((h, w), pts)
        assert got.dtype == np.uint8 and got.shape == (h, w)
        np.testing.assert_array_equal(got, _pil_fill(h, w, pts))


def test_polygon_to_mask_corner_cases():
    """Integer and half-integer vertices, horizontal runs, a vertex
    outside the image, a degenerate (two-point) polygon."""
    cases = [
        [(2, 2), (10, 2), (10, 8), (2, 8)],
        [(0.5, 0.5), (12.5, 0.5), (12.5, 3.5), (6.5, 9.5)],
        [(-5.2, 3.7), (8.9, -2.1), (15.3, 6.6), (7.7, 6.6), (4.1, 6.6), (1.0, 12.9)],
        [(3.0, 3.0), (9.0, 9.0)],
        [(1.9, 1.9), (13.1, 1.9), (13.1, 1.9), (7.5, 11.2)],
    ]
    for pts in cases:
        np.testing.assert_array_equal(ev.polygon_to_mask((12, 14), pts), _pil_fill(12, 14, pts))
    assert not ev.polygon_to_mask((4, 4), np.zeros((0, 2))).any()


def _folded(rng):
    """A star (sorted angles) or self-intersecting (unsorted angles) polygon
    of 11-34 float vertices, a radius each, rounded to 3 decimals, on an
    image of 8-300 px a side: many fold back along an edge they retrace."""
    h, w = (int(v) for v in rng.integers(8, 301, 2))
    n = int(rng.integers(11, 35))
    c = rng.uniform([0, 0], [w, h])
    star = rng.random() < 0.5
    ang = rng.uniform(0, 2 * np.pi, n)
    if star:
        ang = np.sort(ang)
    r = rng.uniform(1, max(h, w) / 1.5, n)
    return h, w, np.round(np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], 1), 3)


# Every polygon of _folded's first 6000 draws from default_rng(seed), seeds
# 1-8 (48,000 polygons), on which the fill once differed from Pillow 12.1,
# as (seed, draw index): a crossing at a vertex was moved toward the next
# row's span though the first earlier sloped edge through that vertex
# parts from it or retraces it, where Pillow leaves it.
_FOLDED_DRAWS = [(1, 2209), (4, 540), (5, 3740), (6, 2105), (8, 908), (8, 2431)]
_FOLDED_CASES = [
    # the first one found: pixel (33, 0) was filled
    (54, 14, [(7.032, 34.959), (1.46, 33.401), (-3.757, 34.378), (1.811, 33.163),
              (-3.568, 32.129), (1.149, 30.314), (1.702, 26.891), (3.303, 29.23),
              (7.478, 24.951), (8.103, 29.545), (10.76, 32.122)]),
]


def _draw(seed, index):
    rng = np.random.default_rng(seed)
    for _ in range(index + 1):
        case = _folded(rng)
    return case


@pytest.mark.parametrize("case", range(len(_FOLDED_CASES) + len(_FOLDED_DRAWS)))
def test_polygon_to_mask_folded_cases_equal_pil(case):
    if case < len(_FOLDED_CASES):
        h, w, pts = _FOLDED_CASES[case]
    else:
        h, w, pts = _draw(*_FOLDED_DRAWS[case - len(_FOLDED_CASES)])
    np.testing.assert_array_equal(ev.polygon_to_mask((h, w), pts), _pil_fill(h, w, pts))


def test_polygon_to_mask_folded_draws_equal_pil():
    """The generator's first 200 draws from seed 0."""
    rng = np.random.default_rng(0)
    for _ in range(200):
        h, w, pts = _folded(rng)
        np.testing.assert_array_equal(ev.polygon_to_mask((h, w), pts), _pil_fill(h, w, pts))


def _write_labelme(root, h=48, w=64, frames=(1, 3)):
    """frame_<i>.json in the LERF labelme layout: several labels, one label
    with two polygons (merged), float vertices."""
    rng = np.random.default_rng(7)
    os.makedirs(root, exist_ok=True)
    for i in frames:
        objects = []
        for label in ("teapot", "bear", "teapot", "sheep"):
            pts = _polygon(rng, h, w, concave=label == "bear")
            x0, y0 = pts.min(0)
            x1, y1 = pts.max(0)
            objects.append(dict(category=label, bbox=[float(x0), float(y0), float(x1), float(y1)],
                                segmentation=pts.tolist()))
        with open(os.path.join(root, f"frame_{i:05d}.json"), "w") as f:
            json.dump(dict(info=dict(height=h, width=w, name=f"frame_{i:05d}.jpg"),
                           objects=objects), f)
    return root


def test_load_lerf_gt_matches(tmp_path):
    root = _write_labelme(str(tmp_path / "labels"))
    want, hw_j, _ = jev.load_lerf_gt(root)
    got, hw, paths = ev.load_lerf_gt(root)
    assert hw == hw_j == (48, 64) and paths == []
    assert sorted(got) == sorted(want) == ["0", "2"]
    for idx in want:
        assert list(got[idx]) == list(want[idx]) == ["teapot", "bear", "sheep"]
        for label, ann in want[idx].items():
            np.testing.assert_array_equal(got[idx][label]["mask"], ann["mask"])
            np.testing.assert_array_equal(got[idx][label]["bboxes"], ann["bboxes"])
        assert got[idx]["teapot"]["bboxes"].shape == (2, 4)


def test_eval_frame_iou_and_localization_match(tmp_path):
    """A decoded map whose per-pixel embedding blends the label directions
    with smooth weights, so the heat maps have structure."""
    gt, (h, w), _ = jev.load_lerf_gt(_write_labelme(str(tmp_path / "labels")))
    rng = np.random.default_rng(8)
    d = 32
    labels = ["teapot", "bear", "sheep"]
    pos = rng.normal(size=(3, d))
    pos /= np.linalg.norm(pos, axis=1, keepdims=True)
    neg = rng.normal(size=(4, d))
    neg /= np.linalg.norm(neg, axis=1, keepdims=True)
    yy, xx = np.mgrid[0:h, 0:w] / np.array([h, w])[:, None, None]
    wts = np.stack([np.sin(3 * xx + k) * np.cos(2 * yy - k) for k in range(3)], -1)
    dec = (wts @ pos + 0.3 * rng.normal(size=(h, w, d))).astype(np.float32)
    pos, neg = pos.astype(np.float32), neg.astype(np.float32)
    for idx, ann in gt.items():
        want = jev.eval_frame_iou(dec, pos, neg, ann, labels, thresh=0.4)
        got = ev.eval_frame_iou(torch.from_numpy(dec), pos, neg, ann, labels, thresh=0.4)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        assert 0 < max(got) <= 1
        assert (ev.eval_frame_localization(dec, pos, neg, ann, labels)
                == jev.eval_frame_localization(dec, pos, neg, ann, labels))
    # the relevancy reused (as the CLI passes it) gives the same numbers
    rel = ev.frame_relevancy(torch.from_numpy(dec), pos, neg)
    assert ev.eval_frame_iou(None, None, None, ann, labels, 0.4, rel=rel) == got


def test_polygon_to_mask_needs_no_pil():
    """The ground truth is filled without PIL (the card's machine has none)."""
    code = (
        "import sys\n"
        "for m in ('PIL', 'jax', 'gags_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from gags_torch.query.eval_iou import polygon_to_mask\n"
        "print(int(polygon_to_mask((8, 8), [(1.5, 1.5), (6.2, 2.0), (4.0, 6.9)]).sum()))\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) == int(_pil_fill(8, 8, [(1.5, 1.5), (6.2, 2.0), (4.0, 6.9)]).sum())
