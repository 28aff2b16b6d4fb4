"""GAS without models, the port against gags_tpu.gas on the same numpy
inputs: prompts (four modes) and masks bit for bit, the island/hole
cleanup (scipy in the port, cv2 or scipy in JAX) bit for bit, the depth
sampler's integer outputs exact and depths to 1e-6, and the PIL-free
resizes (PIL's bilinear exactly; jax.image.resize to 1e-6 where it
upsamples, 1e-4 where an axis shrinks and the antialiasing weights are
computed in another order)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from gags_tpu.gas import data_utils as jdu
from gags_tpu.gas import depth_sampler as jds
from gags_tpu.gas import generator as jgen
from gags_tpu.gas import masks as jm
from gags_tpu.gas import prompts as jp
from gags_torch.gas import data_utils as tdu
from gags_torch.gas import depth_sampler as tds
from gags_torch.gas import generator as tgen
from gags_torch.gas import masks as tm
from gags_torch.gas import prompts as tp
from gags_torch.utils.image import read_rgb, resize_like_jax, resize_uint8_bilinear

DEPTH_TOL = 1e-6


def _rand_masks(n, h, w, seed):
    rng = np.random.default_rng(seed)
    out = np.zeros((n, h, w), bool)
    for i in range(n):
        y, x = rng.integers(0, h - 4), rng.integers(0, w - 4)
        hh, ww = rng.integers(3, h - y), rng.integers(3, w - x)
        out[i, y:y + hh, x:x + ww] = True
    return out


def _same(a, b):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- prompts: the same numpy Generator gives the same grids -------------------

def test_point_grids_match():
    _same(tp.build_point_grid(7), jp.build_point_grid(7))
    _same(tp.build_all_layer_point_grids(16, 2, 2), jp.build_all_layer_point_grids(16, 2, 2))
    depth = np.random.default_rng(0).uniform(0.5, 30, (40, 56)).astype(np.float32)
    _same(tp.build_depth_point_grid(4, depth), jp.build_depth_point_grid(4, depth))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mindepth_grids_match(seed):
    rng = np.random.default_rng(seed)
    h, w = 48, 64
    depth = rng.uniform(2, 9, (h, w)).astype(np.float32)
    sample = np.where(rng.random((h, w)) < 0.1, rng.uniform(1, 4, (h, w)), 0).astype(np.float32)
    sample[:12, :16] = 0  # an empty cell: uniform fallback
    got = tp.build_all_layer_mindepth_point_grids(4, 1, 2, 4, depth, sample,
                                                   np.random.default_rng(seed))
    want = jp.build_all_layer_mindepth_point_grids(4, 1, 2, 4, depth, sample,
                                                    np.random.default_rng(seed))
    _same(got, want)
    crop = sample[:20, :30]
    _same(tp.sample_by_density(crop, 9, np.random.default_rng(7)),
          jp.sample_by_density(crop, 9, np.random.default_rng(7)))


def test_pcd_prompt_modes_match():
    rng = np.random.default_rng(0)
    depth = rng.uniform(1, 10, 50)
    mask = rng.random((50, 3)) < 0.4
    mask[10] = False
    assert (tp.sample_from_pcd(depth, mask, 200, np.random.default_rng(1))
            == jp.sample_from_pcd(depth, mask, 200, np.random.default_rng(1)))
    mapping = np.stack([rng.integers(0, 40, 50), rng.integers(0, 60, 50)], -1)
    vis = rng.random(50) < 0.3
    _same(tp.project_from_sampled_pcd(vis, mapping, 2, 40, 60),
          jp.project_from_sampled_pcd(vis, mapping, 2, 40, 60))


# -- masks ----------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_mask_nms_matches(seed):
    masks = _rand_masks(12, 24, 30, seed)
    scores = np.random.default_rng(100 + seed).uniform(0.5, 1.0, 12).astype(np.float32)
    _same(tm.mask_nms(masks, scores, 0.8, 0.7, 0.5), jm.mask_nms(masks, scores, 0.8, 0.7, 0.5))
    # no score may sit on the 0.7 score threshold (float32 vs float64 reads)
    assert np.abs(scores.astype(np.float64) - 0.7).min() > 1e-6


def _recs(masks, seed):
    rng = np.random.default_rng(seed)
    return [dict(segmentation=m, area=int(m.sum()), bbox=jgen.mask_to_box(m),
                 predicted_iou=float(rng.uniform(0.6, 1)),
                 stability_score=float(rng.uniform(0.6, 1))) for m in masks]


def test_filter_seg_map_pack_crops_match():
    masks = _rand_masks(9, 20, 28, 5)
    recs = _recs(masks, 5)
    kt, kj = tm.filter_masks(recs), jm.filter_masks(recs)
    assert [id(r) for r in kt] == [id(r) for r in kj]
    _same(tm.masks_to_seg_map(recs, (20, 28)), jm.masks_to_seg_map(recs, (20, 28)))
    img = np.random.default_rng(1).integers(0, 255, (20, 28, 3), np.uint8)
    _same(tm.pad_to_square(img), jm.pad_to_square(img))
    _same(tm.pad_to_square(img[:, :9]), jm.pad_to_square(img[:, :9]))
    _same(tm._resize_bilinear_np(img, 37), jm._resize_bilinear_np(img, 37))
    _same(tm.extract_mask_crops(recs, img, 32), jm.extract_mask_crops(recs, img, 32))
    rng = np.random.default_rng(0)
    embeds = {k: rng.normal(size=(n, 4)).astype(np.float32)
              for k, n in zip(["default", "m", "l"], [3, 4, 1])}  # 's' missing
    segs = {k: rng.integers(-1, 3, (6, 8)).astype(np.int32) for k in embeds}
    _same(tm.pack_granularities(embeds, segs), jm.pack_granularities(embeds, segs))


# -- cleanup: scipy in the port, the same kept set as JAX -----------------

def _speckled(seed):
    rng = np.random.default_rng(seed)
    m = np.zeros((40, 40), bool)
    m[5:30, 6:33] = True
    m |= rng.random((40, 40)) < 0.03   # islands
    m &= ~(rng.random((40, 40)) < 0.03)  # holes
    return m


@pytest.mark.parametrize("mode", ["holes", "islands"])
@pytest.mark.parametrize("thresh", [3, 10, 2000])
def test_remove_small_regions_matches(mode, thresh):
    for seed in range(3):
        m = _speckled(seed)
        got, ch = tgen.remove_small_regions(m, thresh, mode)
        want, chj = jgen.remove_small_regions(m, thresh, mode)
        assert ch == chj
        _same(got, want)


def test_postprocess_small_regions_matches():
    base = np.zeros((40, 40), bool)
    base[10:30, 10:30] = True
    speckled = base.copy()
    speckled[0:2, 0:2] = True
    recs = _recs([speckled, base, _speckled(0), _speckled(1)], 3)
    got = tgen.postprocess_small_regions(recs, 100, 0.7)
    want = jgen.postprocess_small_regions(recs, 100, 0.7)
    assert len(got) == len(want) >= 2
    for a, b in zip(got, want):
        _same(a["segmentation"], b["segmentation"])
        assert a["bbox"] == b["bbox"] and a["area"] == b["area"]
    boxes = np.array([[0, 0, 10, 10], [1, 1, 9, 9], [20, 20, 30, 30]], np.float32)
    scores = np.array([0.9, 0.8, 0.7], np.float32)
    assert tgen.box_nms(boxes, scores, 0.5) == jgen.box_nms(boxes, scores, 0.5) == [0, 2]


def test_stability_score_matches():
    logits = np.random.default_rng(0).normal(0, 2, (3, 4, 16, 20)).astype(np.float32)
    got = tgen.stability_score(torch.from_numpy(logits), 0.0, 1.0).numpy()
    _same(got, jgen.stability_score(jnp.asarray(logits), 0.0, 1.0))


# -- the depth sampler --------------------------------------------------------

def _depth_case(seed, n=400, c=3, h=48, w=64):
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.normal(0, 1, (n, 2)), rng.uniform(3, 8, (n, 1))], 1).astype(np.float32)
    vms, Ks = [], []
    for i in range(c):
        a = 0.15 * (i - 1)
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        vm = np.eye(4)
        vm[:3, :3], vm[:3, 3] = R, [0.1 * i, -0.05 * i, 0.2]
        vms.append(vm)
        Ks.append([[40.0 + i, 0, w / 2], [0, 41.0, h / 2], [0, 0, 1]])
    vms, Ks = np.array(vms, np.float32), np.array(Ks, np.float32)
    dmaps = rng.uniform(3, 9, (c, h, w)).astype(np.float32)
    return pts, vms, Ks, dmaps


@pytest.mark.parametrize("seed", [0, 1])
def test_depth_sampler_matches(seed):
    pts, vms, Ks, dmaps = _depth_case(seed)
    c, h, w = dmaps.shape
    for i in range(c):
        got = tds.project_points(torch.from_numpy(pts), torch.from_numpy(vms[i]),
                                 torch.from_numpy(Ks[i]), torch.from_numpy(dmaps[i]), w, h,
                                 vis_thres=0.5, cut_bound=2)
        want = jds.project_points(jnp.asarray(pts), jnp.asarray(vms[i]), jnp.asarray(Ks[i]),
                                  jnp.asarray(dmaps[i]), w, h, vis_thres=0.5, cut_bound=2)
        for a, b in zip(got[:3], want[:3]):
            _same(a.numpy(), b)
        np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=0, atol=DEPTH_TOL)
    mind, vis, uv = tds.min_depth_over_cameras(*(torch.from_numpy(a) for a in (pts, vms, Ks, dmaps)),
                                               vis_thres=0.5)
    jmind, jvis, juv = jds.min_depth_over_cameras(*(jnp.asarray(a) for a in (pts, vms, Ks, dmaps)),
                                                  vis_thres=0.5)
    _same(vis.numpy(), jvis)
    _same(uv.numpy(), juv)
    assert vis.sum() > 100
    np.testing.assert_allclose(mind.numpy(), np.asarray(jmind), rtol=0, atol=DEPTH_TOL)
    for i in range(c):
        got = tds.splat_depth_samples(mind, vis[:, i], uv[:, i], h, w).numpy()
        want = np.asarray(jds.splat_depth_samples(jmind, jvis[:, i], juv[:, i], h, w))
        np.testing.assert_allclose(got, want, rtol=0, atol=DEPTH_TOL)
        assert (got > 0).sum() == (want > 0).sum()


def test_splat_last_visible_point_wins():
    """Three points on one pixel: the first and last visible, the middle one
    not; the map holds the last visible one's depth, as JAX's does."""
    h, w = 8, 10
    mind = np.array([4.0, 5.0, 6.0, 7.0], np.float32)
    vis = np.array([True, False, True, True])
    uv = np.array([[3, 4], [3, 4], [3, 4], [5, 1]], np.int32)
    got = tds.splat_depth_samples(torch.from_numpy(mind), torch.from_numpy(vis),
                                  torch.from_numpy(uv), h, w).numpy()
    want = np.asarray(jds.splat_depth_samples(jnp.asarray(mind), jnp.asarray(vis),
                                              jnp.asarray(uv), h, w))
    assert got[3, 4] == want[3, 4] == 6.0 and got[5, 1] == 7.0
    _same(got, want)


def test_resize_map_matches():
    m = np.random.default_rng(0).uniform(0, 5, (30, 44)).astype(np.float32)
    for hw in ((30, 44), (45, 66), (17, 23)):
        for nearest in (False, True):
            _same(tdu.resize_map(m, hw, nearest), jdu.resize_map(m, hw, nearest))


# -- the PIL-free resizes -------------------------------------------------------

@pytest.mark.parametrize("hw,out", [((720, 1280), (576, 1024)), ((1440, 2560), (1080, 1920)),
                                    ((50, 100), (32, 64)), ((300, 200), (1024, 683)),
                                    ((33, 47), (20, 70))])
def test_resize_uint8_bilinear_is_pils(hw, out):
    """PIL's Image.resize(BILINEAR) without PIL: every pixel equal (the
    stated tolerance is one grey level; none differs)."""
    rng = np.random.default_rng(sum(hw))
    img = rng.integers(0, 256, (*hw, 3), np.uint8)
    img[: hw[0] // 3] = np.linspace(0, 255, hw[1])[None, :, None].astype(np.uint8)
    want = np.asarray(Image.fromarray(img).resize(out[::-1], Image.BILINEAR)).astype(int)
    got = resize_uint8_bilinear(img, out).astype(int)
    diff = np.abs(got - want)
    assert diff.max() <= 1 and (diff > 0).mean() == 0.0


@pytest.mark.parametrize("hw,out,atol", [((64, 64), (256, 256), 1e-6),
                                         ((256, 256), (1024, 1024), 1e-6),
                                         ((64, 80), (48, 64), 1e-4),
                                         ((200, 300), (224, 224), 1e-4)])
def test_resize_like_jax(hw, out, atol):
    x = np.random.default_rng(0).normal(size=(2, 3, *hw)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 3, *out), "bilinear"))
    np.testing.assert_allclose(resize_like_jax(torch.from_numpy(x), out).numpy(), want,
                               rtol=0, atol=atol)


def test_read_rgb_without_pil(tmp_path, monkeypatch):
    """With PIL unimportable, a PNG and a JPEG decode to PIL's pixels."""
    import sys

    rgba = np.random.default_rng(0).integers(0, 255, (9, 11, 4), np.uint8)
    Image.fromarray(rgba).save(tmp_path / "a.png")
    Image.fromarray(rgba[..., :3]).save(tmp_path / "b.jpg")
    want_jpg = np.asarray(Image.open(tmp_path / "b.jpg").convert("RGB"))
    monkeypatch.setitem(sys.modules, "PIL", None)
    _same(read_rgb(str(tmp_path / "a.png"), "cpu"), rgba[..., :3])
    _same(read_rgb(str(tmp_path / "b.jpg"), "cpu"), want_jpg)
