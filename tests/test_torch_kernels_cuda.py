"""The CUDA kernels against their plain PyTorch versions, on the card
(K1-K8, P1-P2, and J1 on the JPEG fixtures of tests/data/torch_jpeg).

Marked `cuda`: each test skips, with its reason, where no CUDA device is
present. On a machine with a card: python -m pytest tests/test_torch_kernels_cuda.py -q
"""

import os

import numpy as np
import pytest
import torch

from gags_torch.probes import slab_probe, vpu_probe
from gags_torch.splat import kernels
from gags_torch.utils import jpeg
from gags_torch.splat.rasterizer import RasterizeConfig, _prepare, order_ext, rasterize
from gags_torch.utils.synthetic import make_camera, make_scene
from owner_cases import OWNER_CASES, owner_offsets

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def test_expand_gid_matches_plain(dev):
    rng = np.random.default_rng(0)
    counts = rng.integers(1, 9, size=50_000).astype(np.int32)
    counts[-5000:] = 0
    inc = np.cumsum(counts).astype(np.int32)
    off = torch.as_tensor(inc - counts, device=dev)
    slots = int(inc[-1]) + 3000
    got = kernels.expand_gid(off, slots)
    want = kernels.expand_gid_plain(off, slots)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", OWNER_CASES)
def test_expand_gid_edge_cases_match_plain(dev, kind):
    """K6 bit for bit against its plain version across runs of empty
    ranks longer than a tile, past the total, below offsets[0], for n = 1
    and at slot counts that are no multiple of the tile or of 4."""
    off_np, end = owner_offsets(kind)
    off = torch.as_tensor(off_np, device=dev)
    for num_slots in (end + 3001, end + 1, max(1, end // 2 + 3), 1024 * 3 + 5, 1):
        got = kernels.expand_gid(off, num_slots)
        want = kernels.expand_gid_plain(off, num_slots)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (kind, num_slots, int((got != want).sum()))
    if off.shape[0] > 1:  # a table that does not start on 16 bytes is copied, not misread
        got = kernels.expand_gid(off[1:], end)
        assert torch.equal(got, kernels.expand_gid_plain(off[1:], end))


@pytest.mark.parametrize("cull", [False, True])
@pytest.mark.parametrize("kind", OWNER_CASES)
def test_expand_keys_edge_cases_match_plain(dev, kind, cull):
    """K7 bit for bit against its plain version on the same offsets, with
    num_valid inside a chunk, past the total and 0."""
    off_np, end = owner_offsets(kind)
    n = off_np.shape[0]
    rng = np.random.default_rng(7)
    pw = rng.integers(1, 17, size=n)
    x0, y0 = rng.integers(0, 100, size=n), rng.integers(0, 60, size=n)
    packed = torch.as_tensor((x0 | (y0 << 10) | (pw << 20)).astype(np.int32), device=dev)
    a, c = rng.uniform(0.002, 0.1, size=n), rng.uniform(0.002, 0.1, size=n)
    mx, my = (x0 + pw / 2) * 16 + rng.normal(0, 20, n), (y0 + 2) * 16 + rng.normal(0, 20, n)
    rows = np.stack([mx, my, a, rng.uniform(-0.9, 0.9, size=n) * np.sqrt(a * c), c,
                     rng.uniform(0.0, 6.0, size=n)], 1).astype(np.float32)
    cull_p = torch.as_tensor(rows, device=dev) if cull else None
    off = torch.as_tensor(off_np, device=dev)
    num_slots = -(-(end + 3000) // kernels.EXPAND_K) * kernels.EXPAND_K
    kw = dict(shift=max(1, n.bit_length()), tiles_x=128, tile_w=16, tile_h=16, cull_p=cull_p)
    for nv in (max(0, end - 517), end + 1500, 0):
        args = (off, packed, torch.tensor(nv, dtype=torch.int32, device=dev), num_slots)
        keys, counts = kernels.expand_keys(*args, **kw)
        want_keys, want_counts = kernels.expand_keys_plain(*args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(keys, want_keys), (kind, nv, int((keys != want_keys).sum()))
        assert torch.equal(counts, want_counts), (kind, nv)


def _inputs(dev, n, cdim, width=320, height=180, tile=(16, 16), saturated=False):
    raw = make_scene(n, seed=1, extent=3.0 if not saturated else 0.6, feature_dim=cdim)
    if saturated:  # near-opaque, concentrated: whole tiles stop early
        raw["opacities"] = np.random.default_rng(1).uniform(0.9, 0.9999, n).astype(np.float32)
        raw["scales"] *= 3.0
    cam = make_camera(width, height, device=dev)
    t = {k: torch.as_tensor(v, device=dev) for k, v in raw.items()}
    cfg = RasterizeConfig(tile_h=tile[0], tile_w=tile[1], aligned=False)
    _, binned, geom, tx, ty = _prepare(t["means"], t["quats"], t["scales"],
                                       t["opacities"], cam.viewmat, cam.K,
                                       width, height, cfg)
    perm = order_ext(binned.order.long())
    col = torch.cat([t["features"], torch.zeros((1, cdim), device=dev)])[perm].contiguous()
    bg = torch.linspace(0.1, 0.5, cdim, device=dev)
    return (geom[perm].contiguous(), col, binned.inst_gid, binned.tile_starts,
            binned.tile_counts, bg, tx, ty, tile[0], tile[1])


# C = 32 takes one pixel a thread, the others two; 12x20 is no multiple
# of 8 wide, so warps own runs of 32 consecutive pixels instead of blocks
@pytest.mark.parametrize("cdim", [3, 4, 5, 16, 17, 32])
@pytest.mark.parametrize("tile", [(16, 16), (32, 32), (8, 16), (12, 20)])
def test_blend_forward_matches_plain(dev, cdim, tile):
    args = _inputs(dev, 4000, cdim, tile=tile)
    got = kernels.blend_forward(*args)
    again = kernels.blend_forward(*args)
    want = kernels.blend_forward_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)  # one writer per pixel
    err = (got - want).abs()
    # isolated threshold-boundary flips are allowed (NUMERICS.md)
    assert float(err.mean()) <= 1e-5
    assert float((err > 2e-5 + 1e-4 * want.abs()).float().mean()) < 1e-3


def test_rasterize_on_card_launches_both_kernels(dev):
    kernels.reset_launch_counts()
    raw = make_scene(3000, seed=2, extent=3.0)
    cam = make_camera(256, 128, device=dev)
    res = rasterize(*(torch.as_tensor(raw[k]) for k in ("means", "quats", "scales", "opacities", "features")),
                    cam.viewmat, cam.K, 256, 128, config=RasterizeConfig(aligned=False),
                    device=dev)
    assert res.image.is_cuda and torch.isfinite(res.image).all()
    assert kernels.launch_counts["expand_gid"] == 1
    assert kernels.launch_counts["blend_forward"] == 1


def _aligned_inputs(dev, n, cdim, width=320, height=180, tile=(16, 16), chunk=128,
                    saturated=False):
    raw = make_scene(n, seed=3, extent=3.0 if not saturated else 0.6, feature_dim=cdim)
    if saturated:  # near-opaque, concentrated: rays end early, alphas clamp at 0.999
        raw["opacities"] = np.random.default_rng(1).uniform(0.9, 0.9999, n).astype(np.float32)
        raw["scales"] *= 3.0
    cam = make_camera(width, height, device=dev)
    t = {k: torch.as_tensor(v, device=dev) for k, v in raw.items()}
    cfg = RasterizeConfig(tile_h=tile[0], tile_w=tile[1], chunk=chunk)
    _, binned, geom, tx, ty = _prepare(t["means"], t["quats"], t["scales"],
                                       t["opacities"], cam.viewmat, cam.K,
                                       width, height, cfg)
    perm = order_ext(binned.order.long())
    col = torch.cat([t["features"], torch.zeros((1, cdim), device=dev)])[perm].contiguous()
    return binned, geom[perm].contiguous(), col, tx, ty


# 12x16: 12 rows are no multiple of 8 (4 rows a pixel, two pixels a
# thread), so warps own runs of 32 consecutive pixels
@pytest.mark.parametrize("cdim,tile", [(16, (16, 16)), (16, (32, 32)), (3, (8, 16)), (5, (32, 32)),
                                       (32, (32, 32)), (3, (12, 20)), (16, (12, 16))])
def test_blend_forward_aligned_matches_plain(dev, cdim, tile):
    binned, geom, col, tx, ty = _aligned_inputs(dev, 4000, cdim, tile=tile)
    bg = torch.linspace(0.1, 0.5, cdim, device=dev)
    args = (geom, col, binned.inst_gid, binned.tile_starts, binned.tile_counts, bg,
            tx, ty, tile[0], tile[1])
    kernels.reset_launch_counts()
    got = kernels.blend_forward_aligned(*args)
    again = kernels.blend_forward_aligned(*args)
    want = kernels.blend_forward_plain(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts["blend_forward_aligned"] == 2
    assert torch.equal(got, again)  # one writer per pixel
    err = (got - want).abs()
    assert float(err.mean()) <= 1e-5
    assert float((err > 2e-5 + 1e-4 * want.abs()).float().mean()) < 1e-3


@pytest.mark.parametrize("cdim,tile,saturated", [
    (16, (16, 16), False), (16, (32, 32), False), (3, (8, 16), False), (5, (32, 32), False),
    (17, (32, 32), False), (32, (32, 32), False), (16, (16, 8), False), (3, (32, 32), False),
    (16, (32, 32), True), (16, (12, 20), False)])
def test_blend_backward_matches_plain(dev, cdim, tile, saturated):
    binned, geom, _, tx, ty = _aligned_inputs(dev, 4000, cdim, tile=tile, saturated=saturated)
    g = torch.as_tensor(np.random.default_rng(0).normal(size=(tx * ty, tile[0] * tile[1], cdim)),
                        dtype=torch.float32, device=dev)
    args = (geom, binned.inst_gid, binned.tile_starts, binned.tile_counts, g, tx, ty,
            tile[0], tile[1])
    kernels.reset_launch_counts()
    got = kernels.blend_backward(*args)
    again = kernels.blend_backward(*args)
    want = kernels.blend_backward_plain(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts["blend_backward"] == 2
    assert torch.equal(got, again)  # one writer per row, a fixed order of addition
    assert got.shape == want.shape
    err = (got - want).abs()
    outside = err > 1e-6 + 1e-4 * want.abs()
    # sums in another order plus isolated threshold flips
    assert float(outside.float().mean()) < 1e-3, float(err.max())
    assert float(err.mean()) <= 1e-5


def _heavy_aligned_inputs(dev, n, cdim):
    """An aligned binning at 320x180 in 16x16 tiles (240 tiles) where one
    Gaussian covers every tile and 40 more cover tens of tiles each: ranks
    with many slots, as a large splat near the camera gives."""
    raw = make_scene(n, seed=3, extent=3.0, feature_dim=cdim)
    raw["means"][0] = (0.0, 0.0, 6.0)
    raw["scales"][0] = 3.0
    raw["scales"][1:41] = 0.25
    cam = make_camera(320, 180, device=dev)
    t = {k: torch.as_tensor(v, device=dev) for k, v in raw.items()}
    cfg = RasterizeConfig(tile_h=16, tile_w=16, chunk=128)
    _, binned, _, tx, ty = _prepare(t["means"], t["quats"], t["scales"], t["opacities"],
                                    cam.viewmat, cam.K, 320, 180, cfg)
    rank0 = int((binned.order == 0).nonzero()[0, 0])
    assert int((binned.inst_gid == rank0).sum()) == tx * ty  # the heavy rank
    return binned


@pytest.mark.parametrize("heavy", [False, True])
@pytest.mark.parametrize("cdim", [3, 8, 16])
def test_sorted_segment_sum_matches_plain(dev, cdim, heavy):
    if heavy:
        binned = _heavy_aligned_inputs(dev, 20_000, cdim)
    else:
        binned, _, _, _, _ = _aligned_inputs(dev, 20_000, cdim, tile=(32, 32))
    red = binned.red
    m = binned.inst_gid.shape[0]
    n = binned.order.shape[0]
    rows = torch.as_tensor(np.random.default_rng(cdim).normal(size=(m, cdim)),
                           dtype=torch.float32, device=dev)
    rows[binned.inst_gid == n] = 0.0  # dummies and fillers: K2 leaves them zero
    args = (rows, red.slot_to_pos, red.slot_rank, red.chunk_block)
    kernels.reset_launch_counts()
    got = kernels.sorted_segment_sum(*args, n + 1)
    again = kernels.sorted_segment_sum(*args, n + 1)
    real = kernels.sorted_segment_sum(*args, n)  # as the rasterizer's backward asks
    want = kernels.sorted_segment_sum_plain(*args, n + 1)
    lib = torch.zeros((n + 1, cdim), device=dev).index_add_(0, binned.inst_gid.long(), rows)
    torch.cuda.synchronize()
    assert kernels.launch_counts["sorted_segment_sum"] == 3
    assert torch.equal(got, again)  # a fixed order of additions
    assert torch.equal(real, got[:n])
    if heavy:
        # a rank of 240 slots: both sides round in their own order, so each
        # sum is held to 1e-5 of its terms' absolute sum (as chip_smoke.py's
        # sum_compare); an absolute bound fails where the terms cancel
        abs_sum = kernels.sorted_segment_sum_plain(rows.abs(), *args[1:], n + 1)
        assert bool(((got - want).abs() <= 1e-5 * abs_sum).all())
        assert bool(((got - lib).abs() <= 1e-5 * abs_sum).all())
    else:
        # a rank sums a few rows: only the order of those few additions differs
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(got, lib, rtol=1e-5, atol=1e-6)


def _segment_ids(kind, p, segments, rng):
    if kind == "runs":  # runs of 64 pixels, some out of range
        return np.repeat(rng.integers(-1, segments + 2, size=-(-p // 64)), 64)[:p]
    if kind == "iid":  # no runs at all
        return rng.integers(-1, segments + 2, size=p)
    if kind == "one":  # one segment everywhere
        return np.full(p, segments // 2)
    assert kind == "out"  # every id out of range
    return rng.choice([-7, -1, segments, segments + 5], size=p)


@pytest.mark.parametrize("kind,segments,cdim,p", [
    ("runs", 17, 2, 230_400), ("runs", 1025, 2, 230_400), ("runs", 1025, 33, 230_400),
    ("runs", 4097, 33, 230_400), ("runs", 40000, 3, 230_400),
    ("iid", 4097, 33, 230_400), ("one", 4097, 33, 230_400), ("out", 4097, 2, 230_400),
    ("runs", 4097, 33, 230_417), ("runs", 4097, 1, 100_003), ("runs", 4097, 128, 230_400)])
def test_dense_segment_sum_matches_plain(dev, kind, segments, cdim, p):
    rng = np.random.default_rng(segments + cdim)
    ids = torch.as_tensor(_segment_ids(kind, p, segments, rng).astype(np.int32), device=dev)
    vals = torch.as_tensor(rng.normal(size=(p, cdim)), dtype=torch.float32, device=dev)
    vals[:, 0] = 1.0  # column 0 counts the pixels of each segment
    kernels.reset_launch_counts()
    got = kernels.dense_segment_sum(vals, ids, segments)
    want = kernels.dense_segment_sum_plain(vals.double(), ids, segments)
    torch.cuda.synchronize()
    assert kernels.launch_counts["dense_segment_sum"] == 1
    assert torch.equal(got[:, 0].double(), want[:, 0])  # counts exact
    if kind == "out":
        assert not got.any()
    # float32 sums of up to ~230k unit normals, added by atomics in no fixed
    # order, against a float64 sum: the rounding of the running sum grows
    # with the count, so the bound is absolute
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=2e-3)


def _k8_compare(got, want, what):
    """Column by column, each against its own scale (the conic columns are
    thousands of times larger than mx, my and opacity). The sums are taken
    in another order than the plain version's, and isolated splats may flip
    at the 1/255 or 1e-4 thresholds (NUMERICS.md): at most 0.1% of a
    column's values outside 1e-5 max|g| + 1e-4 rel, its mean error at most
    1e-6 max|g| and 1e-3 mean|g|."""
    assert torch.isfinite(got).all(), what
    for j in range(want.shape[1]):
        g, w = got[:, j], want[:, j]
        scale = float(w.abs().max())
        err = (g - w).abs()
        outside = err > 1e-5 * scale + 1e-4 * w.abs()
        assert scale > 0, (what, j)
        assert float(outside.float().mean()) <= 1e-3, (what, j, int(outside.sum()),
                                                       float(err.max()) / scale)
        assert float(err.mean()) <= 1e-6 * scale, (what, j, float(err.mean()) / scale)
        assert float(err.mean()) <= 1e-3 * float(w.abs().mean()), (what, j, float(err.mean()))


def _k8_args(dev, n, cdim, tile, saturated=False, width=320, height=180):
    raw = make_scene(n, seed=4, extent=3.0 if not saturated else 0.6, feature_dim=cdim)
    if saturated:  # near-opaque, concentrated: rays end early, alphas clamp at 0.999
        raw["opacities"] = np.random.default_rng(1).uniform(0.9, 0.9999, n).astype(np.float32)
        raw["scales"] *= 3.0
    cam = make_camera(width, height, device=dev)
    t = {k: torch.as_tensor(v, device=dev) for k, v in raw.items()}
    cfg = RasterizeConfig(tile_h=tile[0], tile_w=tile[1])
    _, binned, geom, tx, ty = _prepare(t["means"], t["quats"], t["scales"], t["opacities"],
                                       cam.viewmat, cam.K, width, height, cfg)
    perm = order_ext(binned.order.long())
    col = torch.cat([t["features"], torch.zeros((1, cdim), device=dev)])[perm].contiguous()
    rng = np.random.default_rng(cdim)
    npix = tile[0] * tile[1]
    g_img = torch.as_tensor(rng.normal(size=(tx * ty, npix, cdim)), dtype=torch.float32, device=dev)
    g_alpha = torch.as_tensor(rng.normal(size=(tx * ty, npix, 1)), dtype=torch.float32, device=dev)
    return (geom[perm].contiguous(), col, binned.inst_gid, binned.tile_starts, binned.tile_counts,
            g_img, g_alpha, tx, ty, tile[0], tile[1])


def _k8_check(args, cdim, saturated):
    kernels.reset_launch_counts()
    got = kernels.blend_backward_full(*args)
    again = kernels.blend_backward_full(*args)
    want = kernels.blend_backward_full_plain(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts["blend_backward_full"] == 2
    # one writer per row, a fixed order of addition
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    if saturated:
        tx, ty, th, tw = args[7:]
        out = kernels.blend_forward_plain(*args[:5], torch.zeros(cdim, device=args[0].device),
                                          tx, ty, th, tw)
        assert int((out[..., -1] > 0.999).sum()) > 100  # many rays end early
    _k8_compare(got[0], want[0], f"colour C={cdim}")
    _k8_compare(got[1][:, :6], want[1][:, :6], f"geometry C={cdim}")
    assert not got[1][:, 6:].any()


@pytest.mark.parametrize("cdim,saturated,tile,frame", [
    (3, False, (16, 16), None), (3, True, (16, 16), None), (8, True, (16, 16), None),
    (16, False, (16, 16), None), (16, True, (16, 16), None), (3, False, (32, 32), None),
    (3, True, (32, 32), None), (16, False, (32, 32), None), (5, False, (32, 32), None),
    (32, False, (32, 32), None), (3, False, (16, 8), None), (17, True, (16, 8), None),
    # 12x20: a width that is no multiple of 8, so warps own runs of
    # consecutive pixels instead of 8x4 blocks
    (3, False, (12, 20), None), (5, False, (12, 20), None),
    # the RGB trainer's frame: 920 tiles of very different counts
    (3, False, (32, 32), (1280, 720, 20_000)), (3, True, (32, 32), (1280, 720, 20_000)),
    (1, False, (32, 32), (1280, 720, 20_000))])
def test_blend_backward_full_matches_plain(dev, cdim, saturated, tile, frame):
    width, height, n = frame or (320, 180, 4000)
    _k8_check(_k8_args(dev, n, cdim, tile, saturated, width, height), cdim, saturated)


def test_rasterize_geometry_gradient_on_card_matches_cpu(dev):
    """Gradients for means, quats, scales, opacities and colours through
    K1, K8, K3 and the projection on the card equal the plain versions' on
    the CPU."""
    raw = make_scene(3000, seed=2, extent=3.0)
    cfg = RasterizeConfig(tile_h=16, tile_w=16, geometry_grads=True)
    grads = {}
    for d in (dev, torch.device("cpu")):
        cam = make_camera(128, 96, device=d)
        ts = [torch.as_tensor(raw[k], device=d).requires_grad_(True)
              for k in ("means", "quats", "scales", "opacities", "features")]
        res = rasterize(*ts, cam.viewmat, cam.K, 128, 96, config=cfg, device=d)
        w = torch.linspace(-1, 1, res.image.numel(), device=d).reshape(res.image.shape)
        ((res.image * w).sum() + res.alpha.sum()).backward()
        grads[d.type] = [t.grad.cpu() for t in ts]
    # the two devices round the projection differently, so a splat may
    # flip at a threshold: at most 0.1% of values outside 1e-4 max|g| +
    # 1e-3 rel, mean error at most 1e-5 max|g|
    for name, a, b in zip(("means", "quats", "scales", "opacities", "colors"),
                          grads["cuda"], grads["cpu"]):
        scale = float(b.abs().max())
        err = (a - b).abs()
        assert scale > 0 and torch.isfinite(a).all(), name
        assert float((err > 1e-4 * scale + 1e-3 * b.abs()).float().mean()) <= 1e-3, name
        assert float(err.mean()) <= 1e-5 * scale, name


def test_rasterize_gradient_on_card_matches_cpu(dev):
    """The colour gradient through K1, K2 and K3 on the card equals the
    plain versions' on the CPU."""
    raw = make_scene(3000, seed=2, extent=3.0)
    cfg = RasterizeConfig(tile_h=16, tile_w=16)
    grads = {}
    for d in (dev, torch.device("cpu")):
        cam = make_camera(128, 96, device=d)
        cols = torch.as_tensor(raw["features"], device=d).requires_grad_(True)
        res = rasterize(*(torch.as_tensor(raw[k], device=d) for k in ("means", "quats", "scales", "opacities")),
                        cols, cam.viewmat, cam.K, 128, 96, config=cfg, device=d)
        w = torch.linspace(-1, 1, res.image.numel(), device=d).reshape(res.image.shape)
        (res.image * w).sum().backward()
        grads[d.type] = cols.grad.cpu()
    torch.testing.assert_close(grads["cuda"], grads["cpu"], rtol=1e-4, atol=1e-5)


def _key_inputs(dev, n, cull, budget_factor=4.0, width=320, height=180, tile=16):
    """Per-rank binning inputs of K7 from a real projection on the card."""
    from gags_torch.splat import tiles
    from gags_torch.splat.projection import project_gaussians
    from gags_torch.splat.rasterizer import _cull_rows

    raw = make_scene(n, seed=5, extent=3.0)
    cam = make_camera(width, height, device=dev)
    t = {k: torch.as_tensor(v, device=dev) for k, v in raw.items()}
    proj = project_gaussians(t["means"], t["quats"], t["scales"], cam.viewmat, cam.K, width,
                             height, opacities=t["opacities"])
    tx, ty = -(-width // tile), -(-height // tile)
    order, packed_p, offsets, inc = tiles.depth_ranks(proj.means2d, proj.radii_x, proj.depths,
                                                      tile, tile, tx, ty, radii_y=proj.radii_y)
    budget = int(budget_factor * n)
    m_real = -(-budget // 128) * 128
    nv = inc[min(int(torch.searchsorted(inc, torch.tensor([m_real], dtype=torch.int32,
                                                              device=dev), right=True)) - 1,
                 n - 1)]
    kw = dict(shift=max(1, n.bit_length()), tiles_x=tx, tile_w=tile, tile_h=tile,
              cull_p=_cull_rows(proj, t["opacities"])[order].contiguous() if cull else None)
    return proj, t, (offsets, packed_p, nv.to(torch.int32), tiles.expansion_slots(budget, 128)), kw


@pytest.mark.parametrize("cull,budget_factor", [(False, 4.0), (True, 4.0), (True, 0.5)])
def test_expand_keys_matches_plain(dev, cull, budget_factor):
    """K7 against its plain version: keys and per-chunk counts exact (the
    cull's arithmetic is written with round-to-nearest intrinsics); the
    fused binning equals the K6 binning field by field."""
    from gags_torch.splat import tiles

    proj, t, args, kw = _key_inputs(dev, 20_000, cull, budget_factor)
    kernels.reset_launch_counts()
    keys, counts = kernels.expand_keys(*args, **kw)
    want_keys, want_counts = kernels.expand_keys_plain(*args, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts["expand_keys"] == 1
    assert torch.equal(keys, want_keys) and torch.equal(counts, want_counts)
    cull_rows = None
    if cull:
        from gags_torch.splat.rasterizer import _cull_rows

        cull_rows = _cull_rows(proj, t["opacities"])
    b = [tiles.bin_gaussians(proj.means2d, proj.radii_x, proj.depths, 320, 180, 16, 16,
                             budget=int(budget_factor * 20_000), radii_y=proj.radii_y,
                             cull_rows=cull_rows, fused_keys=fused) for fused in (False, True)]
    for field in ("inst_gid", "tile_starts", "tile_counts", "num_valid", "overflow", "order"):
        assert torch.equal(getattr(b[0], field), getattr(b[1], field)), field
    if budget_factor < 1:
        assert int(b[1].overflow) > 0


def _k5_inputs(dev, cdim, saturate=False):
    return _inputs(dev, 4000, cdim, tile=(32, 32), saturated=saturate)


@pytest.mark.parametrize("cdim", [3, 16])
@pytest.mark.parametrize("opt", ["fast_color_rows", "blend_bf16"])
def test_blend_forward_bf16_options_match_plain(dev, cdim, opt):
    args = _k5_inputs(dev, cdim)
    got = kernels.blend_forward(*args, **{opt: True})
    want = kernels.blend_forward_plain(*args, **{opt: True})
    f32 = kernels.blend_forward_plain(*args)
    torch.cuda.synchronize()
    err = (got - want).abs()
    assert float(err.mean()) <= 1e-5
    assert float((err > 2e-5 + 1e-4 * want.abs()).float().mean()) < 1e-3
    if opt == "blend_bf16":  # and the documented contract against f32
        scale = float(f32[..., :cdim].abs().max())
        d = (got[..., :cdim] - f32[..., :cdim]).abs()
        assert float(d.max()) <= 5e-2 * scale and float(d.mean()) <= 5e-3 * scale
        assert float((got[..., cdim] - f32[..., cdim]).abs().max()) <= 0.03


@pytest.mark.parametrize("saturate", [False, True])
def test_blend_forward_exit_stats_and_block_exit(dev, saturate):
    args = _k5_inputs(dev, 16, saturate)
    out, stats = kernels.blend_forward(*args, exit_stats=True)
    out_p, stats_p = kernels.blend_forward_plain(*args, exit_stats=True)
    plain_out = kernels.blend_forward(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, plain_out)  # the counters leave the image alone
    assert torch.equal(kernels.blend_forward(*args, block_exit=True), plain_out)
    s, sp = stats[:, 0, :5], stats_p[:, 0, :5]
    assert not stats[:, 1:].any() and not stats[:, 0, 5:].any()
    assert torch.equal(s[:, 1], sp[:, 1]) and torch.equal(s[:, 3], sp[:, 3])
    moved = (s[:, 0] != sp[:, 0]) | (s[:, 2] != sp[:, 2])
    assert int(moved.sum()) <= 1  # an isolated threshold flip
    torch.testing.assert_close(s[~moved, 4], sp[~moved, 4], rtol=0, atol=1e-4)
    if saturate:
        assert int((s[:, 2] < s[:, 3]).sum()) > 0


def _frame_inputs(dev, n, cdim, aligned, saturated):
    """A 1280x720 frame in 32x32 tiles (920 tiles) whose counts differ
    from tile to tile and reach several batches of the forward's staging
    (128 instances): the tile order and the double buffer at work."""
    raw = make_scene(n, seed=5, extent=3.0, feature_dim=cdim)
    if saturated:  # near-opaque: pixels stop in the middle of a batch
        raw["opacities"] = np.random.default_rng(5).uniform(0.9, 0.9999, n).astype(np.float32)
    cam = make_camera(1280, 720, device=dev)
    t = {k: torch.as_tensor(v, device=dev) for k, v in raw.items()}
    cfg = RasterizeConfig(aligned=aligned, budget_factor=8)
    _, b, geom, tx, ty = _prepare(t["means"], t["quats"], t["scales"], t["opacities"],
                                  cam.viewmat, cam.K, 1280, 720, cfg)
    assert int(b.overflow) == 0
    perm = order_ext(b.order.long())
    col = torch.cat([t["features"], torch.zeros((1, cdim), device=dev)])[perm].contiguous()
    bg = torch.linspace(0.1, 0.5, cdim, device=dev)
    return (geom[perm].contiguous(), col, b.inst_gid, b.tile_starts, b.tile_counts, bg,
            tx, ty, cfg.tile_h, cfg.tile_w)


@pytest.mark.parametrize("aligned,saturated,cdim", [
    (True, False, 16), (True, True, 3), (False, False, 16), (False, True, 3)])
def test_blend_forward_heavy_frame(dev, aligned, saturated, cdim):
    args = _frame_inputs(dev, 250_000, cdim, aligned, saturated)
    counts = args[4]
    assert int(counts.max()) > 3 * 128 and int(counts.min()) < int(counts.max())
    fn = kernels.blend_forward_aligned if aligned else kernels.blend_forward
    got = fn(*args)
    again = fn(*args)
    want = kernels.blend_forward_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    if saturated:
        assert int((want[..., -1] > 0.999).sum()) > 1000  # many pixels stop early
    err = (got - want).abs()
    assert float(err.mean()) <= 1e-5
    assert float((err > 2e-5 + 1e-4 * want.abs()).float().mean()) < 1e-3


@pytest.mark.parametrize("kernel", ["blend_forward", "blend_forward_aligned", "blend_backward",
                                    "blend_backward_full"])
def test_tile_order_is_only_a_schedule(dev, kernel):
    """Each blend given the order the forward made (kernels.TileOrder, as
    the rasterizer passes it), the order it sorts itself and the tiles by
    increasing count: the same bits (each output row has one writer)."""
    cdim = 3
    args = _frame_inputs(dev, 20_000, cdim, aligned=kernel != "blend_forward", saturated=False)
    geom, col, gid, starts, counts, bg, tx, ty, th, tw = args
    if kernel.startswith("blend_forward"):
        call = lambda **kw: getattr(kernels, kernel)(*args, **kw)  # noqa: E731
    else:
        rng = np.random.default_rng(0)
        g = torch.as_tensor(rng.normal(size=(tx * ty, th * tw, cdim)), dtype=torch.float32,
                            device=dev)
        if kernel == "blend_backward":
            call = lambda **kw: kernels.blend_backward(  # noqa: E731
                geom, gid, starts, counts, g, tx, ty, th, tw, **kw)
        else:
            ga = torch.as_tensor(rng.normal(size=(tx * ty, th * tw, 1)), dtype=torch.float32,
                                 device=dev)
            call = lambda **kw: kernels.blend_backward_full(  # noqa: E731
                geom, col, gid, starts, counts, g, ga, tx, ty, th, tw, **kw)
    own = call()
    for order in (kernels.TileOrder(counts), kernels.TileOrder(-counts)):
        got = call(tile_order=order)
        for a, b in zip(own if isinstance(own, tuple) else (own,),
                        got if isinstance(got, tuple) else (got,)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("aligned", [False, True])
def test_blend_forward_needles_and_faint_splats(dev, aligned):
    """Splats whose conics are far from round (needles: the per-warp box
    test must leave them to the per-pixel test or bound them safely) and
    splats too faint to reach the alpha floor (skipped everywhere)."""
    n, cdim = 6000, 16
    raw = make_scene(n, seed=6, extent=3.0, feature_dim=cdim)
    raw["scales"][: n // 2, 0] *= 40.0
    raw["scales"][: n // 2, 1:] *= 0.05
    raw["opacities"][n // 2: n // 2 + 500] = 0.0038  # ln(255 op) + 0.01 < 0: never blends
    cam = make_camera(320, 180, device=dev)
    t = {k: torch.as_tensor(v, device=dev) for k, v in raw.items()}
    cfg = RasterizeConfig(tile_h=16, tile_w=16, aligned=aligned)
    _, b, geom, tx, ty = _prepare(t["means"], t["quats"], t["scales"], t["opacities"],
                                  cam.viewmat, cam.K, 320, 180, cfg)
    perm = order_ext(b.order.long())
    col = torch.cat([t["features"], torch.zeros((1, cdim), device=dev)])[perm].contiguous()
    args = (geom[perm].contiguous(), col, b.inst_gid, b.tile_starts, b.tile_counts,
            torch.linspace(0.1, 0.5, cdim, device=dev), tx, ty, 16, 16)
    fn = kernels.blend_forward_aligned if aligned else kernels.blend_forward
    got = fn(*args)
    want = kernels.blend_forward_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, fn(*args))
    err = (got - want).abs()
    assert float(err.mean()) <= 1e-5
    assert float((err > 2e-5 + 1e-4 * want.abs()).float().mean()) < 1e-3


@pytest.mark.parametrize("reps", [1, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_vpu_chain_matches_plain(dev, dtype, reps):
    """P1 bit for bit (one rounding per op on both sides), a ragged tail
    included, and bit-identical on a second launch."""
    x = vpu_probe.probe_input((vpu_probe.R, vpu_probe.C + 3), dtype, dev)
    got = vpu_probe.vpu_chain(x, reps)
    assert torch.equal(got, vpu_probe.vpu_chain_plain(x, reps))
    assert torch.equal(got, vpu_probe.vpu_chain(x, reps))


@pytest.mark.parametrize("slab_rows", slab_probe.SLABS + (3,), ids=lambda s: f"slab{s}")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_slab_chain_matches_plain(dev, dtype, slab_rows):
    """P2 bit for bit for every slab, and on a block of no whole 16-byte
    accesses."""
    x = vpu_probe.probe_input((slab_probe.P, slab_probe.G), dtype, dev)
    assert torch.equal(slab_probe.slab_chain(x, slab_rows), slab_probe.slab_chain_plain(x))
    odd = vpu_probe.probe_input((37, 13), dtype, dev)
    assert torch.equal(slab_probe.slab_chain(odd, slab_rows), slab_probe.slab_chain_plain(odd))


_JPEG_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_jpeg")


@pytest.mark.parametrize("name", sorted(f for f in os.listdir(_JPEG_DATA) if f.endswith(".jpg")))
def test_jpeg_decode_matches_plain_and_pil(dev, name):
    """J1 on every committed fixture: the host entropy decoder's
    coefficients equal the Python decoder's; the kernels' pixels equal the
    plain version's and PIL's stored pixels, and a second launch's."""
    with open(os.path.join(_JPEG_DATA, name), "rb") as f:
        jf = jpeg.parse_jpeg(f.read(), name)
    coef = jpeg.entropy_decode_host(jf)
    assert np.array_equal(coef, jpeg.entropy_decode(jf))
    got = jpeg.jpeg_pixels(torch.from_numpy(coef).to(dev), jf.layout())
    want = jpeg.jpeg_pixels_plain(torch.from_numpy(coef), jf.layout())
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    with np.load(os.path.join(_JPEG_DATA, "pixels.npz")) as d:
        assert np.array_equal(got.cpu().numpy(), d[name])
    assert torch.equal(got, jpeg.jpeg_pixels(torch.from_numpy(coef).to(dev), jf.layout()))
