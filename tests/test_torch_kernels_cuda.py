"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test skips, with its reason, where no CUDA device is
present. On a machine with a card: python -m pytest tests/test_torch_kernels_cuda.py -q
"""

import numpy as np
import pytest
import torch

from gags_torch.splat import kernels
from gags_torch.splat.rasterizer import RasterizeConfig, _prepare, order_ext, rasterize
from gags_torch.utils.synthetic import make_camera, make_scene

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


@pytest.mark.parametrize("cdim", [3, 4, 5, 16, 17])
@pytest.mark.parametrize("tile", [(16, 16), (32, 32), (8, 16)])
def test_blend_forward_matches_plain(dev, cdim, tile):
    args = _inputs(dev, 4000, cdim, tile=tile)
    got = kernels.blend_forward(*args)
    want = kernels.blend_forward_plain(*args)
    torch.cuda.synchronize()
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


def _aligned_inputs(dev, n, cdim, width=320, height=180, tile=(16, 16), chunk=128):
    raw = make_scene(n, seed=3, extent=3.0, feature_dim=cdim)
    cam = make_camera(width, height, device=dev)
    t = {k: torch.as_tensor(v, device=dev) for k, v in raw.items()}
    cfg = RasterizeConfig(tile_h=tile[0], tile_w=tile[1], chunk=chunk)
    _, binned, geom, tx, ty = _prepare(t["means"], t["quats"], t["scales"],
                                       t["opacities"], cam.viewmat, cam.K,
                                       width, height, cfg)
    perm = order_ext(binned.order.long())
    col = torch.cat([t["features"], torch.zeros((1, cdim), device=dev)])[perm].contiguous()
    return binned, geom[perm].contiguous(), col, tx, ty


@pytest.mark.parametrize("cdim,tile", [(16, (16, 16)), (16, (32, 32)), (3, (8, 16)), (5, (32, 32))])
def test_blend_forward_aligned_matches_plain(dev, cdim, tile):
    binned, geom, col, tx, ty = _aligned_inputs(dev, 4000, cdim, tile=tile)
    bg = torch.linspace(0.1, 0.5, cdim, device=dev)
    args = (geom, col, binned.inst_gid, binned.tile_starts, binned.tile_counts, bg,
            tx, ty, tile[0], tile[1])
    kernels.reset_launch_counts()
    got = kernels.blend_forward_aligned(*args)
    want = kernels.blend_forward_plain(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts["blend_forward_aligned"] == 1
    err = (got - want).abs()
    assert float(err.mean()) <= 1e-5
    assert float((err > 2e-5 + 1e-4 * want.abs()).float().mean()) < 1e-3


@pytest.mark.parametrize("cdim,tile", [(16, (16, 16)), (16, (32, 32)), (3, (8, 16)), (5, (32, 32))])
def test_blend_backward_matches_plain(dev, cdim, tile):
    binned, geom, _, tx, ty = _aligned_inputs(dev, 4000, cdim, tile=tile)
    g = torch.as_tensor(np.random.default_rng(0).normal(size=(tx * ty, tile[0] * tile[1], cdim)),
                        dtype=torch.float32, device=dev)
    args = (geom, binned.inst_gid, binned.tile_starts, binned.tile_counts, g, tx, ty,
            tile[0], tile[1])
    got = kernels.blend_backward(*args)
    want = kernels.blend_backward_plain(*args)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    err = (got - want).abs()
    outside = err > 1e-6 + 1e-4 * want.abs()
    # sums in another order (atomics) plus isolated threshold flips
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
    thousands of times larger than mx, my and opacity). Atomics add in no
    fixed order, and isolated splats may flip at the 1/255 or 1e-4
    thresholds (NUMERICS.md): at most 0.1% of a column's values outside
    1e-5 max|g| + 1e-4 rel, its mean error at most 1e-6 max|g| and 1e-3
    mean|g|."""
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


@pytest.mark.parametrize("cdim,saturated", [(3, False), (3, True), (8, True), (16, False),
                                            (16, True)])
def test_blend_backward_full_matches_plain(dev, cdim, saturated):
    raw = make_scene(4000, seed=4, extent=3.0 if not saturated else 0.6, feature_dim=cdim)
    if saturated:  # near-opaque, concentrated: rays end early, alphas clamp at 0.999
        raw["opacities"] = np.random.default_rng(1).uniform(0.9, 0.9999, 4000).astype(np.float32)
        raw["scales"] *= 3.0
    cam = make_camera(320, 180, device=dev)
    t = {k: torch.as_tensor(v, device=dev) for k, v in raw.items()}
    cfg = RasterizeConfig(tile_h=16, tile_w=16)
    _, binned, geom, tx, ty = _prepare(t["means"], t["quats"], t["scales"], t["opacities"],
                                       cam.viewmat, cam.K, 320, 180, cfg)
    perm = order_ext(binned.order.long())
    col = torch.cat([t["features"], torch.zeros((1, cdim), device=dev)])[perm].contiguous()
    rng = np.random.default_rng(cdim)
    npix = 16 * 16
    g_img = torch.as_tensor(rng.normal(size=(tx * ty, npix, cdim)), dtype=torch.float32, device=dev)
    g_alpha = torch.as_tensor(rng.normal(size=(tx * ty, npix, 1)), dtype=torch.float32, device=dev)
    args = (geom[perm].contiguous(), col, binned.inst_gid, binned.tile_starts, binned.tile_counts,
            g_img, g_alpha, tx, ty, 16, 16)
    kernels.reset_launch_counts()
    got = kernels.blend_backward_full(*args)
    want = kernels.blend_backward_full_plain(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts["blend_backward_full"] == 1
    if saturated:
        out = kernels.blend_forward_plain(*args[:5], torch.zeros(cdim, device=dev), tx, ty, 16, 16)
        assert int((out[..., -1] > 0.999).sum()) > 100  # many rays end early
    _k8_compare(got[0], want[0], f"colour C={cdim}")
    _k8_compare(got[1][:, :6], want[1][:, :6], f"geometry C={cdim}")
    assert not got[1][:, 6:].any()


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
