"""The order in which the blends start the tiles (kernels.TileOrder):
the rasterizer makes it once per binning and hands the same order to the
forward (K1 or K5) and to the backward (K2 or K8), the wrappers take
nothing else, and the plain versions, which run on the CPU, ignore it."""

import numpy as np
import pytest
import torch

from gags_torch.splat import kernels
from gags_torch.splat import rasterizer as tr
from gags_torch.splat.rasterizer import RasterizeConfig, _prepare, order_ext
from gags_torch.utils.synthetic import make_camera, make_scene

W, H, N = 64, 32, 150
TILE = dict(tile_h=8, tile_w=16, chunk=8)


def _scene(seed, cdim):
    raw = make_scene(N, seed=seed, feature_dim=cdim)
    cam = make_camera(W, H)
    geo = [torch.as_tensor(raw[k]) for k in ("means", "quats", "scales", "opacities")]
    return geo, torch.as_tensor(raw["features"]), cam


def _record(monkeypatch, names):
    """Wrap kernels.<name> for each name: record the tile_order of each call."""
    seen = {name: [] for name in names}
    for name in names:
        orig = getattr(kernels, name)

        def rec(*args, _orig=orig, _name=name, tile_order=None, **kw):
            seen[_name].append(tile_order)
            return _orig(*args, tile_order=tile_order, **kw)

        monkeypatch.setattr(kernels, name, rec)
    return seen


@pytest.mark.parametrize("geometry_grads", [False, True])
def test_forward_and_backward_share_one_tile_order(monkeypatch, geometry_grads):
    geo, cols, cam = _scene(0, 3)
    cfg = RasterizeConfig(geometry_grads=geometry_grads, **TILE)
    backward = "blend_backward_full" if geometry_grads else "blend_backward"
    seen = _record(monkeypatch, ["blend_forward_aligned", backward])
    cols = cols.clone().requires_grad_(True)
    res = tr.rasterize(*geo, cols, cam.viewmat, cam.K, W, H, config=cfg, device="cpu")
    res.image.square().sum().backward()
    assert cols.grad is not None and torch.isfinite(cols.grad).all()
    (fwd,), (bwd,) = seen["blend_forward_aligned"], seen[backward]
    assert isinstance(fwd, kernels.TileOrder)
    assert fwd is bwd  # the order the forward made, not a second sort
    with torch.no_grad():
        _, binned, _, _, _ = _prepare(*geo, cam.viewmat, cam.K, W, H, cfg)
    assert torch.equal(fwd._tiles, kernels._tile_order(binned.tile_counts))


def test_rasterize_binned_shares_one_tile_order(monkeypatch):
    geo, cols, cam = _scene(1, 16)
    cfg = RasterizeConfig(**TILE)
    b = tr.prepare_binning(*geo[:3], cam.viewmat, cam.K, W, H, cfg, opacities=geo[3])
    seen = _record(monkeypatch, ["blend_forward_aligned", "blend_backward"])
    cols = cols.clone().requires_grad_(True)
    img, _ = tr.rasterize_binned(*geo, cols, cam.viewmat, cam.K, b.inst_gid, b.tile_starts,
                                 b.tile_counts, W, H, config=cfg, order=b.order,
                                 red_slot=b.red.slot_to_pos, red_rank=b.red.slot_rank,
                                 red_block=b.red.chunk_block)
    img.sum().backward()
    (fwd,), (bwd,) = seen["blend_forward_aligned"], seen["blend_backward"]
    assert fwd is bwd
    assert torch.equal(fwd._tiles, kernels._tile_order(b.tile_counts))


def test_inference_blend_gets_the_tile_order(monkeypatch):
    geo, cols, cam = _scene(2, 16)
    cfg = RasterizeConfig(aligned=False, **TILE)
    seen = _record(monkeypatch, ["blend_forward"])
    tr.rasterize(*geo, cols, cam.viewmat, cam.K, W, H, config=cfg, device="cpu")
    (order,) = seen["blend_forward"]
    _, binned, _, _, _ = _prepare(*geo, cam.viewmat, cam.K, W, H, cfg)
    assert torch.equal(order._tiles, kernels._tile_order(binned.tile_counts))


def _binned_args(cdim):
    geo, cols, cam = _scene(3, cdim)
    cfg = RasterizeConfig(**TILE)
    _, b, geom, tx, ty = _prepare(*geo, cam.viewmat, cam.K, W, H, cfg)
    perm = order_ext(b.order.long())
    table = torch.cat([cols, torch.zeros((1, cdim))])[perm].contiguous()
    return geom[perm].contiguous(), table, b, tx, ty, cfg


@pytest.mark.parametrize("kernel", ["blend_forward", "blend_forward_aligned", "blend_backward",
                                    "blend_backward_full"])
def test_plain_versions_ignore_the_tile_order(kernel):
    geom, table, b, tx, ty, cfg = _binned_args(3)
    th, tw = cfg.tile_h, cfg.tile_w
    rng = np.random.default_rng(0)
    g = torch.as_tensor(rng.normal(size=(tx * ty, th * tw, 3)), dtype=torch.float32)
    ga = torch.as_tensor(rng.normal(size=(tx * ty, th * tw, 1)), dtype=torch.float32)
    bg = torch.linspace(0.1, 0.5, 3)
    args = {
        "blend_forward": (geom, table, b.inst_gid, b.tile_starts, b.tile_counts, bg),
        "blend_forward_aligned": (geom, table, b.inst_gid, b.tile_starts, b.tile_counts, bg),
        "blend_backward": (geom, b.inst_gid, b.tile_starts, b.tile_counts, g),
        "blend_backward_full": (geom, table, b.inst_gid, b.tile_starts, b.tile_counts, g, ga),
    }[kernel] + (tx, ty, th, tw)
    fn = getattr(kernels, kernel)
    increasing = kernels.TileOrder(-b.tile_counts)  # the tiles by increasing count
    want, got = fn(*args), fn(*args, tile_order=increasing)
    for a, c in zip(want if isinstance(want, tuple) else (want,),
                    got if isinstance(got, tuple) else (got,)):
        assert torch.equal(a, c)


def test_tile_order_is_decreasing_counts_ties_in_tile_order():
    counts = torch.tensor([3, 7, 0, 7, 3, 9], dtype=torch.int32)
    order = kernels._tile_order(counts)
    assert order.dtype == torch.int32
    assert order.tolist() == [5, 1, 3, 0, 4, 2]


def test_order_argument_is_checked():
    counts = torch.tensor([3, 7, 0, 7], dtype=torch.int32)
    assert torch.equal(kernels._order_arg(None, counts, 4), kernels._tile_order(counts))
    given = kernels.TileOrder(counts)
    assert torch.equal(kernels._order_arg(given, counts, 4), torch.tensor([1, 3, 0, 2]).int())
    with pytest.raises(ValueError):  # an order of other tiles
        kernels._order_arg(kernels.TileOrder(counts[:3]), counts, 4)
    with pytest.raises(TypeError):  # only a TileOrder: the kernels index with it
        kernels._order_arg(torch.tensor([1, 3, 0, 2], dtype=torch.int32), counts, 4)
