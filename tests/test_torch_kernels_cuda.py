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


def _inputs(dev, n, cdim, width=320, height=180, tile=(16, 16)):
    raw = make_scene(n, seed=1, extent=3.0, feature_dim=cdim)
    cam = make_camera(width, height, device=dev)
    t = {k: torch.as_tensor(v, device=dev) for k, v in raw.items()}
    cfg = RasterizeConfig(tile_h=tile[0], tile_w=tile[1])
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
                    cam.viewmat, cam.K, 256, 128, device=dev)
    assert res.image.is_cuda and torch.isfinite(res.image).all()
    assert kernels.launch_counts["expand_gid"] == 1
    assert kernels.launch_counts["blend_forward"] == 1
