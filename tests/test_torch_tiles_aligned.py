"""gags_torch aligned (training) binning and its ReductionLayout vs
gags_tpu.splat.tiles, element by element."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gags_tpu.splat import tiles as jt
from gags_tpu.splat.projection import project_gaussians as jproj
from gags_torch.splat import tiles as tt

W, H, F = 64, 32, 40.0


def _t(a):
    return torch.tensor(np.asarray(a))


def _scene(n, seed, behind=0.0):
    rng = np.random.default_rng(seed)
    z = rng.uniform(3, 9, n)
    z[: int(behind * n)] = rng.uniform(-4, -0.5, int(behind * n))  # culled
    means = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n), z], 1)
    means = means[rng.permutation(n)].astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(rng.normal(-1.8, 0.4, size=(n, 3))).astype(np.float32)
    op = rng.uniform(0.02, 0.95, n).astype(np.float32)
    vm = np.eye(4, dtype=np.float32)
    K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]], np.float32)
    return jproj(*map(jnp.asarray, (means, quats, scales, vm, K)), W, H,
                 opacities=jnp.asarray(op))


CASES = [
    # (n, seed, (tile_h, tile_w), chunk, budget_factor, behind)
    (60, 0, (8, 16), 8, 4.0, 0.0),
    (200, 1, (8, 16), 8, 4.0, 0.0),
    (300, 2, (16, 16), 8, 4.0, 0.0),
    (250, 3, (8, 16), 128, 4.0, 0.0),
    (150, 4, (8, 8), 16, 3.0, 0.0),
    (300, 5, (8, 16), 8, 0.2, 0.0),  # budget overflow
    (600, 6, (8, 16), 8, 4.0, 0.6),  # many culled Gaussians
]


@pytest.mark.parametrize("n,seed,tile,chunk,bf,behind", CASES)
def test_aligned_binning_matches_jax(n, seed, tile, chunk, bf, behind):
    p = _scene(n, seed, behind)
    th, tw = tile
    budget = max(int(bf * n), 4 * chunk) if bf >= 1 else int(bf * n)
    bj = jax.jit(functools.partial(
        jt.bin_gaussians, width=W, height=H, tile_w=tw, tile_h=th, budget=budget,
        chunk=chunk, aligned=True, interpret=True,
    ))(p.means2d, p.radii_x, p.depths, radii_y=p.radii_y)
    bt = tt.bin_gaussians(
        _t(p.means2d), _t(p.radii_x), _t(p.depths), W, H, tw, th, budget=budget,
        chunk=chunk, radii_y=_t(p.radii_y), aligned=True,
    )
    assert bt.inst_gid.shape[0] == tt.aligned_budget(budget, bt.tile_starts.shape[0], chunk)
    for name in ("inst_gid", "tile_starts", "tile_counts", "num_valid", "overflow", "order"):
        a = np.asarray(getattr(bj, name))
        b = getattr(bt, name).numpy()
        assert b.dtype == np.int32, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    for name in ("slot_to_pos", "slot_rank", "chunk_block"):
        a = np.asarray(getattr(bj.red, name))
        b = getattr(bt.red, name).numpy()
        assert b.dtype == np.int32, name
        np.testing.assert_array_equal(b, a, err_msg=f"red.{name}")
    # every range starts on a chunk and real instances precede the dummies
    starts, counts = bt.tile_starts.numpy(), bt.tile_counts.numpy()
    assert (starts % chunk == 0).all()
    gid = bt.inst_gid.numpy()
    for s, c in zip(starts, counts):
        assert (gid[s:s + c] < n).all()
        assert (gid[s + c:s + -(-c // chunk) * chunk] == n).all()
    if bf < 1:
        assert int(bt.overflow) > 0
    if behind:
        assert int((np.asarray(p.radii) == 0).sum()) > n // 2


@pytest.mark.parametrize("n,seed", [(40, 0), (300, 1), (1000, 2)])
def test_reduction_layout_matches_jax(n, seed):
    """Duplicated ranks (each rank in several tiles, every dummy rank n):
    only a stable sort reproduces slot_to_pos."""
    rng = np.random.default_rng(seed)
    gid = rng.integers(0, n + 1, size=3 * n + 17).astype(np.int32)
    gid[rng.random(gid.shape[0]) < 0.3] = n
    rj = jt.reduction_layout(jnp.asarray(gid), n)
    rt = tt.reduction_layout(torch.as_tensor(gid), n)
    for name in ("slot_to_pos", "slot_rank", "chunk_block"):
        np.testing.assert_array_equal(getattr(rt, name).numpy(), np.asarray(getattr(rj, name)),
                                      err_msg=name)


def test_spread_sorted_matches_jax():
    field = np.array([3, 7, 7, 2, 9], np.int32)
    offsets = np.array([0, 2, 2, 5, 11], np.int32)
    want = np.asarray(jt.spread_sorted(jnp.asarray(field), jnp.asarray(offsets), 12))
    got = tt.spread_sorted(torch.as_tensor(field), torch.as_tensor(offsets), 12).numpy()
    np.testing.assert_array_equal(got, want)
