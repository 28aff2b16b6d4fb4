"""gags_torch.splat.tiles (unaligned binning, K6 plain version) vs
gags_tpu.splat.tiles with the Pallas kernels in interpret mode."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gags_tpu.splat import pallas_kernel as pk
from gags_tpu.splat import tiles as jt
from gags_tpu.splat.projection import project_gaussians as jproj
from gags_torch.splat import kernels
from gags_torch.splat import tiles as tt
from owner_cases import OWNER_CASES, owner_offsets

W, H, F = 64, 32, 40.0


def _alive_first_offsets(n, seed, n_empty):
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 6, size=n).astype(np.int32)
    counts[n - n_empty:] = 0  # alive-first: empty ranks last
    inc = np.cumsum(counts).astype(np.int32)
    return inc - counts, inc


@pytest.mark.parametrize("n,seed,n_empty", [(300, 0, 0), (700, 1, 50), (1500, 2, 400)])
def test_expand_gid_plain_matches_pallas(n, seed, n_empty):
    offsets, inc = _alive_first_offsets(n, seed, n_empty)
    total = int(inc[-1])
    nc = -(-total // pk.EXPAND_K)
    n_pad = n + pk.EXPAND_W + 128
    off_tbl = np.zeros((8, n_pad), np.int32)
    off_tbl[0, :n] = offsets
    off_tbl[0, n:] = np.iinfo(np.int32).max
    g_lo_sb = np.searchsorted(
        inc, np.arange(nc * (pk.EXPAND_K // pk.KEYS_SB)) * pk.KEYS_SB, side="right"
    ).astype(np.int32)
    want = np.clip(
        np.asarray(pk.expand_gid(jnp.asarray(off_tbl), jnp.asarray(g_lo_sb), interpret=True)),
        0, n - 1,
    )
    got = kernels.expand_gid(torch.as_tensor(offsets), nc * pk.EXPAND_K).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got[:total], want[:total])
    # and the definition: #{j : off[j] <= i} - 1
    i = np.arange(total)
    np.testing.assert_array_equal(got[:total], (offsets[None, :] <= i[:, None]).sum(1) - 1)


@pytest.mark.parametrize("kind", OWNER_CASES)
def test_expand_gid_plain_matches_definition(kind):
    """gid[i] = clip(#{j : off[j] <= i} - 1, 0, n - 1), the count taken
    from a histogram of the offsets (no search), on runs of empty ranks in
    the middle and at the end, offsets[0] > 0, n = 1 and slots past the
    total."""
    offsets, end = owner_offsets(kind)
    n = offsets.shape[0]
    for num_slots in (end + 3001, max(1, end // 2 + 3)):
        got = kernels.expand_gid_plain(torch.as_tensor(offsets), num_slots).numpy()
        at_most = np.cumsum(np.bincount(offsets[offsets < num_slots], minlength=num_slots))
        want = np.clip(at_most[:num_slots] - 1, 0, n - 1)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_expand_gid_wrapper_stays_plain_on_cpu():
    kernels.reset_launch_counts()
    off = torch.tensor([0, 2, 2, 5], dtype=torch.int32)
    got = kernels.expand_gid(off, 7)
    assert got.tolist() == [0, 0, 2, 2, 2, 3, 3]
    assert kernels.launch_counts["expand_gid"] == 0


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
    p = jproj(*map(jnp.asarray, (means, quats, scales, vm, K)), W, H, opacities=jnp.asarray(op))
    return p


BIN_CASES = [
    # (n, seed, (tile_h, tile_w), chunk, budget_factor, behind, jax_kwargs)
    (200, 0, (8, 16), 8, 4.0, 0.0, {}),
    (300, 1, (16, 16), 8, 4.0, 0.0, {}),
    (250, 2, (8, 16), 128, 4.0, 0.0, {}),
    (400, 3, (16, 16), 128, 3.0, 0.0, {}),
    (300, 4, (8, 16), 8, 0.2, 0.0, {}),  # budget overflow
    (300, 5, (8, 16), 8, 4.0, 0.0, {"_force_u32_keys": True}),
    (600, 6, (8, 16), 8, 4.0, 0.6, {}),  # many culled: stable-sort trap
]


@pytest.mark.parametrize("n,seed,tile,chunk,bf,behind,jkw", BIN_CASES)
def test_bin_gaussians_matches_jax(n, seed, tile, chunk, bf, behind, jkw):
    p = _scene(n, seed, behind)
    th, tw = tile
    budget = max(int(bf * n), 4 * chunk) if bf >= 1 else int(bf * n)
    bj = jax.jit(functools.partial(
        jt.bin_gaussians, width=W, height=H, tile_w=tw, tile_h=th, budget=budget,
        chunk=chunk, aligned=False, interpret=True, **jkw,
    ))(p.means2d, p.radii_x, p.depths, radii_y=p.radii_y)
    bt = tt.bin_gaussians(
        _t(p.means2d), _t(p.radii_x), _t(p.depths), W, H, tw, th, budget=budget,
        chunk=chunk, radii_y=_t(p.radii_y),
    )
    for name in ("inst_gid", "tile_starts", "tile_counts", "num_valid", "overflow", "order"):
        a = np.asarray(getattr(bj, name))
        b = getattr(bt, name).numpy()
        assert b.dtype == np.int32, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    if bf < 1:
        assert int(bt.overflow) > 0
    else:
        assert int(bt.overflow) == 0
    if behind:
        assert int((np.asarray(p.radii) == 0).sum()) > n // 2


def test_tile_rects_matches_jax():
    p = _scene(200, 9)
    args = (16, 8, 4, 4)
    rj = jt.tile_rects(p.means2d, p.radii_x, *args, radii_y=p.radii_y)
    rt = tt.tile_rects(_t(p.means2d), _t(p.radii_x), *args, radii_y=_t(p.radii_y))
    for a, b in zip(rj, rt):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
