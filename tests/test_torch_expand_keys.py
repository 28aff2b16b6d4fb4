"""K7 expand_keys (plain version), the fused and culled unaligned binning
and ellipse_tile_keep of gags_torch against gags_tpu, with the Pallas
kernels in interpret mode. Replays the cases of
tests/test_pallas_rasterizer.py's fused-keys and tile-cull tests."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gags_tpu.splat import pallas_kernel as pk
from gags_tpu.splat import tiles as jt
from gags_tpu.splat.projection import project_gaussians as jproj
from gags_tpu.splat.rasterizer import _cull_rows as j_cull_rows
from gags_torch.splat import kernels
from gags_torch.splat import tiles as tt

W, H, F = 64, 32, 40.0
TW, TH, CHUNK = 16, 8, 8


def _t(a):
    return torch.tensor(np.asarray(a))


def _scene(n, seed):
    """tests/test_pallas_rasterizer.py's _scene, projected by JAX."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n),
                      rng.uniform(3, 9, n)], 1).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(rng.normal(-1.8, 0.4, size=(n, 3))).astype(np.float32)
    op = rng.uniform(0.2, 0.95, n).astype(np.float32)
    return means, quats, scales, op


def _edge_scene(case):
    """tests/test_pallas_rasterizer.py's test_fused_keys_edge_cases inputs."""
    rng = np.random.default_rng(21)
    if case == "one_big":
        n = 1
        means = np.array([[0.0, 0.0, 4.0]], np.float32)
        scales = np.array([[2.0, 2.0, 2.0]], np.float32)
    else:
        n = 300
        z = -5.0 if case == "invisible" else 5.0
        means = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                          np.full(n, z) + rng.uniform(0, 1, n)], 1).astype(np.float32)
        scales = np.exp(rng.normal(-1.8, 0.4, (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    op = rng.uniform(0.2, 0.95, n).astype(np.float32)
    return means, quats, scales, op


def _single_instance_scene():
    rng = np.random.default_rng(11)
    n = 2000
    means = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n),
                      rng.uniform(3, 9, n)], 1).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = np.full((n, 3), 1e-3, np.float32)
    op = rng.uniform(0.2, 0.95, n).astype(np.float32)
    return means, quats, scales, op


def _project(means, quats, scales, op):
    vm = jnp.eye(4)
    K = jnp.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]], jnp.float32)
    p = jproj(jnp.asarray(means), jnp.asarray(quats), jnp.asarray(scales), vm, K, W, H,
              opacities=jnp.asarray(op))
    return p, j_cull_rows(p, jnp.asarray(op))


# (scene, cull, force_u32, budget): the cases of test_fused_keys_matches_classic_binning,
# test_fused_keys_edge_cases, test_fused_keys_single_instance_ranks and
# test_tile_cull_image_exact
CASES = {
    "classic_cull": (lambda: _scene(200, 1), True, False, 8 * 200),
    "classic_nocull": (lambda: _scene(200, 1), False, False, 8 * 200),
    "classic_cull_u32": (lambda: _scene(150, 2), True, True, 8 * 150),
    "classic_tight_budget": (lambda: _scene(300, 3), True, False, 2 * 300),
    "edge_invisible": (lambda: _edge_scene("invisible"), True, False, 8 * 300),
    "edge_tiny_budget": (lambda: _edge_scene("tiny_budget"), True, False, 8),
    "edge_one_big": (lambda: _edge_scene("one_big"), True, False, 8),
    "single_instance_ranks": (_single_instance_scene, False, False, 2 * 2000),
    "tile_cull_image_exact": (lambda: _scene(200, 3), True, False, 8 * 200),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    """JAX's projection, cull rows and binnings of a case: its fused path
    (pallas_kernel.expand_keys) and its unfused one (expand_gid, the row
    gather and the key chain)."""
    make, cull, force_u32, budget = CASES[name]
    p, cr = _project(*make())
    jb = {fused: jax.jit(functools.partial(
        jt.bin_gaussians, width=W, height=H, tile_w=TW, tile_h=TH, budget=budget,
        chunk=CHUNK, aligned=False, interpret=True, _force_u32_keys=force_u32,
        fused_keys=fused,
    ))(p.means2d, p.radii_x, p.depths, radii_y=p.radii_y, cull_rows=cr if cull else None)
        for fused in (True, False)}
    return p, (cr if cull else None), budget, jb


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("name", list(CASES))
def test_bin_gaussians_fused_and_culled_match_jax(name, fused):
    """The port's binning (K7 or K6 + the key chain, cull on or off as the
    case says) equals JAX's fused and unfused binnings on every field."""
    p, cr, budget, jb = _case(name)
    kernels.reset_launch_counts()
    bt = tt.bin_gaussians(
        _t(p.means2d), _t(p.radii_x), _t(p.depths), W, H, TW, TH, budget=budget,
        chunk=CHUNK, radii_y=_t(p.radii_y), cull_rows=None if cr is None else _t(cr),
        fused_keys=fused,
    )
    assert kernels.launch_counts["expand_keys"] == 0  # plain versions on the CPU
    for field in ("inst_gid", "tile_starts", "tile_counts", "num_valid", "overflow", "order"):
        b = getattr(bt, field).numpy()
        assert b.dtype == np.int32, field
        for jax_fused, ref in jb.items():
            np.testing.assert_array_equal(b, np.asarray(getattr(ref, field)),
                                          err_msg=f"{field} (JAX fused_keys={jax_fused})")
    assert int(bt.tile_counts.sum()) == int(bt.num_valid)
    if name == "edge_invisible":
        assert int(bt.num_valid) == 0
    if name == "single_instance_ranks":
        assert int(bt.num_valid) > 1024
    if name == "classic_tight_budget":
        assert int(bt.overflow) > 0


@pytest.mark.parametrize("name", ["classic_cull", "classic_cull_u32", "tile_cull_image_exact"])
def test_cull_sheds_instances_and_keeps_overflow(name):
    """With the cull, num_valid is the kept count (below the uncut one) and
    overflow stays the budget's."""
    p, cr, budget, _ = _case(name)
    kw = dict(budget=budget, chunk=CHUNK, radii_y=_t(p.radii_y))
    on = tt.bin_gaussians(_t(p.means2d), _t(p.radii_x), _t(p.depths), W, H, TW, TH,
                          cull_rows=_t(cr), **kw)
    off = tt.bin_gaussians(_t(p.means2d), _t(p.radii_x), _t(p.depths), W, H, TW, TH, **kw)
    assert int(on.num_valid) < int(off.num_valid)
    assert int(on.overflow) == int(off.overflow)
    # an aligned binning ignores the cull, as in JAX
    al_on = tt.bin_gaussians(_t(p.means2d), _t(p.radii_x), _t(p.depths), W, H, TW, TH,
                             cull_rows=_t(cr), aligned=True, fused_keys=True, **kw)
    al_off = tt.bin_gaussians(_t(p.means2d), _t(p.radii_x), _t(p.depths), W, H, TW, TH,
                              aligned=True, **kw)
    for field in ("inst_gid", "tile_starts", "tile_counts", "num_valid"):
        assert torch.equal(getattr(al_on, field), getattr(al_off, field)), field


def _jax_expand_keys(offsets, packed_p, inc, num_valid, m_real, shift, cull_p, key_u32):
    """pallas_kernel.expand_keys on the table gags_tpu.splat.tiles builds."""
    n = offsets.shape[0]
    kk = pk.EXPAND_K
    nc = -(-m_real // kk)
    pad_len = pk.EXPAND_KW + 128
    g_lo_sb = np.searchsorted(inc, np.arange(nc * (kk // pk.KEYS_SB)) * pk.KEYS_SB,
                              side="right").astype(np.int32)

    def row(vals, pad=0.0):
        return np.concatenate([vals.astype(np.float32), np.full(pad_len, pad, np.float32)])

    rows = [row(np.minimum(offsets, m_real), float(m_real)), row(packed_p & 1023),
            row((packed_p >> 10) & 1023), row((packed_p >> 20) & 1023, 1.0)]
    if cull_p is not None:
        rows += [row(cull_p[:, i]) for i in range(6)]
    rows += [np.zeros(n + pad_len, np.float32)] * (16 - len(rows))
    keys, cnt = pk.expand_keys(
        jnp.asarray(np.stack(rows)), jnp.asarray(g_lo_sb), jnp.asarray(np.int32(num_valid)),
        shift=shift, tiles_x=-(-W // TW), tile_w=TW, tile_h=TH, has_cull=cull_p is not None,
        key_u32=key_u32, interpret=True)
    return np.asarray(keys), np.asarray(cnt)


def _decode(keys, shift, filler):
    """(is filler, tile, rank) of every key."""
    k = keys.astype(np.uint64)  # every key is non-negative
    fill = k == np.uint64(filler)
    tile = (k >> np.uint64(shift)).astype(np.int64)
    rank = (k & np.uint64((1 << shift) - 1)).astype(np.int64)
    return fill, np.where(fill, -1, tile), np.where(fill, -1, rank)


@pytest.mark.parametrize("name", ["classic_cull", "classic_nocull", "classic_cull_u32",
                                  "classic_tight_budget", "single_instance_ranks"])
def test_expand_keys_plain_matches_pallas(name):
    """K7's plain version against pallas_kernel.expand_keys on the same
    per-rank table: keys decoded to (filler, tile, rank), counts exact."""
    p, cr, budget, _ = _case(name)
    force_u32 = CASES[name][2]
    n = p.means2d.shape[0]
    tiles_x, tiles_y = -(-W // TW), -(-H // TH)
    order, packed_p, offsets, inc = tt.depth_ranks(
        _t(p.means2d), _t(p.radii_x), _t(p.depths), TW, TH, tiles_x, tiles_y,
        radii_y=_t(p.radii_y))
    m_real = -(-budget // CHUNK) * CHUNK
    g_cut = int(np.searchsorted(inc.numpy(), m_real, side="right"))
    num_valid = int(inc[g_cut - 1]) if g_cut > 0 else 0
    shift = max(1, n.bit_length())
    cull_p = None if cr is None else _t(cr)[order].contiguous()
    mk = tt.expansion_slots(budget, CHUNK)
    keys, counts = kernels.expand_keys_plain(
        offsets, packed_p, torch.tensor(num_valid, dtype=torch.int32), mk, shift=shift,
        tiles_x=tiles_x, tile_w=TW, tile_h=TH, cull_p=cull_p)
    key_u32 = force_u32 or (tiles_x * tiles_y) << shift >= 2**31
    jkeys, jcnt = _jax_expand_keys(offsets.numpy(), packed_p.numpy(), inc.numpy(), num_valid,
                                   m_real, shift, None if cull_p is None else cull_p.numpy(),
                                   key_u32)
    assert keys.dtype == torch.int64 and keys.shape == jkeys.shape
    jmax = np.iinfo(jkeys.dtype).max
    for a, b, what in zip(_decode(keys.numpy(), shift, kernels.INT64_MAX),
                          _decode(jkeys, shift, jmax), ("filler", "tile", "rank")):
        np.testing.assert_array_equal(a, b, err_msg=what)
    np.testing.assert_array_equal(counts.numpy(), jcnt)
    if cull_p is not None:
        assert int(counts.sum()) < num_valid
    else:
        assert int(counts.sum()) == num_valid


def test_expand_keys_plain_equals_unfused_chain():
    """K7's plain version is K6's plain version followed by slot_keys."""
    p, cr, budget, _ = _case("classic_cull")
    tiles_x = -(-W // TW)
    order, packed_p, offsets, inc = tt.depth_ranks(
        _t(p.means2d), _t(p.radii_x), _t(p.depths), TW, TH, tiles_x, -(-H // TH),
        radii_y=_t(p.radii_y))
    nv = inc[-1].to(torch.int32)
    kw = dict(shift=8, tiles_x=tiles_x, tile_w=TW, tile_h=TH, cull_p=_t(cr)[order])
    keys, counts = kernels.expand_keys(offsets, packed_p, nv, 2048, **kw)
    gid = kernels.expand_gid(offsets, 2048)
    keys2, valid = kernels.slot_keys(gid, offsets, packed_p, nv, **kw)
    assert torch.equal(keys, keys2)
    assert torch.equal(counts, valid.reshape(2, 1024).sum(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="multiple of 1024"):
        kernels.expand_keys(offsets, packed_p, nv, 1000, **kw)


def _ellipse_inputs():
    """tests/test_pallas_rasterizer.py's test_ellipse_tile_keep_conservative."""
    rng = np.random.default_rng(3)
    m = 512
    tw, th = 16, 16
    tile_x = rng.integers(0, 8, m).astype(np.int32)
    tile_y = rng.integers(0, 8, m).astype(np.int32)
    mx = (tile_x * tw + rng.uniform(-24, 40, m)).astype(np.float32)
    my = (tile_y * th + rng.uniform(-24, 40, m)).astype(np.float32)
    ang = rng.uniform(0, np.pi, m)
    s1 = rng.uniform(0.5, 12, m)
    s2 = rng.uniform(0.5, 12, m)
    ca_, sa_ = np.cos(ang), np.sin(ang)
    ia, ib = 1 / s1**2, 1 / s2**2
    a = (ca_**2 * ia + sa_**2 * ib).astype(np.float32)
    c = (sa_**2 * ia + ca_**2 * ib).astype(np.float32)
    b = (ca_ * sa_ * (ia - ib)).astype(np.float32)
    lvl = rng.uniform(0.5, 6.0, m).astype(np.float32)
    return tile_x, tile_y, tw, th, np.stack([mx, my, a, b, c, lvl], axis=1)


def test_ellipse_tile_keep_bit_equal_and_conservative():
    tile_x, tile_y, tw, th, cull = _ellipse_inputs()
    got = tt.ellipse_tile_keep(torch.as_tensor(tile_x), torch.as_tensor(tile_y), tw, th,
                               torch.as_tensor(cull)).numpy()
    want = np.asarray(jt.ellipse_tile_keep(jnp.asarray(tile_x), jnp.asarray(tile_y), tw, th,
                                           jnp.asarray(cull)))
    np.testing.assert_array_equal(got, want)
    # never drops a tile with a pixel centre at sigma <= L (brute force),
    # and drops at least half the tiles that have none
    gx, gy = np.meshgrid(np.arange(tw) + 0.5, np.arange(th) + 0.5)
    mx, my, a, b, c, lvl = cull.T
    has_pixel = np.array([
        ((0.5 * (a[i] * u * u + c[i] * v * v) + b[i] * u * v) <= lvl[i]).any()
        for i in range(len(tile_x))
        for u, v in [(tile_x[i] * tw + gx - mx[i], tile_y[i] * th + gy - my[i])]
    ])
    assert not (has_pixel & ~got).any()
    assert (~has_pixel).sum() > 50 and got.sum() > 50
    assert (~got).sum() >= 0.5 * (~has_pixel).sum()


def test_ellipse_tile_keep_propagates_nan_like_jax():
    """Degenerate conics (c = 0 with b ub = 0: -b ub / c = 0/0) give a NaN
    edge minimum: JAX's clip and minimum propagate it, so the tile is kept
    only when the mean is inside; the port does the same."""
    cull = np.array([[8.0, 8.0, 1.0, 0.0, 0.0, 2.0],    # c = 0: edge_u is NaN
                     [40.0, 8.0, 0.0, 0.0, 1.0, 2.0],   # a = 0: edge_v is NaN
                     [40.0, 40.0, 1.0, 0.1, 1.0, 2.0]], np.float32)
    tx = np.array([0, 0, 0], np.int32)
    ty = np.array([0, 0, 0], np.int32)
    got = tt.ellipse_tile_keep(torch.as_tensor(tx), torch.as_tensor(ty), 16, 16,
                               torch.as_tensor(cull)).numpy()
    want = np.asarray(jt.ellipse_tile_keep(jnp.asarray(tx), jnp.asarray(ty), 16, 16,
                                           jnp.asarray(cull)))
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [True, False, False]


def test_cull_rows_match_jax():
    from gags_torch.splat.projection import project_gaussians
    from gags_torch.splat.rasterizer import _cull_rows

    means, quats, scales, op = _scene(200, 4)
    jp, jcr = _project(means, quats, scales, op)
    K = torch.tensor([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]], dtype=torch.float32)
    tp = project_gaussians(*(torch.as_tensor(a) for a in (means, quats, scales)),
                           torch.eye(4), K, W, H, opacities=torch.as_tensor(op))
    got = _cull_rows(tp, torch.as_tensor(op))
    assert got.shape == (200, 6) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jcr), rtol=1e-5, atol=1e-5)
