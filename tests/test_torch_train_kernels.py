"""The plain versions of K1-K4 (the functions the CUDA kernels compute) vs
the Pallas kernels of gags_tpu in interpret mode, on the same inputs; and
the kernel build's hash of shared headers."""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gags_tpu.splat import pallas_kernel as pk
from gags_tpu.splat import tiles as jt
from gags_torch import _kernels
from gags_torch.splat import kernels
from gags_torch.splat.rasterizer import RasterizeConfig, _prepare, order_ext

W, H, F = 64, 32, 40.0
TH, TW, CHUNK = 8, 16, 8


def _binning(n, seed, cdim):
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n),
                      rng.uniform(3, 9, n)], 1).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(rng.normal(-1.8, 0.4, size=(n, 3))).astype(np.float32)
    op = rng.uniform(0.2, 0.95, n).astype(np.float32)
    col = rng.uniform(-1, 1, (n, cdim)).astype(np.float32)
    vm = np.eye(4, dtype=np.float32)
    K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]], np.float32)
    cfg = RasterizeConfig(tile_h=TH, tile_w=TW, chunk=CHUNK, budget_factor=6)
    t = [torch.as_tensor(a) for a in (means, quats, scales, op, vm, K)]
    _, binned, geom, tx, ty = _prepare(*t[:4], t[4], t[5], W, H, cfg)
    perm = order_ext(binned.order.long())
    colors = torch.cat([torch.as_tensor(col), torch.zeros((1, cdim))])[perm]
    return binned, geom[perm].contiguous(), colors.contiguous(), tx, ty


def _inst_data(geom, colors, inst_gid):
    """The Pallas kernels' (8+C, M) lane-major instance table, channels
    padded to a multiple of 8."""
    cpad = -colors.shape[1] % 8
    table = torch.cat([geom, torch.nn.functional.pad(colors, (0, cpad))], 1)
    return jnp.asarray(table[inst_gid.long()].T.numpy())


@pytest.mark.parametrize("cdim,seed,with_bg", [(3, 0, False), (8, 1, True), (16, 2, True)])
def test_blend_forward_aligned_plain_matches_pallas(cdim, seed, with_bg):
    binned, geom, colors, tx, ty = _binning(150, seed, cdim)
    bg = torch.linspace(0.1, 0.9, cdim) if with_bg else torch.zeros(cdim)
    got = kernels.blend_forward_aligned(geom, colors, binned.inst_gid, binned.tile_starts,
                                        binned.tile_counts, bg, tx, ty, TH, TW)
    out = pk.tile_blend_forward(
        _inst_data(geom, colors, binned.inst_gid), jnp.asarray(binned.tile_starts.numpy()),
        jnp.asarray(binned.tile_counts.numpy()),
        jnp.asarray(np.pad(bg.numpy(), (0, -cdim % 8))),
        tiles_x=tx, tiles_y=ty, tile_h=TH, tile_w=TW, chunk=CHUNK, interpret=True,
    )
    want = np.asarray(out)
    got = got.numpy()
    np.testing.assert_allclose(got[..., :cdim], want[..., :cdim], atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got[..., -1], want[..., -1], atol=2e-5, rtol=1e-4)
    assert (got[..., -1] > 0.5).any()


@pytest.mark.parametrize("cdim,seed", [(3, 3), (8, 4), (16, 5)])
def test_blend_backward_plain_matches_pallas(cdim, seed):
    binned, geom, colors, tx, ty = _binning(150, seed, cdim)
    g = np.random.default_rng(seed).normal(size=(tx * ty, TH * TW, cdim)).astype(np.float32)
    got = kernels.blend_backward(geom, binned.inst_gid, binned.tile_starts, binned.tile_counts,
                                 torch.as_tensor(g), tx, ty, TH, TW).numpy()
    want = np.asarray(pk.tile_blend_backward(
        _inst_data(geom, colors, binned.inst_gid), jnp.asarray(binned.tile_starts.numpy()),
        jnp.asarray(binned.tile_counts.numpy()), jnp.asarray(g),
        tiles_x=tx, tiles_y=ty, tile_h=TH, tile_w=TW, chunk=CHUNK, interpret=True,
    ))
    assert got.shape == want.shape == (binned.inst_gid.shape[0], cdim)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-4)
    assert np.abs(got).max() > 0.1


@pytest.mark.parametrize("n,seed,cdim", [(150, 6, 16), (400, 7, 3), (200, 9, 8), (256, 10, 8)])
def test_sorted_segment_sum_plain_matches_pallas(n, seed, cdim):
    binned, _, _, _, _ = _binning(n, seed, cdim)
    red = binned.red
    m = binned.inst_gid.shape[0]
    rows = np.random.default_rng(seed).normal(size=(m, cdim)).astype(np.float32)
    rows[binned.inst_gid.numpy() == n] = 0.0  # dummies and fillers, as K2 leaves them
    got = kernels.sorted_segment_sum(torch.as_tensor(rows), red.slot_to_pos, red.slot_rank,
                                     red.chunk_block, n + 1).numpy()
    rows_ext = np.concatenate([rows, np.zeros((1, cdim), np.float32)])
    rows_u16 = jt.u16_halves(jnp.asarray(rows_ext))[jnp.asarray(red.slot_to_pos.numpy())]
    want = np.asarray(pk.sorted_segment_sum(
        rows_u16, jnp.asarray(red.slot_rank.numpy()), jnp.asarray(red.chunk_block.numpy()),
        num_ranks=n + 1, interpret=True))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    # the n real ranks, as the rasterizer's backward asks (the layout's
    # blocks hold 128 ranks: at n = 256 the sentinel rank's block lies past
    # them)
    real = kernels.sorted_segment_sum(torch.as_tensor(rows), red.slot_to_pos, red.slot_rank,
                                      red.chunk_block, n).numpy()
    np.testing.assert_array_equal(real, got[:n])
    # and the definition: per-rank sums over inst_gid
    np.testing.assert_allclose(got, jax.ops.segment_sum(rows, binned.inst_gid.numpy(), n + 1),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("segments,cdim,kind", [
    pytest.param(17, 2, "iid", id="17-2"), pytest.param(33, 5, "iid", id="33-5"),
    pytest.param(1025, 2, "iid", id="1025-2"), pytest.param(1025, 33, "iid", id="1025-33"),
    pytest.param(17, 2, "runs", id="runs-17-2"), pytest.param(1025, 33, "runs", id="runs-1025-33"),
    pytest.param(1025, 33, "one", id="one-1025-33"), pytest.param(33, 5, "one", id="one-33-5")])
def test_dense_segment_sum_plain_matches_pallas(segments, cdim, kind):
    rng = np.random.default_rng(segments + cdim)
    p = 3000
    if kind == "iid":  # some out of range
        ids = rng.integers(-3, segments + 4, size=p)
    elif kind == "runs":  # runs of 64 pixels, as SAM masks along a row; some out of range
        ids = np.repeat(rng.integers(-3, segments + 4, size=-(-p // 64)), 64)[:p]
    else:  # one segment everywhere
        ids = np.full(p, segments // 2)
    ids = ids.astype(np.int32)
    vals = rng.normal(size=(p, cdim)).astype(np.float32)
    got = kernels.dense_segment_sum(torch.as_tensor(vals), torch.as_tensor(ids), segments).numpy()
    want = np.asarray(pk.dense_segment_sum_fwd(jnp.asarray(vals), jnp.asarray(ids), segments,
                                               interpret=True))
    if kind == "one":
        # one segment sums all p terms, and two float32 orders differ by
        # ~u * sqrt(p) of the terms' absolute sum: held at 4x that (the
        # bound chip_smoke.py holds K4 to); every other row exactly zero
        s = segments // 2
        bound = 4 * 2.0 ** -24 * np.sqrt(p) * np.abs(vals).sum(0)
        assert (np.abs(got[s] - want[s]) <= bound).all()
        assert not np.delete(got, s, 0).any() and not np.delete(want, s, 0).any()
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_dense_segment_sum_plain_matches_segment_sum_4097():
    rng = np.random.default_rng(4097)
    p = 20_000
    ids = rng.integers(-2, 4100, size=p).astype(np.int32)
    vals = rng.normal(size=(p, 33)).astype(np.float32)
    got = kernels.dense_segment_sum(torch.as_tensor(vals), torch.as_tensor(ids), 4097).numpy()
    keep = (ids >= 0) & (ids < 4097)
    want = np.asarray(jax.ops.segment_sum(vals[keep], ids[keep], num_segments=4097))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_cpu_wrappers_launch_no_kernel():
    kernels.reset_launch_counts()
    binned, geom, colors, tx, ty = _binning(60, 8, 3)
    g = torch.ones((tx * ty, TH * TW, 3))
    kernels.blend_forward_aligned(geom, colors, binned.inst_gid, binned.tile_starts,
                                  binned.tile_counts, torch.zeros(3), tx, ty, TH, TW)
    gi = kernels.blend_backward(geom, binned.inst_gid, binned.tile_starts, binned.tile_counts,
                                g, tx, ty, TH, TW)
    kernels.sorted_segment_sum(gi, binned.red.slot_to_pos, binned.red.slot_rank,
                               binned.red.chunk_block, 61)
    kernels.dense_segment_sum(torch.ones((5, 2)), torch.arange(5, dtype=torch.int32), 3)
    gc, gg = kernels.blend_backward_full(geom, colors, binned.inst_gid, binned.tile_starts,
                                         binned.tile_counts, g, torch.zeros_like(g[..., :1]),
                                         tx, ty, TH, TW)
    assert gc.shape == (binned.inst_gid.shape[0], 3) and gg.shape == (binned.inst_gid.shape[0], 8)
    off = torch.tensor([0, 2, 2, 5], dtype=torch.int32)
    packed = torch.tensor([1 << 20] * 4, dtype=torch.int32)
    keys, counts = kernels.expand_keys(off, packed, torch.tensor(5, dtype=torch.int32), 1024,
                                       shift=3, tiles_x=4, tile_w=16, tile_h=16)
    # one-column rects (pw = 1): slot s of a rank lies s tiles down
    assert counts.tolist() == [5] and keys[:5].tolist() == [0, 32, 2, 34, 66]
    assert set(kernels.launch_counts.values()) == {0}
    assert set(kernels.launch_counts) == {
        "blend_forward_aligned", "blend_backward", "blend_backward_full", "sorted_segment_sum",
        "dense_segment_sum", "blend_forward", "expand_gid", "expand_keys"}


def test_library_path_follows_included_headers(tmp_path):
    """Editing a shared header renames every library that includes it, so
    a stale build is never reused; unrelated files change nothing."""
    src = tmp_path / "k.cu"
    shutil.copy(kernels.CSRC / "blend_common.cuh", tmp_path / "blend_common.cuh")
    (tmp_path / "extra.cuh").write_text("#pragma once\n")
    src.write_text('#include "blend_common.cuh"\n#include <cuda_runtime.h>\nint f() { return 1; }\n')
    first = _kernels._lib_path(src)
    assert _kernels._lib_path(src) == first
    (tmp_path / "unrelated.cuh").write_text("// not included\n")
    assert _kernels._lib_path(src) == first
    with open(tmp_path / "blend_common.cuh", "a") as f:
        f.write("// edited\n")
    second = _kernels._lib_path(src)
    assert second != first and second.name.startswith("k-")
    # a header included from a header counts too
    with open(tmp_path / "blend_common.cuh", "a") as f:
        f.write('#include "extra.cuh"\n')
    third = _kernels._lib_path(src)
    (tmp_path / "extra.cuh").write_text("#pragma once\n// edited\n")
    assert _kernels._lib_path(src) not in (third, second, first)
    assert [h.name for h in _kernels._local_headers(kernels.BLEND_BACKWARD_SRC)] == [
        "blend_common.cuh"]
