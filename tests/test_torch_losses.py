"""gags_torch.gad.losses / supervision / utils.image vs gags_tpu on the
same numpy inputs (the cases of tests/test_losses.py), and the fused
supervision L1 against the generic composition."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gags_tpu.gad import losses as jl
from gags_tpu.gad import supervision as js
from gags_tpu.utils import image as ji
from gags_torch.gad import losses as tl
from gags_torch.gad import supervision as ts
from gags_torch.gad.train import GadConfig, supervised_l1_pix
from gags_torch.utils import image as ti


def _rand_seg(h, w, n_regions, seed=0, frac_invalid=0.2):
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, n_regions, size=(h, w)).astype(np.int32)
    seg[rng.uniform(size=(h, w)) < frac_invalid] = -1
    return seg


def _close(t, j, **kw):
    np.testing.assert_allclose(np.asarray(t.detach() if isinstance(t, torch.Tensor) else t),
                               np.asarray(j), **kw)


@pytest.mark.parametrize("max_segments", [16, 64, 4096])
def test_region_balanced_l1_matches_jax_and_loop(max_segments):
    h, w = 24, 32
    loss_map = np.random.default_rng(1).uniform(size=(h, w)).astype(np.float32)
    seg = _rand_seg(h, w, 7, seed=2)
    got = float(tl.region_balanced_l1(torch.as_tensor(loss_map), torch.as_tensor(seg), max_segments))
    want = float(jl.region_balanced_l1(jnp.asarray(loss_map), jnp.asarray(seg), max_segments))
    loop = np.mean([loss_map[seg == i].mean() for i in np.unique(seg[seg != -1])])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got, loop, rtol=1e-5)


@pytest.mark.parametrize("max_segments", [64, 4096])
def test_region_variance_loss_matches_jax_and_loop(max_segments):
    h, w, c = 16, 20, 5
    feat = np.random.default_rng(3).normal(size=(h, w, c)).astype(np.float32)
    seg = _rand_seg(h, w, 6, seed=4)
    got = float(tl.region_variance_loss(torch.as_tensor(feat), torch.as_tensor(seg), max_segments))
    want = float(jl.region_variance_loss(jnp.asarray(feat), jnp.asarray(seg), max_segments))
    total = 0.0
    for idx in np.unique(seg[seg != -1]):
        m = seg == idx
        if m.sum() >= 2:
            total += m.sum() * feat[m].var(axis=0, ddof=1).mean()
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(got, total / (h * w), rtol=1e-4)


def test_region_loss_gradients_match_jax():
    """The segment sum's backward is a gather (zero for the invalid
    bucket's out-of-range ids): gradients of both region losses."""
    h, w, c = 12, 10, 4
    rng = np.random.default_rng(9)
    feat = rng.normal(size=(h, w, c)).astype(np.float32)
    lmap = rng.uniform(size=(h, w)).astype(np.float32)
    seg = _rand_seg(h, w, 5, seed=10)
    seg[0, :3] = 30  # beyond max_segments: dropped

    def jf(f, l):
        return jl.region_variance_loss(f, jnp.asarray(seg), 16) + jl.region_balanced_l1(
            l, jnp.asarray(seg), 16)

    gj = jax.grad(jf, argnums=(0, 1))(jnp.asarray(feat), jnp.asarray(lmap))
    ft = torch.as_tensor(feat).requires_grad_(True)
    lt = torch.as_tensor(lmap).requires_grad_(True)
    (tl.region_variance_loss(ft, torch.as_tensor(seg), 16)
     + tl.region_balanced_l1(lt, torch.as_tensor(seg), 16)).backward()
    _close(ft.grad, gj[0], atol=1e-6, rtol=1e-4)
    _close(lt.grad, gj[1], atol=1e-6, rtol=1e-4)
    assert float(lt.grad[0, 0]) == 0.0


def test_small_losses_match_jax():
    rng = np.random.default_rng(11)
    p = rng.dirichlet([1, 1, 1], size=(5, 7)).astype(np.float32)
    _close(tl.scale_entropy_loss(torch.as_tensor(p)), jl.scale_entropy_loss(jnp.asarray(p)), rtol=1e-6)
    np.testing.assert_allclose(
        float(tl.scale_entropy_loss(torch.tensor([[[0.5, 0.25, 0.25]]]), eps=0.0)),
        -(0.5 * np.log(0.5) + 2 * 0.25 * np.log(0.25)) / 3, rtol=1e-6)
    a, b = rng.normal(size=(2, 6, 8, 5)).astype(np.float32)
    _close(tl.l1_map(torch.as_tensor(a), torch.as_tensor(b)), jl.l1_map(jnp.asarray(a), jnp.asarray(b)),
           rtol=1e-6)
    _close(tl.tv_loss(torch.as_tensor(a)), jl.tv_loss(jnp.asarray(a)), rtol=1e-5)


@pytest.mark.parametrize("shape", [(10, 12, 3), (9, 7)])
def test_mean_smooth_matches_jax(shape):
    img = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    _close(ti.mean_smooth(torch.as_tensor(img), 5), ji.mean_smooth(jnp.asarray(img), 5), atol=1e-5)


@pytest.mark.parametrize("out_hw", [(13, 5), (7, 9), (3, 20), (1, 1)])
def test_resizes_match_jax(out_hw):
    img = np.random.default_rng(6).normal(size=(7, 9, 2)).astype(np.float32)
    _close(ti.resize_nearest(torch.as_tensor(img), out_hw),
           ji.resize_nearest(jnp.asarray(img), out_hw), atol=1e-6)
    _close(ti.resize_bilinear_align_corners(torch.as_tensor(img), out_hw),
           ji.resize_bilinear_align_corners(jnp.asarray(img), out_hw), atol=1e-5)


def test_mixed_seg_map_matches_jax():
    h, w = 14, 18
    rng = np.random.default_rng(12)
    seg = rng.integers(-1, 9, size=(h, w, 4)).astype(np.int32)
    scale = rng.dirichlet([1, 1, 1], size=(h, w)).astype(np.float32)
    got = ts.mixed_seg_map(torch.as_tensor(seg), torch.as_tensor(scale)).numpy()
    want = np.asarray(js.mixed_seg_map(jnp.asarray(seg), jnp.asarray(scale)))
    np.testing.assert_array_equal(got, want)


def test_segment_median_matches_jax():
    rng = np.random.default_rng(13)
    vals = rng.uniform(size=200).astype(np.float32)
    vals[::7] = vals[1::7][: len(vals[::7])]  # ties
    seg = rng.integers(-1, 9, size=200).astype(np.int32)
    mt, ct = ts.segment_median(torch.as_tensor(vals), torch.as_tensor(seg), 10)
    mj, cj = js.segment_median(jnp.asarray(vals), jnp.asarray(seg), 10)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))


CASES = {
    # name: (seg hw, render hw, kwargs)
    "same_res": ((6, 8), (6, 8), {}),
    "resized_bleed": ((6, 8), (11, 13), {}),
    "max_mode": ((6, 8), (6, 8), {"max_mode": True}),
    "median_mode": ((8, 10), (8, 10), {"median_mode": True}),
    "median_resized": ((8, 10), (5, 7), {"median_mode": True}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_blend_gt_feature_map_matches_jax(case):
    (hs, ws), (hr, wr), kw = CASES[case]
    rng = np.random.default_rng(len(case))
    m, d = 7, 6
    embed = rng.normal(size=(m, d)).astype(np.float16)  # f16 table, like the loader's
    seg = rng.integers(-1, m, size=(hs, ws, 4)).astype(np.int32)
    seg[..., 1][:2, :3] = -1  # a block of -1 ids: the last row bleeds on resize
    scale = rng.dirichlet([1, 1, 1], size=(hr, wr)).astype(np.float32)
    ft, mt = ts.blend_gt_feature_map(torch.as_tensor(embed), torch.as_tensor(seg),
                                     torch.as_tensor(scale), **kw)
    fj, mj = js.blend_gt_feature_map(jnp.asarray(embed), jnp.asarray(seg), jnp.asarray(scale), **kw)
    assert ft.shape == (hr, wr, d) and mt.dtype == torch.bool
    _close(ft, fj, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))


def _fused_inputs(seed, h=6, w=10, d=16, m=5):
    rng = np.random.default_rng(seed)
    decoded = rng.normal(size=(h, w, d)).astype(np.float32)
    embed = rng.normal(size=(m, d)).astype(np.float32)
    seg = rng.integers(-1, m, size=(h, w, 4)).astype(np.int32)
    scale = rng.uniform(0.1, 1.0, size=(h, w, 3)).astype(np.float32)
    cot = rng.normal(size=(h, w)).astype(np.float32)
    return decoded, embed, seg, scale, cot


@pytest.mark.parametrize("flat", [False, True])
def test_fused_supervision_matches_generic_composition(flat):
    """The fused autograd Function against the generic composition of
    blend_gt_feature_map + mask + l1_map, selected by a config built with
    fused_supervision=False (not the default), value and both gradients
    of the decoder's rows before its normalisation; and against the JAX
    package's fused VJP of the normalised rows."""
    decoded, embed, seg, scale, cot = _fused_inputs(7)
    h, w, d = decoded.shape
    batch = dict(img_embed=torch.as_tensor(embed), seg_map=torch.as_tensor(seg))
    cfg_fused = GadConfig(fused_supervision=True)
    cfg_plain = dataclasses.replace(cfg_fused, fused_supervision=False)
    results = {}
    for name, cfg in (("fused", cfg_fused), ("generic", cfg_plain)):
        dec = torch.as_tensor(decoded).requires_grad_(True)
        sc = torch.as_tensor(scale).requires_grad_(True)
        if flat and name == "fused":
            l1 = supervised_l1_pix(cfg, dec.reshape(-1, d), sc.reshape(-1, 3), batch).reshape(h, w)
        else:
            l1 = supervised_l1_pix(cfg, dec, sc, batch)
        (l1 * torch.as_tensor(cot)).sum().backward()
        results[name] = (l1.detach().numpy(), dec.grad.numpy(), sc.grad.numpy())
    for a, b in zip(results["fused"], results["generic"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)

    def jfused(dec_, scale_):
        # the JAX FeatureDecoder's last step
        unit = dec_ * jax.lax.rsqrt(jnp.maximum(jnp.sum(dec_ * dec_, -1, keepdims=True), 1e-24))
        return jnp.sum(js.fused_supervision_l1(unit, jnp.asarray(embed), jnp.asarray(seg)[..., 1:4],
                                               scale_) * cot)

    gj = jax.grad(jfused, argnums=(0, 1))(jnp.asarray(decoded), jnp.asarray(scale))
    np.testing.assert_allclose(results["fused"][1], np.asarray(gj[0]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(results["fused"][2], np.asarray(gj[1]), rtol=1e-5, atol=1e-6)


def test_fused_supervision_saves_only_its_inputs():
    decoded, embed, seg, scale, _ = _fused_inputs(8)
    dec = torch.as_tensor(decoded).requires_grad_(True)
    sc = torch.as_tensor(scale).requires_grad_(True)
    seg_t = torch.as_tensor(seg)[..., 1:4]
    emb_t = torch.as_tensor(embed)
    out = ts.fused_supervision_l1(dec, emb_t, seg_t, sc)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 4
    assert {t.data_ptr() for t in saved} == {dec.data_ptr(), emb_t.data_ptr(),
                                             seg_t.data_ptr(), sc.data_ptr()}


# --- the group branches: row strips of one image over two gloo ranks -------

GH, GW, GC, GS = 16, 12, 5, 16  # image, channels, segment capacity


def _group_inputs():
    rng = np.random.default_rng(21)
    lmap = rng.uniform(size=(GH, GW)).astype(np.float32)
    feat = rng.normal(size=(GH, GW, GC)).astype(np.float32)
    seg = _rand_seg(GH, GW, 9, seed=22)
    return lmap, feat, seg


def region_group_ranks(ctx):
    """This rank's row strip through both region losses with `group`: the
    values and the gradients of the strip's inputs."""
    import torch.distributed as dist

    lmap, feat, seg = _group_inputs()
    rows = slice(ctx.rank * GH // ctx.world_size, (ctx.rank + 1) * GH // ctx.world_size)
    lt = torch.as_tensor(lmap[rows]).requires_grad_(True)
    ft = torch.as_tensor(feat[rows]).requires_grad_(True)
    st = torch.as_tensor(seg[rows])
    l1 = tl.region_balanced_l1(lt, st, GS, group=dist.group.WORLD)
    rv = tl.region_variance_loss(ft, st, GS, group=dist.group.WORLD, num_pixels=GH * GW)
    (l1 + rv).backward()
    return dict(l1=l1.detach(), rv=rv.detach(), g_l=lt.grad, g_f=ft.grad)


@pytest.fixture(scope="module")
def region_group():
    from gags_torch.parallel.launch import spawn

    return [r.result for r in spawn(region_group_ranks, 2, "gloo", "cpu", deadline=120)]


def test_region_losses_group_equal_full_image(region_group):
    """Both region losses over 2 row strips (moments summed by the
    differentiable all_reduce) equal the full-image values on every rank
    (rtol 1e-6) and their strips' gradients equal the full image's (the
    all_reduce's backward is the identity: no rank-count factor)."""
    lmap, feat, seg = _group_inputs()
    lt = torch.as_tensor(lmap).requires_grad_(True)
    ft = torch.as_tensor(feat).requires_grad_(True)
    l1 = tl.region_balanced_l1(lt, torch.as_tensor(seg), GS)
    rv = tl.region_variance_loss(ft, torch.as_tensor(seg), GS)
    (l1 + rv).backward()
    for r in region_group:
        np.testing.assert_allclose(float(r["l1"]), float(l1.detach()), rtol=1e-6)
        np.testing.assert_allclose(float(r["rv"]), float(rv.detach()), rtol=1e-6)
    g_l = torch.cat([r["g_l"] for r in region_group])
    g_f = torch.cat([r["g_f"] for r in region_group])
    torch.testing.assert_close(g_l, lt.grad, rtol=1e-6, atol=1e-9)
    torch.testing.assert_close(g_f, ft.grad, rtol=1e-6, atol=1e-9)
    with pytest.raises(ValueError, match="num_pixels"):
        tl.region_variance_loss(ft, torch.as_tensor(seg), GS, group=object())


def test_region_losses_group_equal_jax_axis_name(region_group):
    """Without pad rows the group values equal JAX's axis_name branch
    inside shard_map over make_mesh(2) (rtol 1e-5, as the one-device
    comparisons above)."""
    from jax.sharding import PartitionSpec as P

    from gags_tpu.parallel import make_mesh

    lmap, feat, seg = _group_inputs()

    def per_device(lm, ft, sg):
        return (jl.region_balanced_l1(lm, sg, GS, axis_name="dp"),
                jl.region_variance_loss(ft, sg, GS, axis_name="dp"))

    fn = jax.jit(jax.shard_map(per_device, mesh=make_mesh(2), in_specs=(P("dp"),) * 3,
                               out_specs=(P(), P()), check_vma=False))
    want_l1, want_rv = fn(jnp.asarray(lmap), jnp.asarray(feat), jnp.asarray(seg))
    np.testing.assert_allclose(float(region_group[0]["l1"]), float(want_l1), rtol=1e-5)
    np.testing.assert_allclose(float(region_group[0]["rv"]), float(want_rv), rtol=1e-5)


def test_l2_and_cosine_loss_match_jax():
    rng = np.random.default_rng(12)
    a, b = rng.normal(size=(2, 6, 8, 5)).astype(np.float32)
    b[0, 0] = 0.0  # a zero vector: the 1e-8 floor of the denominator
    _close(tl.l2(torch.as_tensor(a), torch.as_tensor(b)), jl.l2(jnp.asarray(a), jnp.asarray(b)),
           rtol=1e-6)
    _close(tl.cosine_loss(torch.as_tensor(a), torch.as_tensor(b)),
           jl.cosine_loss(jnp.asarray(a), jnp.asarray(b)), rtol=1e-6)
