"""The plain side of J6 (`gad/kernels.py`, the GAD step's per-pixel tail)
on the CPU: `normalised_supervision_l1`'s plain version against the fused
supervision L1 of the decoder's normalised rows, the decoder's forward as
the normalisation of `unnormalised`, `supervised_l1_pix` on raw rows on
both branches, J6's closed-form backward against float64 autograd, and
the wrappers' refusals. The kernel itself is held to these on the card by
tests/test_torch_gad_kernels_cuda.py."""

import numpy as np
import pytest
import torch

from gags_torch.gad import kernels as gk
from gags_torch.gad import losses
from gags_torch.gad import supervision as sup
from gags_torch.gad.train import GadConfig, supervised_l1_pix
from gags_torch.models.decoders import FeatureDecoder, l2_normalise

F64 = torch.float64


def _case(seed, h=6, w=10, d=16, m=5, dtype=torch.float32):
    """Rows, a table, s/m/l ids in [-1, m + 2) (so some wrap past M), a
    few pixels with every id valid and a few with -1, scale maps and a
    cotangent."""
    rng = np.random.default_rng(seed)
    raw = torch.as_tensor(rng.normal(size=(h * w, d)), dtype=dtype)
    table = torch.as_tensor(rng.normal(size=(m, d)), dtype=dtype)
    seg = torch.as_tensor(rng.integers(-1, m + 2, size=(h, w, 4)).astype(np.int32))
    seg[0, :3, 1:] = 2  # masked in
    seg[1, :2, 2] = -1  # masked out
    scale = torch.as_tensor(rng.uniform(0.1, 1.0, size=(h * w, 3)), dtype=dtype)
    cot = torch.as_tensor(rng.normal(size=(h * w,)), dtype=dtype)
    return raw, table, seg, scale, cot


def test_plain_version_is_fused_l1_of_the_decoders_rows():
    """On CPU tensors normalised_supervision_l1 of a decoder's unnormalised
    rows equals fused_supervision_l1 of its forward, in value and in the
    gradients of the features and the scale map, bit for bit (the same
    operations in the same order)."""
    dec = FeatureDecoder(in_dim=4, hidden=8, output_dim=16,
                         generator=torch.Generator().manual_seed(3))
    _, table, seg, scale, cot = _case(4)
    px = torch.as_tensor(np.random.default_rng(5).normal(size=(60, 4)), dtype=torch.float32)
    seg_sml = seg[..., 1:4].reshape(-1, 3)
    out = {}
    for name in ("plain", "fused"):
        f = px.clone().requires_grad_(True)
        s = scale.clone().requires_grad_(True)
        if name == "plain":
            l1 = sup.normalised_supervision_l1(dec.unnormalised(f), table, seg_sml, s)
        else:
            l1 = sup.fused_supervision_l1(dec(f), table, seg_sml, s)
        (l1 * cot).sum().backward()
        out[name] = (l1.detach(), f.grad, s.grad)
    for a, b in zip(out["plain"], out["fused"]):
        assert torch.equal(a, b)
    assert (out["plain"][0] == 0).any() and (out["plain"][0] > 0).any()


@pytest.mark.parametrize("shape", [(7, 16), (3, 5, 16)])
def test_feature_decoder_forward_is_the_normalised_unnormalised(shape):
    dec = FeatureDecoder(in_dim=16, generator=torch.Generator().manual_seed(6))
    x = torch.randn(shape, generator=torch.Generator().manual_seed(7))
    raw = dec.unnormalised(x)
    assert raw.shape == shape[:-1] + (512,) and raw.dtype == torch.float32
    assert torch.equal(dec(x), l2_normalise(raw))


@pytest.mark.parametrize("fused,seg_hw", [(False, (6, 10)), (True, (3, 5))])
def test_supervised_l1_pix_generic_branch_on_raw_rows(fused, seg_hw):
    """Without the fused supervision, or with seg and render resolutions
    that differ, raw rows are normalised and composed as before: the
    value and gradients of the generic composition on the normalised
    rows, bit for bit."""
    raw, table, _, _, _ = _case(8)
    rng = np.random.default_rng(9)
    seg = torch.as_tensor(rng.integers(-1, 5, size=seg_hw + (4,)).astype(np.int32))
    sc = torch.as_tensor(rng.dirichlet([1, 1, 1], size=(6, 10)).astype(np.float32))
    cot = torch.as_tensor(rng.normal(size=(6, 10)).astype(np.float32))
    cfg = GadConfig(fused_supervision=fused)
    batch = dict(img_embed=table, seg_map=seg)
    out = {}
    for name in ("raw", "composed"):
        r = raw.reshape(6, 10, 16).clone().requires_grad_(True)
        s = sc.clone().requires_grad_(True)
        if name == "raw":
            l1 = supervised_l1_pix(cfg, r, s, batch)
        else:
            gt_map, mask = sup.blend_gt_feature_map(table, seg, s)
            maskf = mask.to(torch.float32)
            l1 = losses.l1_map(l2_normalise(r) * maskf, gt_map * maskf)
        (l1 * cot).sum().backward()
        out[name] = (l1.detach(), r.grad, s.grad)
    for a, b in zip(out["raw"], out["composed"]):
        assert torch.equal(a, b)


def test_supervised_l1_pix_flat_branch_on_raw_rows():
    """The flat branch takes normalised_supervision_l1: on CPU tensors the
    fused supervision L1 of the normalised rows, value and gradients bit
    for bit."""
    raw, table, seg, scale, cot = _case(10)
    cfg = GadConfig()
    batch = dict(img_embed=table, seg_map=seg)
    out = {}
    for name in ("flat", "fused"):
        r = raw.clone().requires_grad_(True)
        s = scale.clone().requires_grad_(True)
        if name == "flat":
            l1 = supervised_l1_pix(cfg, r, s, batch)
        else:
            l1 = sup.fused_supervision_l1(l2_normalise(r), table, seg[..., 1:4].reshape(-1, 3), s)
        (l1 * cot).sum().backward()
        out[name] = (l1.detach(), r.grad, s.grad)
    for a, b in zip(out["flat"], out["fused"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("table_dtype", [torch.float32, torch.float16])
def test_closed_form_backward_matches_float64_autograd(table_dtype):
    """J6's closed-form backward (the kernel's arithmetic) against autograd
    through the plain version in float64, within 1e-12 relative, with
    exact zeros where the mask is off and a zero row (the clamp's side)."""
    raw, table, seg, scale, cot = _case(11, dtype=F64)
    raw[5] = 0.0  # sum of squares below 1e-24: the clamp holds
    table = table.to(table_dtype)
    seg_sml = seg[..., 1:4].reshape(-1, 3)
    r = raw.clone().requires_grad_(True)
    s = scale.clone().requires_grad_(True)
    l1 = sup.fused_supervision_l1(l2_normalise(r), table.to(F64), seg_sml, s)
    want_x, want_s = torch.autograd.grad(l1, (r, s), cot)
    got_x, got_s = gk.supervision_backward_plain(raw, table, seg_sml, scale, cot)
    for got, want in ((got_x, want_x), (got_s, want_s)):
        assert float((got - want).norm() / want.norm()) < 1e-12
    off = ~torch.all(seg_sml != -1, dim=-1)
    assert off.any() and not off.all()
    assert (got_x[off] == 0).all() and (got_s[off] == 0).all()


def test_wrappers_raise_on_cpu_tensors_and_count_launches():
    """J6's wrappers take CUDA tensors only: CPU tensors raise before any
    build; launch_counts holds one counter each way and resets."""
    raw, table, seg, scale, cot = _case(12, d=128)
    seg_sml = seg[..., 1:4].reshape(-1, 3)
    with pytest.raises(ValueError, match="CUDA float32"):
        gk.supervision_forward(raw, table, seg_sml, scale)
    with pytest.raises(ValueError, match="CUDA float32"):
        gk.supervision_backward(raw, table, seg_sml, scale, cot)
    assert set(gk.launch_counts) == {"supervision_forward", "supervision_backward"}
    gk.launch_counts["supervision_forward"] = 3
    gk.reset_launch_counts()
    assert set(gk.launch_counts.values()) == {0}
    assert 512 in gk.WIDTHS and gk.SUPERVISION_SRC.is_file()
