"""Kernel J6 (`gad/csrc/supervision.cu`, the GAD step's per-pixel tail:
the normalisation, the scale-blended GT gather, the mask and the L1)
against a float64 eager composition on the card.

Marked `cuda`: each test skips, with its reason, where no CUDA device is
present. On a machine with a card:
python -m pytest tests/test_torch_gad_kernels_cuda.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from gags_torch.gad import kernels as gk
from gags_torch.gad import supervision as sup
from gags_torch.models.decoders import l2_normalise

pytestmark = pytest.mark.cuda
F64 = torch.float64
# the gad-train cell: 640 x 360 pixels, CLIP 512, 300 masks, s/m/l regions
# of 12 / 24 / 48 pixels at the training resolution
H, W, D, M = 360, 640, 512, 300
# a float32 difference y - gt within this of 0 may take either sign (its
# rounding is ~1e-8 here): such rows are left out of the gradients' gaps
TIE = 1e-6


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (J6 has no CPU mode)")
    return torch.device("cuda")


def _case(dev, h, w, d=D, m=M, seed=0, table_dtype=torch.float16, blocks=(12, 24, 48)):
    """Rows like the decoder's last layer, a unit-norm table (float16 as
    the loader gives it), s/m/l ids in blocks of neighbouring pixels, ids
    of -1 (masked out) and of M or more (wrapped), softmax scale weights,
    a cotangent."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(h * w, d)) * 0.05
    table = rng.normal(size=(m, d))
    table /= np.linalg.norm(table, axis=1, keepdims=True)
    seg = np.zeros((h, w, 4), np.int32)
    for level, block in zip((1, 2, 3), blocks):
        coarse = rng.integers(-1, m + 4, size=(-(-h // block), -(-w // block)))
        seg[..., level] = np.repeat(np.repeat(coarse, block, 0), block, 1)[:h, :w]
    seg[0, :2, 1] = seg[-1, -1, 3] = -1  # masked out whatever the draw
    e = np.exp(rng.normal(size=(h * w, 3)))
    scale = e / e.sum(-1, keepdims=True)
    g = rng.uniform(0.5, 1.5, size=(h * w,))
    f32 = dict(dtype=torch.float32, device=dev)
    seg_t = torch.as_tensor(seg, device=dev)
    return (torch.as_tensor(x, **f32), torch.as_tensor(table, device=dev).to(table_dtype),
            seg_t[..., 1:4].reshape(-1, 3), torch.as_tensor(scale, **f32),
            torch.as_tensor(g, **f32))


def _ref64(x, table, ids, scale, g):
    """The eager composition in float64: l1, d_x, d_scale, and each row's
    least |y - gt|."""
    r = x.double().requires_grad_(True)
    s = scale.double().requires_grad_(True)
    l1 = sup.fused_supervision_l1(l2_normalise(r), table.double(), ids, s)
    d_x, d_s = torch.autograd.grad(l1, (r, s), g.double())
    with torch.no_grad():
        diff = l2_normalise(x.double()) - sup._gather_terms(table.double(), ids, scale.double())
        margin = diff.abs().amin(-1)
    return l1.detach(), d_x, d_s, margin


def _rel(a, b):
    b = b.double()
    return float(torch.linalg.vector_norm(a.double() - b) / torch.linalg.vector_norm(b))


SHAPES = [(H, W), (13, 77)]  # the cell; a ragged P (1001, not a multiple of 32)


@pytest.mark.parametrize("h,w", SHAPES)
def test_forward_within_float64(dev, h, w):
    """l1_pix within 1e-6 relative of float64 on every pixel the mask
    keeps, exact zeros where it does not."""
    x, table, ids, scale, g = _case(dev, h, w, seed=h)
    got = gk.supervision_forward(x, table, ids, scale)
    want, _, _, _ = _ref64(x, table, ids, scale, g)
    on = torch.all(ids != -1, dim=-1)
    assert 0 < int((~on).sum()) < on.numel()
    assert (got[~on] == 0).all()
    rel = ((got[on].double() - want[on]).abs() / want[on]).max()
    assert float(rel) < 1e-6, float(rel)


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("table_dtype", [torch.float16, torch.float32])
def test_backward_within_float64(dev, h, w, table_dtype):
    """d_x5 and d_scale within 1e-5 relative L2 of float64 over the rows
    whose every difference y - gt is further than 1e-6 from 0 (nearer, the
    float32 sign is a coin toss; those rows are under 2% here), exact
    zeros on masked rows."""
    x, table, ids, scale, g = _case(dev, h, w, seed=h + 1, table_dtype=table_dtype)
    d_x, d_s = gk.supervision_backward(x, table, ids, scale, g)
    _, want_x, want_s, margin = _ref64(x, table, ids, scale, g)
    on = torch.all(ids != -1, dim=-1)
    assert (d_x[~on] == 0).all() and (d_s[~on] == 0).all()
    keep = on & (margin > TIE)
    assert float(keep.sum()) > 0.98 * float(on.sum())
    gaps = dict(d_x=_rel(d_x[keep], want_x[keep]), d_scale=_rel(d_s[keep], want_s[keep]))
    assert max(gaps.values()) < 1e-5, gaps


def test_ids_wrap_as_remainder(dev):
    """Ids of -1 read the table's last row for the valid levels' blend
    (the mask is off, so the outputs are zeros), and ids of M or more wrap:
    a pixel with ids (M, 2M + 1, 5) gives what (0, 1, 5) gives."""
    x, table, ids, scale, g = _case(dev, 4, 32, seed=3)
    ids = ids.clone()
    ids[0] = torch.tensor([0, 1, 5])
    ids[1] = torch.tensor([M, 2 * M + 1, 5])
    ids[2] = torch.tensor([-1, 1, 5])
    ids[3] = torch.tensor([M - 1, -M - 1, 5])  # remainder(-M - 1, M) = M - 1
    ids[4] = torch.tensor([M - 1, M - 1, 5])
    x[1], x[3], scale[1], scale[3] = x[0], x[4], scale[0], scale[4]
    g[1], g[3] = g[0], g[4]
    l1 = gk.supervision_forward(x, table, ids, scale)
    d_x, d_s = gk.supervision_backward(x, table, ids, scale, g)
    assert l1[0] == l1[1] and l1[3] == l1[4] and l1[2] == 0
    assert torch.equal(d_x[0], d_x[1]) and torch.equal(d_s[0], d_s[1])
    assert torch.equal(d_x[3], d_x[4]) and torch.equal(d_s[3], d_s[4])
    assert (d_x[2] == 0).all() and (d_s[2] == 0).all()


def test_second_launch_bit_identical(dev):
    x, table, ids, scale, g = _case(dev, H, W, seed=5)
    a = gk.supervision_forward(x, table, ids, scale)
    b = gk.supervision_forward(x, table, ids, scale)
    assert torch.equal(a, b)
    (ax, as_), (bx, bs) = (gk.supervision_backward(x, table, ids, scale, g) for _ in range(2))
    assert torch.equal(ax, bx) and torch.equal(as_, bs)


@pytest.mark.parametrize("d", [128, 256, 768, 1024])
def test_other_widths_within_float64(dev, d):
    x, table, ids, scale, g = _case(dev, 9, 40, d=d, m=17, seed=d, table_dtype=torch.float32)
    l1 = gk.supervision_forward(x, table, ids, scale)
    d_x, d_s = gk.supervision_backward(x, table, ids, scale, g)
    want, want_x, want_s, margin = _ref64(x, table, ids, scale, g)
    keep = torch.all(ids != -1, dim=-1) & (margin > TIE)
    assert _rel(l1, want) < 1e-6
    assert _rel(d_x[keep], want_x[keep]) < 1e-5 and _rel(d_s[keep], want_s[keep]) < 1e-5


def test_strided_ids_and_a_broadcast_scale(dev):
    """The ids as a (P, 3) view of the seg map's (H, W, 4) (row stride 4)
    and a scale map broadcast from one row (row stride 0, as single_scale
    gives it) read as their contiguous copies do."""
    x, table, _, scale, g = _case(dev, 8, 40, seed=7)
    seg = torch.randint(-1, M, (8, 40, 4), dtype=torch.int32, device=dev)
    ids = seg[..., 1:4].reshape(-1, 3)
    assert ids.stride() == (4, 1)
    one = torch.tensor([0.2, 0.5, 0.3], device=dev).expand(ids.shape)
    for s in (scale, one):
        assert torch.equal(gk.supervision_forward(x, table, ids, s),
                           gk.supervision_forward(x, table, ids.contiguous(), s.contiguous()))
        a, b = (gk.supervision_backward(x, table, i, s, g) for i in (ids, ids.contiguous()))
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("which", ["float64 rows", "non-contiguous rows", "CPU table",
                                   "CPU ids", "int64 ids", "width 96", "float64 scale"])
def test_wrapper_raises_on_what_j6_does_not_take(dev, which):
    x, table, ids, scale, g = _case(dev, 4, 32, seed=9)
    args = dict(raw=x, img_embed=table, seg_sml=ids, scale_map=scale)
    if which == "float64 rows":
        args["raw"] = x.double()
    elif which == "non-contiguous rows":
        args["raw"] = torch.cat([x, x], dim=1)[:, ::2]
    elif which == "CPU table":
        args["img_embed"] = table.cpu()
    elif which == "CPU ids":
        args["seg_sml"] = ids.cpu()
    elif which == "int64 ids":
        args["seg_sml"] = ids.long()
    elif which == "width 96":
        args["raw"], args["img_embed"] = x[:, :96].contiguous(), table[:, :96].contiguous()
    else:
        args["scale_map"] = scale.double()
    with pytest.raises(ValueError):
        gk.supervision_forward(**args)
    with pytest.raises(ValueError):
        gk.supervision_backward(**args, g=g)


def test_autograd_launches_once_each_way(dev):
    """normalised_supervision_l1 on CUDA tensors: one forward and one
    backward launch, no eager chain; its gradients are J6's backward's;
    no gradient for the table or the ids, none for a scale map that
    asks for none."""
    x, table, ids, scale, g = _case(dev, 16, 64, seed=11)
    for scale_grad in (True, False):
        r = x.clone().requires_grad_(True)
        s = scale.clone().requires_grad_(scale_grad)
        gk.reset_launch_counts()
        l1 = sup.normalised_supervision_l1(r, table, ids, s)
        l1.backward(g)
        assert gk.launch_counts == {"supervision_forward": 1, "supervision_backward": 1}
        want_x, want_s = gk.supervision_backward(x, table, ids, scale, g)
        assert torch.equal(r.grad, want_x)
        assert torch.equal(s.grad, want_s) if scale_grad else s.grad is None
        assert torch.equal(l1.detach(), gk.supervision_forward(x, table, ids, scale))
