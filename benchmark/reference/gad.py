"""Plain reference of one GAD distillation step (GAGS's feature field):
render the F-dim features of a camera over fixed geometry, decode a 3-way
granularity map and the CLIP-space features, form the blended-GT L1, the
region-balanced mean, the entropy regulariser and the region variance,
backpropagate, and take three Adam steps (features, feature decoder,
scale decoder). Plain PyTorch in float32 (TF32 off), no kernel of the
program.

The losses are GAGS's (its train.py and utils/loss_utils.py): the scale
decoder sees the detached feature map and learns through the blended
ground truth and the entropy term; every pixel's ground truth is the sum
over the s/m/l masks it lies in of that mask's CLIP embedding times the
pixel's granularity weight (an id of -1 takes the table's last row, and
marks the pixel invalid for the L1); segments are the s/m/l ids chosen
per pixel by the argmax of the 5x5 box-smoothed granularity map.

That argmax is a discontinuity: where two granularities' smoothed
weights lie within rounding of each other, a program that smooths in
another order (the port sums cumulatively, ~1e-5 off the exact mean)
may rightly pick the other one, and a pixel that changes segment can
move the region-balanced loss by ~1 / segments. So the reference judges
the program's choice instead of repeating it: given the program's
segment ids, it reads how far the program's pick lies below its own
best smoothed weight at each pixel (`seg_gap`, infinite where the id is
none of the pixel's s/m/l ids) and follows the program's pick, so that
the losses and gradients compare the rest of the step.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from benchmark.reference import raster

def init_linear_stack(widths, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """d{i}.weight (out, in) and d{i}.bias, U(+-1/sqrt(fan_in)), drawn from
    `generator` on `device` in one call per stack."""
    total = sum(a * b + b for a, b in widths)
    flat = torch.rand((total,), generator=generator, device=device, dtype=torch.float32)
    out, pos = {}, 0
    for i, (a, b) in enumerate(widths):
        bound = 1.0 / math.sqrt(a)
        for name, n, shape in (("weight", a * b, (b, a)), ("bias", b, (b,))):
            out[f"d{i}.{name}"] = ((flat[pos:pos + n] * 2.0 - 1.0) * bound).reshape(shape)
            pos += n
    return out


def feature_decoder(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """16 -> 256 x 8 (skips after layers 2 and 5) -> 512, L2-normalised."""
    def lin(i, v):
        return F.linear(v, p[f"d{i}.weight"], p[f"d{i}.bias"])

    x1 = F.relu(lin(0, x))
    x2 = F.relu(lin(2, F.relu(lin(1, x1))))
    x3 = F.relu(lin(3, x1 + x2))
    x4 = F.relu(lin(5, F.relu(lin(4, x3))))
    x5 = F.relu(lin(7, F.relu(lin(6, x3 + x4))))
    x5 = lin(8, x5)
    sq = torch.sum(x5 * x5, dim=-1, keepdim=True)
    return x5 * torch.rsqrt(torch.clamp_min(sq, 1e-24))


def scale_decoder(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    for i in range(5):
        x = F.relu(F.linear(x, p[f"d{i}.weight"], p[f"d{i}.bias"]))
    return torch.softmax(F.linear(x, p["d5.weight"], p["d5.bias"]), dim=-1)


def box_smooth(img: torch.Tensor, k: int = 5) -> torch.Tensor:
    """k x k mean with zero padding (divisor k^2), channel-wise, (H, W, C)."""
    c = img.shape[-1]
    x = img.permute(2, 0, 1)[None]
    w = torch.ones((c, 1, k, k), dtype=img.dtype, device=img.device) / (k * k)
    return F.conv2d(x, w, padding=k // 2, groups=c)[0].permute(1, 2, 0)


def segment_sums(values: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    return values.new_zeros((n, values.shape[1])).index_add(0, ids, values)


def mixed_segments(seg_sml, scale_px, hw, seg_prog=None):
    """(P,) segment id a pixel and the widest gap by which the program's
    pick (`seg_prog`, its (P,) ids) lies below the best 5x5-smoothed
    granularity weight; the reference's own argmax without `seg_prog`."""
    h, w = hw
    sm = box_smooth(scale_px.detach().reshape(h, w, 3)).reshape(-1, 3)
    best = sm.max(dim=-1)
    if seg_prog is None:
        return torch.gather(seg_sml, 1, best.indices[:, None])[:, 0], 0.0
    match = seg_sml == seg_prog.reshape(-1, 1).to(seg_sml.dtype)
    picked = torch.where(match, sm, -math.inf).max(dim=-1)
    sel = torch.where(match.any(dim=-1), picked.indices, best.indices)
    gap = float((best.values - picked.values).max())
    return torch.gather(seg_sml, 1, sel[:, None])[:, 0], gap


def losses(feat_px, scale_px, decoded, img_embed, seg_map, hw, max_segments: int,
           seg_prog=None):
    """(l1_feature, entropy, region_variance, seg_gap) of one camera."""
    h, w = hw
    seg_sml = seg_map[..., 1:4].reshape(-1, 3).long()
    m = img_embed.shape[0]
    table = img_embed.to(torch.float32)
    gt = sum(table[torch.remainder(seg_sml[:, g], m)] * scale_px[:, g:g + 1] for g in range(3))
    maskf = torch.all(seg_sml != -1, dim=-1).to(torch.float32)[:, None]
    l1_pix = torch.mean(torch.abs(decoded * maskf - gt * maskf), dim=-1)
    seg, seg_gap = mixed_segments(seg_sml, scale_px, hw, seg_prog)
    ids = seg + 1  # 0: no mask
    ones = torch.ones_like(l1_pix)
    sums = segment_sums(torch.stack([ones, l1_pix], 1), ids, max_segments + 1)
    cnt, tot = sums[1:, 0], sums[1:, 1]
    present = cnt > 0
    l1_feature = torch.sum(torch.where(present, tot / torch.clamp_min(cnt, 1.0), 0.0)) / \
        torch.clamp_min(present.sum(), 1)
    ent = torch.mean(-scale_px * torch.log(scale_px + 1e-6))
    c = feat_px.shape[1]
    mom = segment_sums(torch.cat([torch.ones_like(feat_px[:, :1]), feat_px, feat_px * feat_px], 1),
                       ids, max_segments + 1)
    n, s1, s2 = mom[:, :1], mom[:, 1:1 + c], mom[:, 1 + c:]
    var = torch.clamp_min((s2 - s1 * s1 / torch.clamp_min(n, 1.0)) / torch.clamp_min(n - 1.0, 1.0), 0.0)
    valid = mom[:, 0] >= 2
    valid[0] = False
    regvar = torch.sum(torch.where(valid, mom[:, 0] * torch.mean(var, dim=-1), 0.0)) / feat_px.shape[0]
    return l1_feature, ent, regvar, seg_gap


class Adam:
    """torch.optim.Adam's update (no weight decay, no amsgrad), plain."""

    def __init__(self, params: List[torch.Tensor], lr: float, eps: float,
                 betas=(0.9, 0.999)):
        self.params, self.lr, self.eps, self.b1, self.b2 = params, lr, eps, *betas
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        bc1 = 1.0 - self.b1 ** self.t
        bc2 = 1.0 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = v.sqrt() / math.sqrt(bc2) + self.eps
            p.addcdiv_(m, denom, value=-self.lr / bc1)


def run_steps(cameras, weights: Dict, geometry: Dict, batches, width: int, height: int,
              cfg: Dict, rows_per_block: int = 1 << 16) -> Dict:
    """Follow len(batches) GAD steps from `weights` (features (N, F), the
    two decoders' d{i}.weight/bias) over fixed `geometry` (means, quats,
    scales, opacities, activated). `cameras` [(viewmat, K)], `batches`
    [{img_embed, seg_map, seg_prog (optional: the program's segment ids)}],
    one per step, each at render resolution. Returns each step's loss, the
    first step's gradient norms by leaf, the norms of each leaf's change
    after the last step and the widest `seg_gap` of the steps."""
    feats = weights["features"].clone().requires_grad_(True)
    dec = {k: v.clone().requires_grad_(True) for k, v in weights["decoder"].items()}
    scl = {k: v.clone().requires_grad_(True) for k, v in weights["scale_decoder"].items()}
    opt = [Adam([feats], cfg["feature_lr"], cfg["adam_eps_features"]),
           Adam(list(dec.values()), cfg["decoder_lr"], 1e-8),
           Adam(list(scl.values()), cfg["decoder_lr"], 1e-8)]
    leaves = {"features": feats, **{f"decoder.{k}": v for k, v in dec.items()},
              **{f"scale_decoder.{k}": v for k, v in scl.items()}}
    out = {"loss": [], "grad_norm": None, "seg_gap": 0.0}
    for step, ((viewmat, K), batch) in enumerate(zip(cameras, batches)):
        proj = raster.project(geometry["means"], geometry["quats"], geometry["scales"],
                              geometry["opacities"], viewmat, K, width, height)
        lists = raster.tile_lists(proj, width, height)
        walk = raster.walk(proj, geometry["opacities"], lists, width, height)
        del proj, lists
        fmap = raster.render_colors(walk, feats, width, height).reshape(-1, feats.shape[1])
        del walk
        scale_px = scale_decoder(scl, fmap.detach())
        decoded = torch.cat([feature_decoder(dec, fmap[i:i + rows_per_block])
                             for i in range(0, fmap.shape[0], rows_per_block)])
        l1, ent, regvar, seg_gap = losses(fmap, scale_px, decoded, batch["img_embed"],
                                          batch["seg_map"], (height, width), cfg["max_segments"],
                                          batch.get("seg_prog"))
        out["seg_gap"] = max(out["seg_gap"], seg_gap)
        ew, rw = cfg["entropy_w"], cfg["regionvar_w"]
        total = l1 + ew * ent + rw * regvar
        names = list(leaves)
        grads = torch.autograd.grad(total, [leaves[k] for k in names], allow_unused=True)
        grads = [torch.zeros_like(leaves[k]) if g is None else g for k, g in zip(names, grads)]
        if step == 0:
            out["grad_norm"] = {k: float(torch.linalg.vector_norm(g.double()))
                                for k, g in zip(names, grads)}
        out["loss"].append(float(total.detach()))
        del fmap, scale_px, decoded, l1, ent, regvar, total
        gi = iter(grads)
        opt[0].step([next(gi)])
        opt[1].step([next(gi) for _ in dec])
        opt[2].step([next(gi) for _ in scl])
        del grads
    init = {"features": weights["features"],
            **{f"decoder.{k}": v for k, v in weights["decoder"].items()},
            **{f"scale_decoder.{k}": v for k, v in weights["scale_decoder"].items()}}
    out["change_norm"] = {k: float(torch.linalg.vector_norm((leaves[k].detach() - init[k]).double()))
                          for k in leaves}
    return out
