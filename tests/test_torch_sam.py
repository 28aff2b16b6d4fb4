"""SAM and the mask generator, the port against gags_tpu on ONE random
segment-anything-layout state dict loaded into both packages
(`SAMConfig.tiny()` widths).

Tolerances: image embeddings 2e-5 (values of ~1-4), prompt embeddings
1e-5, low-res mask logits 2e-4 and IoU predictions 2e-5 (logits of up
to ~20, after the encoder's differences pass the decoder), the blocked
global attention 1e-5, preprocess_sam_image within one grey level of
PIL's resize (no pixel differs).

The generator's keep/drop decisions sit on thresholds (mask logit 0,
stability offsets +-1, predicted IoU, stability score, box IoU 0.7), so
its records are compared in two ways: from the SAME low-res logits (both
decoders return JAX's), where the records must be identical and the test
asserts that the two upscales differ by at most UPSCALE_TOL, that no
upscaled logit lies closer to 0 or +-1 than they differ, and that no
score lies within SCORE_TOL of its threshold; and end to end, where every
pixel must agree except those whose logit lies within LOGIT_TOL of the
mask threshold in some prompt (the test counts them).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gags_tpu.gas import generator as jg
from gags_tpu.models import sam as js
from gags_tpu.models.sam_weights import load_sam_state_dict as jload
from gags_torch.cli.gas import round_weights_bf16
from gags_torch.gas import generator as tg
from gags_torch.models import sam as ts
from gags_torch.models.sam_weights import load_sam_state_dict as tload

CFG, JCFG = ts.SAMConfig.tiny(), js.SAMConfig.tiny()
EMBED_TOL, PROMPT_TOL, LOGIT_TOL, IOU_TOL, ATTN_TOL = 2e-5, 1e-5, 2e-4, 2e-5, 1e-5
UPSCALE_TOL, SCORE_TOL = 1e-5, 1e-5


def random_sam_state(cfg, seed=0):
    """Random weights in segment-anything's state-dict layout, from the
    port's module shapes (meta device); the mask head is scaled so the
    logits span ~+-20 and the thresholds at 0 and +-1 do real work."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in ts.SAM(cfg, device="meta").state_dict().items():
        norm = any(s in k for s in ("norm", "neck.1", "neck.3", "upscaling.1", "downscaling.1",
                                    "downscaling.4"))
        if norm and k.endswith("weight"):
            sd[k] = rng.normal(1, 0.1, v.shape).astype(np.float32)
            continue
        if any(s in k for s in ("embed", "token", "gaussian")):
            std = 1.0
        elif any(s in k for s in ("hypernetworks", "upscaling", "iou_prediction")):
            std = 0.5
        else:
            std = 0.2
        sd[k] = rng.normal(0, std, v.shape).astype(np.float32)
    return sd


def _lowered(**kw):
    return dict(points_per_batch=4, pred_iou_thresh=-100.0, stability_score_thresh=-1.0,
                min_mask_region_area=4, **kw)


@pytest.fixture(scope="module")
def pair():
    """Both models from one state dict; JAX's generator (lowered
    thresholds) also lends its jitted encode, decode and upscale."""
    sd = random_sam_state(CFG)
    jm, params = js.SAM(JCFG), jload(sd, JCFG)
    return dict(sd=sd, port=tload(sd, CFG, device="cpu"), jax=jm, params=params,
                jgen=jg.AutomaticMaskGenerator(jm, params, JCFG, jg.GeneratorConfig(**_lowered())))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("image_size", [64, 80])  # grid 8; grid 10 pads its 4x4 windows
def test_image_encoder_matches(image_size):
    cfg = ts.SAMConfig(**{**ts.SAMConfig.tiny().__dict__, "image_size": image_size})
    jcfg = js.SAMConfig(**{**js.SAMConfig.tiny().__dict__, "image_size": image_size})
    sd = random_sam_state(cfg, seed=1)
    imgs = np.random.default_rng(2).normal(size=(2, image_size, image_size, 3)).astype(np.float32)
    enc = jax.jit(lambda p, x: js.SAM(jcfg).apply(p, x, method="encode_image"))
    want = np.asarray(enc(jload(sd, jcfg), jnp.asarray(imgs)))
    with torch.no_grad():
        got = tload(sd, cfg, device="cpu").encode_image(_nchw(imgs)).permute(0, 2, 3, 1).numpy()
    assert got.shape == (2, cfg.grid, cfg.grid, cfg.prompt_dim)
    np.testing.assert_allclose(got, want, rtol=0, atol=EMBED_TOL)


def test_prompt_encoder_matches(pair):
    rng = np.random.default_rng(3)
    pts = rng.uniform(0, 1, (5, 2, 2)).astype(np.float32)
    lbl = np.array([[1, 0], [1, -1], [0, 0], [1, 1], [-1, 1]], np.int32)
    jm, p = pair["jax"], pair["params"]
    want = jm.apply(p, jnp.asarray(pts), jnp.asarray(lbl),
                    method=lambda m, a, b: m.prompt_encoder(a, b))
    dense = jm.apply(p, method=lambda m: m.prompt_encoder.dense_pe(CFG.grid))
    pe = pair["port"].prompt_encoder
    with torch.no_grad():
        got = pe(torch.from_numpy(pts), torch.from_numpy(lbl).long()).numpy()
        got_dense = pe.pe_layer.dense(CFG.grid).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=PROMPT_TOL)
    np.testing.assert_allclose(got_dense, np.asarray(dense), rtol=0, atol=PROMPT_TOL)


def test_mask_decoder_matches(pair):
    rng = np.random.default_rng(4)
    emb = rng.normal(size=(1, CFG.grid, CFG.grid, CFG.prompt_dim)).astype(np.float32)
    pts = rng.uniform(0, 1, (6, 1, 2)).astype(np.float32)
    lbl = np.ones((6, 1), np.int32)
    masks, iou = pair["jgen"]._decode(jnp.asarray(emb), jnp.asarray(pts), jnp.asarray(lbl))
    with torch.no_grad():
        tm, ti = pair["port"].decode(_nchw(emb), torch.from_numpy(pts),
                                     torch.ones((6, 1), dtype=torch.long))
    assert tm.shape == (6, 4, 4 * CFG.grid, 4 * CFG.grid) and ti.shape == (6, 4)
    assert np.abs(np.asarray(masks)).max() > 5  # the thresholds at 0 and +-1 matter
    np.testing.assert_allclose(tm.numpy(), np.asarray(masks), rtol=0, atol=LOGIT_TOL)
    np.testing.assert_allclose(ti.numpy(), np.asarray(iou), rtol=0, atol=IOU_TOL)


@pytest.mark.parametrize("hw", [(48, 48), (64, 32)])
def test_global_attention_blocked_path_matches(hw):
    """A global block over >= 2048 tokens takes JAX's blocked (flash-style)
    path and the port's banded SDPA path; both equal the plain attention."""
    h, w = hw
    dim, heads = 8, 2
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, h, w, dim)).astype(np.float32)
    att = ts.Attention(dim, heads, (h, w))
    with torch.no_grad():
        for prm in att.parameters():
            prm.copy_(torch.from_numpy(rng.normal(0, 0.3, tuple(prm.shape)).astype(np.float32)))
    params = {"params": {
        "qkv": {"kernel": att.qkv.weight.detach().numpy().T, "bias": att.qkv.bias.detach().numpy()},
        "proj": {"kernel": att.proj.weight.detach().numpy().T, "bias": att.proj.bias.detach().numpy()},
        "rel_pos_h": att.rel_pos_h.detach().numpy(), "rel_pos_w": att.rel_pos_w.detach().numpy()}}
    assert h * w >= ts.BLOCKED_MIN_TOKENS and h % ts.ROW_BLOCK == 0
    want = np.asarray(jax.jit(js.WindowAttention(dim, heads).apply)(params, jnp.asarray(x)))
    plain = jax.jit(js.WindowAttention(dim, heads, blocked_min_tokens=1 << 30).apply)(
        params, jnp.asarray(x))
    with torch.no_grad():
        got = att(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATTN_TOL)
    np.testing.assert_allclose(got, np.asarray(plain), rtol=0, atol=ATTN_TOL)


@pytest.mark.parametrize("hw,size", [((50, 100), 64), ((720, 1280), 1024), ((48, 64), 64),
                                     ((300, 200), 1024)])
def test_preprocess_sam_image_matches(hw, size):
    img = np.random.default_rng(6).integers(0, 256, (*hw, 3), np.uint8)
    want, geo = js.preprocess_sam_image(img, size)
    got, tgeo = ts.preprocess_sam_image(img, size, device="cpu")
    assert geo == tgeo and got.shape == (1, 3, size, size)
    levels = np.abs(got[0].permute(1, 2, 0).numpy() - want[0]) * js.SAM_IMAGE_STD
    assert levels.max() <= 1 + 1e-3  # one grey level at most
    assert (levels > 1e-3).mean() == 0.0  # and in fact none


def _records_equal(a, b, allowed=None):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        diff = x["segmentation"] != y["segmentation"]
        if allowed is not None:
            diff &= ~allowed
        assert not diff.any()
        assert abs(x["predicted_iou"] - y["predicted_iou"]) <= IOU_TOL
        if allowed is None:
            assert x["bbox"] == y["bbox"] and x["area"] == y["area"]
            assert x["stability_score"] == y["stability_score"]


def test_generate_same_logits_same_records(pair, monkeypatch):
    """Both generators decode to JAX's low-res logits; with thresholds that
    split the records, the kept records are identical."""
    rng = np.random.default_rng(7)
    image = rng.integers(0, 255, (40, 56, 3), np.uint8)
    grid = rng.uniform(0.05, 0.95, (10, 2))
    jm, params = pair["jax"], pair["params"]
    batch, (nh, nw) = js.preprocess_sam_image(image, CFG.image_size)
    emb = pair["jgen"]._encode(jnp.asarray(batch))
    coords = (grid * np.array([[nw, nh]]) / CFG.image_size).astype(np.float32)
    lr, iou = pair["jgen"]._decode(emb, jnp.asarray(coords[:, None]), jnp.ones((10, 1), jnp.int32))
    lr, iou = np.array(lr), np.array(iou)
    up = tg.upscale_masks(torch.from_numpy(lr), CFG.image_size, nh, nw, 40, 56).numpy()
    up_j = np.asarray(pair["jgen"]._upscale(jnp.asarray(lr), nh, nw, 40, 56))
    d_up = np.abs(up - up_j).max()
    assert d_up <= UPSCALE_TOL
    stab = tg.stability_score(torch.from_numpy(up), 0.0, 1.0).numpy()
    # thresholds inside the spread of the multimask channels' scores
    pred_thr = float(np.median(iou[:, 1:])) + 0.0123
    stab_thr = float(np.median(stab[:, 1:])) - 0.0071
    gcfg = dict(points_per_batch=4, pred_iou_thresh=pred_thr, stability_score_thresh=stab_thr,
                min_mask_region_area=6)
    for t in (-1.0, 0.0, 1.0):  # no pixel can change sides of a threshold
        assert np.abs(up_j - t).min() > d_up
    assert np.abs(iou.astype(np.float64) - pred_thr).min() > SCORE_TOL
    assert np.abs(stab.astype(np.float64) - stab_thr).min() > SCORE_TOL

    calls = {"jax": 0, "port": 0}

    def jdecode(e, pts, lbl):
        i = calls["jax"]
        calls["jax"] += pts.shape[0]
        n = int((np.asarray(lbl)[:, 0] == 1).sum())
        pad = pts.shape[0] - n
        return (jnp.asarray(np.concatenate([lr[i:i + n], np.zeros((pad,) + lr.shape[1:], np.float32)])),
                jnp.asarray(np.concatenate([iou[i:i + n], np.zeros((pad, 4), np.float32)])))

    def tdecode(e, pts, lbl):
        i = calls["port"]
        calls["port"] += pts.shape[0]
        return torch.from_numpy(lr[i:i + pts.shape[0]]), torch.from_numpy(iou[i:i + pts.shape[0]])

    jgen = jg.AutomaticMaskGenerator(jm, params, JCFG, jg.GeneratorConfig(**gcfg))
    jgen._decode = jdecode
    want = jgen.generate(image, grid, embed=emb)
    monkeypatch.setattr(pair["port"], "decode", tdecode)
    got = tg.AutomaticMaskGenerator(pair["port"], tg.GeneratorConfig(**gcfg)).generate(image, grid)
    assert calls["port"] == 10
    assert sum(len(x) for x in want) >= 3 and len(want[0]) < 10  # thresholds cut
    for a, b in zip(got, want):
        _records_equal(a, b)


def _near_threshold_pixels(pair, image, grid):
    """Pixels where some prompt's upscaled JAX logit lies within LOGIT_TOL
    of the mask threshold 0: the only pixels allowed to differ."""
    h, w = image.shape[:2]
    batch, (nh, nw) = js.preprocess_sam_image(image, CFG.image_size)
    emb = pair["jgen"]._encode(jnp.asarray(batch))
    coords = (grid * np.array([[nw, nh]]) / CFG.image_size).astype(np.float32)
    lr, _ = pair["jgen"]._decode(emb, jnp.asarray(coords[:, None]),
                                 jnp.ones((len(grid), 1), jnp.int32))
    up = tg.upscale_masks(torch.from_numpy(np.asarray(lr)), CFG.image_size, nh, nw, h, w).numpy()
    return (np.abs(up) < LOGIT_TOL).any(axis=(0, 1))


def test_generate_end_to_end_matches(pair):
    rng = np.random.default_rng(8)
    image = rng.integers(0, 255, (48, 64, 3), np.uint8)
    grid = rng.uniform(0.05, 0.95, (9, 2))
    want = pair["jgen"].generate(image, grid)
    got = tg.AutomaticMaskGenerator(pair["port"], tg.GeneratorConfig(**_lowered())).generate(
        image, grid)
    allowed = _near_threshold_pixels(pair, image, grid)
    assert allowed.sum() <= 2
    assert len(want[0]) > 0
    for a, b in zip(got, want):
        _records_equal(a, b, allowed)
        for r in a:
            assert r["segmentation"].shape == (48, 64) and r["area"] == r["segmentation"].sum()


def test_generate_with_precomputed_embedding(pair):
    """generate(embed=...) of an image's own embedding equals generate(image)
    exactly; embeddings encoded in one batch of several images (and
    several shapes) equal the one-image ones within EMBED_TOL."""
    rng = np.random.default_rng(9)
    images = [rng.integers(0, 255, (40, 64, 3), np.uint8) for _ in range(2)]
    images.append(rng.integers(0, 255, (64, 48, 3), np.uint8))
    grid = rng.uniform(0.1, 0.9, (5, 2))
    gen = tg.AutomaticMaskGenerator(pair["port"], tg.GeneratorConfig(**_lowered()))
    embeds = gen.encode_images(images)
    assert len(embeds) == 3 and embeds[0].shape == (1, CFG.prompt_dim, CFG.grid, CFG.grid)
    for img, emb in zip(images, embeds):
        own = gen.encode_images([img])[0]
        np.testing.assert_allclose(emb.numpy(), own.numpy(), rtol=0, atol=EMBED_TOL)
        base, fast = gen.generate(img, grid), gen.generate(img, grid, embed=own)
        assert sum(len(a) for a in base) > 0
        for a, b in zip(base, fast):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                assert np.array_equal(x["segmentation"], y["segmentation"])
                assert x["predicted_iou"] == y["predicted_iou"]


def test_bf16_flag_rounds_weights_computes_f32(pair):
    """JAX's --bf16 casts the parameters; float32 inputs promote every op,
    so the encoder computes and returns float32. The port rounds its
    weights to bfloat16 and computes in float32: the same numbers."""
    bf = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), pair["params"])
    img = np.random.default_rng(10).normal(size=(1, 64, 64, 3)).astype(np.float32)
    want = jax.jit(lambda p, x: pair["jax"].apply(p, x, method="encode_image"))(
        bf, jnp.asarray(img))
    assert want.dtype == jnp.float32
    port = round_weights_bf16(tload(pair["sd"], CFG, device="cpu"))
    assert all(p.dtype == torch.float32 for p in port.parameters())
    with torch.no_grad():
        got = port.encode_image(_nchw(img)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=EMBED_TOL)
