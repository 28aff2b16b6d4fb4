"""CLIP and its tokenizer, the port against gags_tpu.models: token ids
exact; the vision, text and AlphaCLIP towers built from ONE random
open_clip-layout state dict loaded into both packages agree to 2e-5
(embeddings of norm ~1-5); preprocess_images to 1e-6 where it upsamples
and 1e-4 where it downsamples (antialiased)."""

import gzip

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gags_tpu.models import clip as jc
from gags_tpu.models.tokenizer import ClipTokenizer as JTokenizer
from gags_tpu.models.tokenizer import bytes_to_unicode as jbytes_to_unicode
from gags_torch.models import clip as tc
from gags_torch.models.tokenizer import ClipTokenizer, bytes_to_unicode

EMBED_TOL = 2e-5
CFG, JCFG = tc.CLIPConfig.tiny(), jc.CLIPConfig.tiny()


def write_bpe(path):
    """A small merge table: "hello", "world", "a photo of" merge fully."""
    merges = ["#version: 0.2", "h e", "he l", "hel l", "hell o</w>", "w o", "wo r", "wor l",
              "worl d</w>", "p h", "ph o", "pho t", "phot o</w>", "o f</w>"]
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(merges) + "\n")
    return path


def random_openclip_state(cfg, seed=0, alpha=False):
    """Random weights in open_clip's state-dict layout, from the port's own
    module shapes (built on the meta device)."""
    rng = np.random.default_rng(seed)
    shapes = {k: tuple(v.shape) for k, v in tc.CLIP(cfg, device="meta").state_dict().items()}
    if alpha:
        p = cfg.patch_size
        shapes["visual.conv1_alpha.weight"] = (cfg.vision_width, 1, p, p)
    sd = {}
    for k, s in shapes.items():
        if ".ln" in k or k.startswith("ln_"):
            mean, std = (1.0, 0.1) if k.endswith("weight") else (0.0, 0.1)
        else:
            mean, std = 0.0, 0.3 if ("embedding" in k or "proj" in k) else 0.1
        sd[k] = rng.normal(mean, std, s).astype(np.float32)
    return sd


@pytest.fixture(scope="module")
def towers():
    sd = random_openclip_state(CFG, alpha=True)
    text_vis = {k: v for k, v in sd.items() if "conv1_alpha" not in k}
    return dict(sd=sd, port=tc.load_openclip_state_dict(text_vis, CFG, device="cpu"),
                jax=jc.load_openclip_state_dict(text_vis, JCFG),
                port_alpha=tc.load_alphaclip_state_dict(sd, CFG, device="cpu"),
                jax_alpha=jc.load_alphaclip_state_dict(sd, JCFG))


def test_tokenizer_ids_match(tmp_path):
    path = write_bpe(str(tmp_path / "bpe.txt.gz"))
    tok, jtok = ClipTokenizer(path), JTokenizer(path)
    texts = ["hello world", "a photo of a teapot", "Hello,  WORLD!!", "xyz 42 &amp; it's",
             "word " * 60]
    np.testing.assert_array_equal(tok(texts), jtok(texts))
    assert tok.encode("hello") == jtok.encode("hello") and len(tok.encode("hello")) == 1
    assert tok(texts)[4, -1] == tok.eot  # truncation keeps the end of text
    assert bytes_to_unicode() == jbytes_to_unicode()


def test_tokenizer_needs_merges(monkeypatch):
    monkeypatch.delenv("GAGS_CLIP_BPE", raising=False)
    with pytest.raises(FileNotFoundError, match="GAGS_CLIP_BPE"):
        ClipTokenizer()


def test_vision_tower_matches(towers):
    imgs = np.random.default_rng(1).normal(size=(3, CFG.image_size, CFG.image_size, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: jc.CLIP(JCFG).apply(p, x, method="encode_image"))(
        towers["jax"], jnp.asarray(imgs)))
    with torch.no_grad():
        got = towers["port"].encode_image(torch.from_numpy(imgs).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (3, CFG.embed_dim)
    np.testing.assert_allclose(got, want, rtol=0, atol=EMBED_TOL)
    assert np.abs(want).max() > 0.5


def test_text_tower_matches(towers):
    toks = np.zeros((3, CFG.context_length), np.int32)
    toks[0, :5] = [61, 5, 9, 3, 63]
    toks[1, :3] = [61, 7, 63]
    toks[2, :] = np.arange(12) + 40  # no padding at all: pool at the last token
    want = np.asarray(jax.jit(lambda p, t: jc.CLIP(JCFG).apply(p, t, method="encode_text"))(
        towers["jax"], jnp.asarray(toks)))
    with torch.no_grad():
        got = towers["port"].encode_text(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=EMBED_TOL)
    assert np.abs(want).max() > 0.5


def test_alpha_tower_matches(towers):
    rng = np.random.default_rng(2)
    s = CFG.image_size
    imgs = rng.normal(size=(2, s, s, 3)).astype(np.float32)
    alpha = (rng.random((2, s, s, 1)) < 0.5).astype(np.float32)
    want = np.asarray(jax.jit(jc.VisionTowerAlpha(JCFG).apply)(
        towers["jax_alpha"], jnp.asarray(imgs), jnp.asarray(alpha)))
    with torch.no_grad():
        got = towers["port_alpha"](torch.from_numpy(imgs).permute(0, 3, 1, 2),
                                   torch.from_numpy(alpha).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=EMBED_TOL)


@pytest.mark.parametrize("hw,atol", [((32, 32), 1e-6), ((20, 24), 1e-6), ((224, 224), 1e-4),
                                     ((50, 40), 1e-4)])
def test_preprocess_images_matches(hw, atol):
    """uint8 and float inputs; 224 → 32 and 50x40 → 32 downsample."""
    rng = np.random.default_rng(3)
    u8 = rng.integers(0, 256, (2, *hw, 3), np.uint8)
    for x in (u8, u8.astype(np.float32) / 255.0):
        want = np.asarray(jc.preprocess_images(jnp.asarray(x), CFG.image_size))
        got = tc.preprocess_images(torch.from_numpy(x), CFG.image_size)
        assert got.shape == (2, 3, CFG.image_size, CFG.image_size)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=atol)


def test_openclip_checkpoint_file_fp16(tmp_path, towers):
    """A half-precision file with DataParallel's prefix and a state_dict
    wrapper loads strictly into float32 modules."""
    sd = {"module." + k: torch.from_numpy(v).half() for k, v in towers["sd"].items()
          if "conv1_alpha" not in k}
    torch.save({"state_dict": sd}, tmp_path / "clip.pt")
    model, cfg = tc.load_openclip_checkpoint(str(tmp_path / "clip.pt"), CFG, device="cpu")
    assert cfg == CFG and all(p.dtype == torch.float32 for p in model.parameters())
    np.testing.assert_array_equal(model.visual.proj.detach().numpy(),
                                  sd["module.visual.proj"].float().numpy())
    bad = dict(sd)
    bad.pop("module.ln_final.bias")
    with pytest.raises(RuntimeError, match="ln_final.bias"):
        tc.load_openclip_state_dict(bad, CFG, device="cpu")
