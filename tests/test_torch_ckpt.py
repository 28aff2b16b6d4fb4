"""Checkpoint interop of the port's SAM and CLIP: the flax → upstream-layout
converters invert the JAX package's converters exactly; the port's
`state_dict()` is the real checkpoints' inventory (built on the meta
device, nothing allocated); half-precision files load strictly into
float32 modules; and the convert_weights CLI on synthetic files in the
real layout."""

import numpy as np
import jax
import pytest
import torch

from gags_tpu.models import clip as jc
from gags_tpu.models import sam as js
from gags_tpu.models.sam_weights import load_sam_state_dict as jload_sam
from gags_torch.cli import convert_weights as cw
from gags_torch.models import ckpt_inventory as inv
from gags_torch.models import clip as tc
from gags_torch.models import sam as ts
from gags_torch.models.sam_weights import load_sam_checkpoint
from gags_torch.models.weights import clip_state_from_flax, sam_state_from_flax

NARROW = dict(image_size=64, patch_size=8, encoder_dim=32, encoder_depth=3, encoder_heads=2,
              window_size=4, global_attn_idx=(1,))


def _random(shapes, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(0, 0.1, s).astype(dtype) for k, s in shapes.items()}


@pytest.mark.parametrize("cfg_kw", [{}, dict(NARROW, prompt_dim=32, decoder_heads=4)])
def test_sam_state_from_flax_round_trip(cfg_kw):
    cfg = ts.SAMConfig(**{**ts.SAMConfig.tiny().__dict__, **cfg_kw})
    jcfg = js.SAMConfig(**{**js.SAMConfig.tiny().__dict__, **cfg_kw})
    sd = _random(inv.state_shapes(ts.SAM(cfg, device="meta")))
    flax_tree = jax.tree.map(np.asarray, jload_sam(sd, jcfg))
    back = sam_state_from_flax(flax_tree, cfg)
    assert sorted(set(sd) - set(back)) == sorted(
        k for k in sd if k.startswith(inv.SAM_UNUSED_KEYS))
    for k, v in back.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    # the carried keys load into the port; only the unused ones are missing
    res = ts.SAM(cfg).load_state_dict(back, strict=False)
    assert not res.unexpected_keys
    assert all(k.startswith(inv.SAM_UNUSED_KEYS) for k in res.missing_keys)


@pytest.mark.parametrize("name", ["tiny", "narrow"])
def test_clip_state_from_flax_round_trip(name):
    cfg = tc.CLIPConfig.tiny() if name == "tiny" else tc.CLIPConfig(
        embed_dim=24, image_size=48, patch_size=16, vision_width=48, vision_layers=3,
        vision_heads=4, vocab_size=80, context_length=9, text_width=32, text_heads=4,
        text_layers=1)
    jcfg = jc.CLIPConfig(**cfg.__dict__)
    sd = _random(inv.state_shapes(tc.CLIP(cfg, device="meta")), seed=1)
    back = clip_state_from_flax(jax.tree.map(np.asarray, jc.load_openclip_state_dict(sd, jcfg)),
                                cfg)
    assert sorted(set(sd) - set(back)) == list(inv.CLIP_UNUSED_KEYS)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


@pytest.mark.parametrize("arch", ["vit_h", "vit_l", "vit_b"])
def test_sam_state_dict_is_the_real_inventory(arch):
    cfg = getattr(ts.SAMConfig, arch)()
    model = ts.SAM(cfg, device="meta")
    assert inv.diff_shapes(inv.state_shapes(model), inv.sam_inventory(cfg)) == []
    # the JAX package's inventory of the same file
    from gags_tpu.models import ckpt_inventory as jinv

    assert inv.sam_inventory(cfg) == jinv.sam_inventory(getattr(js.SAMConfig, arch)())


def test_vit_h_inventory_published_stats():
    iv = inv.sam_inventory(ts.SAMConfig.vit_h())
    n = sum(int(np.prod(s)) for s in iv.values())
    assert 630e6 < n < 650e6
    assert iv["image_encoder.blocks.7.attn.rel_pos_h"] == (127, 80)  # global
    assert iv["image_encoder.blocks.0.attn.rel_pos_h"] == (27, 80)  # windowed
    n_model = sum(p.numel() for p in ts.SAM(ts.SAMConfig.vit_h(), device="meta").parameters())
    n_buffers = 2 * 128  # the random positional-encoding matrix is a buffer
    assert n_model + n_buffers == n


def test_clip_state_dicts_are_the_real_inventories():
    cfg = tc.CLIPConfig.vit_b_16()
    assert inv.diff_shapes(inv.state_shapes(tc.CLIP(cfg, device="meta")),
                           inv.openclip_inventory(cfg)) == []
    cfg = tc.CLIPConfig.vit_l_14_336()
    alpha = {"visual." + k: s for k, s in
             inv.state_shapes(tc.VisionTowerAlpha(cfg, device="meta")).items()}
    assert inv.diff_shapes(alpha, inv.alphaclip_visual_inventory(cfg)) == []


def test_fp16_checkpoint_loads_into_f32(tmp_path):
    cfg = ts.SAMConfig.tiny()
    sd = {k: torch.from_numpy(v) for k, v in
          _random(inv.state_shapes(ts.SAM(cfg, device="meta")), 2, np.float16).items()}
    torch.save({"model": sd}, tmp_path / "sam.pth")
    model, got_cfg = load_sam_checkpoint(str(tmp_path / "sam.pth"), cfg, device="cpu")
    assert got_cfg == cfg
    for k, v in model.state_dict().items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), sd[k].float().numpy(), err_msg=k)
    sd.pop("mask_decoder.iou_token.weight")
    torch.save(sd, tmp_path / "bad.pth")
    with pytest.raises(RuntimeError, match="iou_token"):
        load_sam_checkpoint(str(tmp_path / "bad.pth"), cfg, device="cpu")


@pytest.mark.parametrize("what", ["sam", "openclip", "alphaclip", "preprocess_sam_image"])
def test_loaders_default_to_cuda(what):
    """Called without a device, the loaders and SAM's preprocessing put
    their result on the card, and raise where there is none: the CPU is
    reached only when asked for."""
    from gags_torch.models.sam_weights import load_sam_state_dict

    if what == "sam":
        cfg = ts.SAMConfig.tiny()
        call = lambda: load_sam_state_dict(  # noqa: E731
            _random(inv.state_shapes(ts.SAM(cfg, device="meta"))), cfg).image_encoder
    elif what == "preprocess_sam_image":
        call = lambda: ts.preprocess_sam_image(np.zeros((6, 8, 3), np.uint8), 16)[0]  # noqa: E731
    else:
        cfg = tc.CLIPConfig.tiny()
        model = tc.CLIP if what == "openclip" else tc.VisionTowerAlpha
        shapes = inv.state_shapes(model(cfg, device="meta"))
        if what == "openclip":
            call = lambda: tc.load_openclip_state_dict(_random(shapes), cfg)  # noqa: E731
        else:
            sd = {"visual." + k: v for k, v in _random(shapes).items()}
            call = lambda: tc.load_alphaclip_state_dict(sd, cfg)  # noqa: E731
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            call()
        return
    out = call()
    t = out if torch.is_tensor(out) else next(out.parameters())
    assert t.device.type == "cuda"


def _zeros_file(path, shapes, wrapper=None):
    sd = {k: torch.zeros(s, dtype=torch.float16) for k, s in shapes.items()}
    torch.save({wrapper: sd} if wrapper else sd, path)
    return str(path)


def test_convert_weights_cli_on_real_layout_files(tmp_path, capsys):
    """ViT-B SAM and OpenCLIP ViT-B/16 files in the real layout (fp16
    zeros): inventory clean, strict load, ALL OK; a file with a key
    missing fails."""
    sam = _zeros_file(tmp_path / "sam_vit_b.pth", inv.sam_inventory(ts.SAMConfig.vit_b()), "model")
    clip = _zeros_file(tmp_path / "open_clip.bin", inv.openclip_inventory(tc.CLIPConfig.vit_b_16()))
    assert cw.main(["--sam", sam, "--openclip", clip, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "detected encoder_dim=768" in out and "ALL OK" in out
    assert "[sam] loaded strictly" in out and "[openclip] loaded strictly" in out
    shapes = inv.openclip_inventory(tc.CLIPConfig.vit_b_16())
    shapes.pop("visual.proj")
    bad = _zeros_file(tmp_path / "bad.bin", shapes)
    assert cw.main(["--openclip", bad, "--device", "cpu"]) == 1
    assert "missing from file: visual.proj" in capsys.readouterr().out


def test_convert_weights_forward_against_transformers(tmp_path, capsys, monkeypatch):
    """--forward on a narrow SAM (the real decoder width, so the inventory
    holds): the port's encoder against transformers' SamVisionModel on the
    same weights, where transformers imports."""
    monkeypatch.setenv("USE_TF", "0")  # transformers' TensorFlow side is not needed
    pytest.importorskip("transformers")
    cfg = ts.SAMConfig(**NARROW)
    sd = {k: torch.from_numpy(v) for k, v in
          _random(inv.state_shapes(ts.SAM(cfg, device="meta")), 3).items()}
    torch.save({"model": sd}, tmp_path / "sam.pth")
    assert cw.check_sam(str(tmp_path / "sam.pth"), True, torch.device("cpu"), cfg)
    out = capsys.readouterr().out
    err = float(out.split("max|diff|=")[1].split()[0])
    assert err < 1e-4, out
