"""Exact key/shape inventories of the REAL upstream checkpoints (a copy of
gags_tpu.models.ckpt_inventory against the port's own configs).

The port's SAM and CLIP modules carry the upstream state-dict names, so
these inventories are what `module.state_dict()` must hold, key for key
and shape for shape (`state_shapes`): `sam_vit_h_4b8939.pth`, OpenCLIP
ViT-B-16 laion2b and AlphaCLIP ViT-L/14@336. `cli/convert_weights.py`
diffs a real file against them before it loads the file strictly.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from gags_torch.models.clip import CLIPConfig
from gags_torch.models.sam import SAMConfig

Shape = Tuple[int, ...]


def sam_inventory(cfg: SAMConfig) -> Dict[str, Shape]:
    """Key → shape of a segment-anything `sam_vit_*.pth` state dict."""
    e = cfg.encoder_dim
    hd = e // cfg.encoder_heads
    grid = cfg.grid
    win = cfg.window_size
    pd = cfg.prompt_dim
    inv: Dict[str, Shape] = {
        "image_encoder.patch_embed.proj.weight": (e, 3, cfg.patch_size, cfg.patch_size),
        "image_encoder.patch_embed.proj.bias": (e,),
        "image_encoder.pos_embed": (1, grid, grid, e),
        # neck convs are bias-free (segment_anything ImageEncoderViT.neck)
        "image_encoder.neck.0.weight": (pd, e, 1, 1),
        "image_encoder.neck.1.weight": (pd,),
        "image_encoder.neck.1.bias": (pd,),
        "image_encoder.neck.2.weight": (pd, pd, 3, 3),
        "image_encoder.neck.3.weight": (pd,),
        "image_encoder.neck.3.bias": (pd,),
    }
    for i in range(cfg.encoder_depth):
        p = f"image_encoder.blocks.{i}"
        # rel-pos tables sized by the attention span: the full grid for
        # global blocks, the window for the rest (use_rel_pos=True for all)
        span = grid if i in cfg.global_attn_idx else win
        inv.update({
            f"{p}.norm1.weight": (e,), f"{p}.norm1.bias": (e,),
            f"{p}.attn.rel_pos_h": (2 * span - 1, hd),
            f"{p}.attn.rel_pos_w": (2 * span - 1, hd),
            f"{p}.attn.qkv.weight": (3 * e, e), f"{p}.attn.qkv.bias": (3 * e,),
            f"{p}.attn.proj.weight": (e, e), f"{p}.attn.proj.bias": (e,),
            f"{p}.norm2.weight": (e,), f"{p}.norm2.bias": (e,),
            f"{p}.mlp.lin1.weight": (4 * e, e), f"{p}.mlp.lin1.bias": (4 * e,),
            f"{p}.mlp.lin2.weight": (e, 4 * e), f"{p}.mlp.lin2.bias": (e,),
        })

    inv.update({
        "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix": (2, pd // 2),
        "prompt_encoder.not_a_point_embed.weight": (1, pd),
        "prompt_encoder.no_mask_embed.weight": (1, pd),
    })
    for i in range(4):  # neg, pos, box corner 1, box corner 2
        inv[f"prompt_encoder.point_embeddings.{i}.weight"] = (1, pd)
    # mask-input downscaler (mask prompts; unused by the GAGS point pipeline)
    mc = 16
    inv.update({
        "prompt_encoder.mask_downscaling.0.weight": (mc // 4, 1, 2, 2),
        "prompt_encoder.mask_downscaling.0.bias": (mc // 4,),
        "prompt_encoder.mask_downscaling.1.weight": (mc // 4,),
        "prompt_encoder.mask_downscaling.1.bias": (mc // 4,),
        "prompt_encoder.mask_downscaling.3.weight": (mc, mc // 4, 2, 2),
        "prompt_encoder.mask_downscaling.3.bias": (mc,),
        "prompt_encoder.mask_downscaling.4.weight": (mc,),
        "prompt_encoder.mask_downscaling.4.bias": (mc,),
        "prompt_encoder.mask_downscaling.6.weight": (pd, mc, 1, 1),
        "prompt_encoder.mask_downscaling.6.bias": (pd,),
    })

    dd = pd // 2  # cross-attention downsample_rate=2
    mlp_dim = 2048
    nt = cfg.mask_tokens

    def attn(prefix: str, inner: int) -> Dict[str, Shape]:
        out = {}
        for nm in ("q_proj", "k_proj", "v_proj"):
            out[f"{prefix}.{nm}.weight"] = (inner, pd)
            out[f"{prefix}.{nm}.bias"] = (inner,)
        out[f"{prefix}.out_proj.weight"] = (pd, inner)
        out[f"{prefix}.out_proj.bias"] = (pd,)
        return out

    inv.update({
        "mask_decoder.iou_token.weight": (1, pd),
        "mask_decoder.mask_tokens.weight": (nt, pd),
        "mask_decoder.transformer.norm_final_attn.weight": (pd,),
        "mask_decoder.transformer.norm_final_attn.bias": (pd,),
        "mask_decoder.output_upscaling.0.weight": (pd, pd // 4, 2, 2),
        "mask_decoder.output_upscaling.0.bias": (pd // 4,),
        "mask_decoder.output_upscaling.1.weight": (pd // 4,),
        "mask_decoder.output_upscaling.1.bias": (pd // 4,),
        "mask_decoder.output_upscaling.3.weight": (pd // 4, pd // 8, 2, 2),
        "mask_decoder.output_upscaling.3.bias": (pd // 8,),
    })
    inv.update(attn("mask_decoder.transformer.final_attn_token_to_image", dd))
    for i in range(cfg.decoder_depth):
        p = f"mask_decoder.transformer.layers.{i}"
        inv.update(attn(f"{p}.self_attn", pd))
        inv.update(attn(f"{p}.cross_attn_token_to_image", dd))
        inv.update(attn(f"{p}.cross_attn_image_to_token", dd))
        for j in range(1, 5):
            inv[f"{p}.norm{j}.weight"] = (pd,)
            inv[f"{p}.norm{j}.bias"] = (pd,)
        inv[f"{p}.mlp.lin1.weight"] = (mlp_dim, pd)
        inv[f"{p}.mlp.lin1.bias"] = (mlp_dim,)
        inv[f"{p}.mlp.lin2.weight"] = (pd, mlp_dim)
        inv[f"{p}.mlp.lin2.bias"] = (pd,)
    for i in range(nt):
        p = f"mask_decoder.output_hypernetworks_mlps.{i}.layers"
        inv[f"{p}.0.weight"] = (pd, pd)
        inv[f"{p}.0.bias"] = (pd,)
        inv[f"{p}.1.weight"] = (pd, pd)
        inv[f"{p}.1.bias"] = (pd,)
        inv[f"{p}.2.weight"] = (pd // 8, pd)
        inv[f"{p}.2.bias"] = (pd // 8,)
    p = "mask_decoder.iou_prediction_head.layers"
    inv[f"{p}.0.weight"] = (pd, pd)
    inv[f"{p}.0.bias"] = (pd,)
    inv[f"{p}.1.weight"] = (pd, pd)
    inv[f"{p}.1.bias"] = (pd,)
    inv[f"{p}.2.weight"] = (nt, pd)
    inv[f"{p}.2.bias"] = (nt,)
    return inv


# keys present in the real SAM files that the GAGS pipeline never reads
# (mask-prompt path and box-prompt embeddings)
SAM_UNUSED_KEYS = (
    "prompt_encoder.mask_downscaling.",
    "prompt_encoder.point_embeddings.2.",
    "prompt_encoder.point_embeddings.3.",
)


def _clip_tower(prefix: str, width: int, layers: int) -> Dict[str, Shape]:
    inv: Dict[str, Shape] = {}
    for i in range(layers):
        p = f"{prefix}.resblocks.{i}"
        inv.update({
            f"{p}.ln_1.weight": (width,), f"{p}.ln_1.bias": (width,),
            f"{p}.attn.in_proj_weight": (3 * width, width),
            f"{p}.attn.in_proj_bias": (3 * width,),
            f"{p}.attn.out_proj.weight": (width, width),
            f"{p}.attn.out_proj.bias": (width,),
            f"{p}.ln_2.weight": (width,), f"{p}.ln_2.bias": (width,),
            f"{p}.mlp.c_fc.weight": (4 * width, width),
            f"{p}.mlp.c_fc.bias": (4 * width,),
            f"{p}.mlp.c_proj.weight": (width, 4 * width),
            f"{p}.mlp.c_proj.bias": (width,),
        })
    return inv


def openclip_inventory(cfg: CLIPConfig) -> Dict[str, Shape]:
    """Key → shape of an open_clip / OpenAI-CLIP ViT state dict (the
    `open_clip_pytorch_model.bin` layout for ViT-B-16 laion2b_s34b_b88k)."""
    vw, tw = cfg.vision_width, cfg.text_width
    n_patch = (cfg.image_size // cfg.patch_size) ** 2
    inv: Dict[str, Shape] = {
        "logit_scale": (),
        "visual.class_embedding": (vw,),
        "visual.positional_embedding": (n_patch + 1, vw),
        "visual.conv1.weight": (vw, 3, cfg.patch_size, cfg.patch_size),
        "visual.ln_pre.weight": (vw,), "visual.ln_pre.bias": (vw,),
        "visual.ln_post.weight": (vw,), "visual.ln_post.bias": (vw,),
        "visual.proj": (vw, cfg.embed_dim),
        "positional_embedding": (cfg.context_length, tw),
        "text_projection": (tw, cfg.embed_dim),
        "token_embedding.weight": (cfg.vocab_size, tw),
        "ln_final.weight": (tw,), "ln_final.bias": (tw,),
    }
    inv.update(_clip_tower("visual.transformer", vw, cfg.vision_layers))
    inv.update(_clip_tower("transformer", tw, cfg.text_layers))
    return inv


CLIP_UNUSED_KEYS = ("logit_scale",)  # relevancy uses the fixed 10x scale


def alphaclip_visual_inventory(cfg: CLIPConfig) -> Dict[str, Shape]:
    """Visual-tower keys of an alpha_clip checkpoint (OpenAI ViT layout +
    the single-channel `conv1_alpha` patch conv)."""
    inv = {
        k: v for k, v in openclip_inventory(cfg).items()
        if k.startswith("visual.")
    }
    inv["visual.conv1_alpha.weight"] = (
        cfg.vision_width, 1, cfg.patch_size, cfg.patch_size,
    )
    return inv


def state_shapes(module: torch.nn.Module) -> Dict[str, Shape]:
    """{key: shape} of a module's state dict (build it on the "meta"
    device to read the shapes without allocating the weights)."""
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def diff_shapes(got: Dict[str, Shape], want: Dict[str, Shape]) -> List[str]:
    """Human-readable mismatches between two {path: shape} maps."""
    problems = []
    for k in sorted(set(got) | set(want)):
        if k not in got:
            problems.append(f"missing from the model: {k} {want[k]}")
        elif k not in want:
            problems.append(f"unexpected in the model: {k} {got[k]}")
        elif got[k] != want[k]:
            problems.append(f"shape mismatch at {k}: model {got[k]} vs expected {want[k]}")
    return problems
