"""Carry parameters into the port: flax decoder parameters (as numpy
arrays) → torch state dicts, raw Gaussian arrays → GaussianScene
(`scene_from_arrays`, defined beside GaussianScene), a JAX GAD train
state → the port's (`load_jax_train_state`), a JAX RGB pretraining state
→ the port's (`load_jax_rgb_state`), the `decoders.pt` file that
`cli.serve.load_server` reads, and flax SAM and CLIP parameter trees →
upstream-layout state dicts (`sam_state_from_flax`, `clip_state_from_flax`,
the inverses of the JAX package's checkpoint converters)."""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from gags_torch.scene.gaussian_data import scene_from_arrays

__all__ = ["decoder_state_from_flax", "scene_from_arrays", "save_decoders",
           "load_decoder_state", "load_jax_train_state", "load_jax_rgb_state",
           "sam_state_from_flax", "clip_state_from_flax"]


def decoder_state_from_flax(params: Mapping[str, Mapping[str, np.ndarray]]) -> dict:
    """Flax Dense parameters {"d0": {"kernel": (in, out), "bias": (out,)},
    ...} (optionally wrapped in {"params": ...}) → an nn.Linear state dict
    {"d0.weight": (out, in), "d0.bias": (out,), ...}."""
    if set(params) == {"params"}:
        params = params["params"]
    state = {}
    for name, p in params.items():
        kernel = np.asarray(p["kernel"], np.float32)
        state[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(kernel.T))
        state[f"{name}.bias"] = torch.from_numpy(np.asarray(p["bias"], np.float32).copy())
    return state


def save_decoders(path: str, feature_decoder: torch.nn.Module,
                  scale_decoder: Optional[torch.nn.Module] = None) -> None:
    """Write `decoders.pt`: {"feature_decoder": state dict[, "scale_decoder": ...]}."""
    blob = {"feature_decoder": {k: v.cpu() for k, v in feature_decoder.state_dict().items()}}
    if scale_decoder is not None:
        blob["scale_decoder"] = {k: v.cpu() for k, v in scale_decoder.state_dict().items()}
    torch.save(blob, path)


def load_decoder_state(path: str) -> dict:
    """Read `decoders.pt` (tensors only) and return its dict of state dicts."""
    return torch.load(path, map_location="cpu", weights_only=True)



def load_jax_train_state(state, *, features, decoder_params, scale_params,
                         opt_states: Optional[Mapping[str, tuple]] = None,
                         step: Optional[int] = None):
    """Carry a JAX GAD TrainState (as numpy arrays) into the port's
    `gad.train.TrainState`, in place: the features, the flax parameter
    trees of both decoders and, optionally, the optax Adam states given as
    {"feat" | "dec" | "scale": (count, mu, nu)}, where mu and nu are the
    features array or flax-shaped trees (kernels are transposed like the
    parameters). Returns `state`."""
    dev = state.features.device
    with torch.no_grad():
        state.features.copy_(torch.as_tensor(np.asarray(features, np.float32)).to(dev))
    state.decoder.load_state_dict(decoder_state_from_flax(decoder_params))
    state.scale_decoder.load_state_dict(decoder_state_from_flax(scale_params))
    groups = {
        "feat": (state.opt_feat, {"": state.features}),
        "dec": (state.opt_dec, dict(state.decoder.named_parameters())),
        "scale": (state.opt_scale, dict(state.scale_decoder.named_parameters())),
    }
    for key, (count, mu, nu) in (opt_states or {}).items():
        opt, params = groups[key]
        if key != "feat":
            mu, nu = decoder_state_from_flax(mu), decoder_state_from_flax(nu)
        for name, p in params.items():
            m = mu if name == "" else mu[name]
            v = nu if name == "" else nu[name]
            opt.state[p] = {
                "step": torch.tensor(float(np.asarray(count))),
                "exp_avg": torch.as_tensor(np.asarray(m, np.float32)).to(dev).clone(),
                "exp_avg_sq": torch.as_tensor(np.asarray(v, np.float32)).to(dev).clone(),
            }
    if step is not None:
        state.step = int(step)
    return state


def load_jax_rgb_state(jstate, seed: int = 0, device="cuda"):
    """Carry a JAX `RgbState` (any object with its fields, whose values
    numpy can read) into the port's `rgb.train.RgbState` on `device`: the
    parameters, the per-group Adam moments, `alive`, `grad_accum`,
    `denom`, `max_radii` and `step`. JAX's PRNG key does not carry over;
    the port's split noise comes from a torch.Generator seeded `seed`."""
    from gags_torch import resolve_device
    from gags_torch.rgb.train import RgbState

    dev = resolve_device(device)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.array(a), dtype=dtype, device=dev)

    sh = t(jstate.sh)
    params = dict(means=t(jstate.means), sh_dc=sh[:, :1].contiguous(),
                  sh_rest=sh[:, 1:].contiguous(), opacities_raw=t(jstate.opacities_raw),
                  scales_raw=t(jstate.scales_raw), quats=t(jstate.quats))
    opt = {g: {k: t(v) for k, v in jstate.opt[g].items()} for g in params}
    return RgbState(
        step=int(np.asarray(jstate.step)), params=params, alive=t(jstate.alive, torch.bool),
        grad_accum=t(jstate.grad_accum), denom=t(jstate.denom), max_radii=t(jstate.max_radii),
        opt=opt, generator=torch.Generator(device=dev).manual_seed(seed))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def _unwrap(params):
    return params["params"] if set(params) == {"params"} else params


def _dense(out: dict, key: str, p) -> None:
    out[f"{key}.weight"] = _t(np.asarray(p["kernel"]).T)
    out[f"{key}.bias"] = _t(p["bias"])


def _ln(out: dict, key: str, p) -> None:
    out[f"{key}.weight"] = _t(p["scale"] if "scale" in p else p["weight"])
    out[f"{key}.bias"] = _t(p["bias"])


def _conv(kernel) -> torch.Tensor:
    """flax HWIO → torch OIHW."""
    return _t(np.asarray(kernel).transpose(3, 2, 0, 1))


def _conv_transpose(kernel) -> torch.Tensor:
    """flax ConvTranspose HWIO (not flipped) → torch ConvTranspose2d
    (in, out, kh, kw), which flips spatially."""
    return _t(np.asarray(kernel).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])


def sam_state_from_flax(params, cfg) -> dict:
    """A flax SAM parameter tree (numpy arrays) → a segment-anything state
    dict of float32 tensors: the exact inverse of the JAX package's
    `load_sam_state_dict`. The keys the flax tree does not carry (the
    mask-prompt downscaler and the box-corner point embeddings,
    ckpt_inventory.SAM_UNUSED_KEYS) are not in the result."""
    p = _unwrap(params)
    enc, prm, dec = p["image_encoder"], p["prompt_encoder"], p["mask_decoder"]
    sd: dict = {
        "image_encoder.patch_embed.proj.weight": _conv(enc["patch_embed"]["kernel"]),
        "image_encoder.patch_embed.proj.bias": _t(enc["patch_embed"]["bias"]),
        "image_encoder.pos_embed": _t(enc["pos_embed"]),
        "image_encoder.neck.0.weight": _conv(enc["neck_conv1"]["kernel"]),
        "image_encoder.neck.2.weight": _conv(enc["neck_conv2"]["kernel"]),
    }
    _ln(sd, "image_encoder.neck.1", enc["neck_ln1"])
    _ln(sd, "image_encoder.neck.3", enc["neck_ln2"])
    for i in range(cfg.encoder_depth):
        b, k = enc[f"block{i}"], f"image_encoder.blocks.{i}"
        _ln(sd, f"{k}.norm1", b["ln_1"])
        _dense(sd, f"{k}.attn.qkv", b["attn"]["qkv"])
        _dense(sd, f"{k}.attn.proj", b["attn"]["proj"])
        if "rel_pos_h" in b["attn"]:
            sd[f"{k}.attn.rel_pos_h"] = _t(b["attn"]["rel_pos_h"])
            sd[f"{k}.attn.rel_pos_w"] = _t(b["attn"]["rel_pos_w"])
        _ln(sd, f"{k}.norm2", b["ln_2"])
        _dense(sd, f"{k}.mlp.lin1", b["mlp_fc1"])
        _dense(sd, f"{k}.mlp.lin2", b["mlp_fc2"])
    sd["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"] = _t(prm["pe_gaussian"])
    for key, name in (("point_embeddings.0", "point_embed_neg"),
                      ("point_embeddings.1", "point_embed_pos"),
                      ("not_a_point_embed", "not_a_point"), ("no_mask_embed", "no_mask")):
        sd[f"prompt_encoder.{key}.weight"] = _t(np.asarray(prm[name])[None])

    def two_way(key, q):
        for nm in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _dense(sd, f"{key}.{nm}", q[nm])

    sd["mask_decoder.iou_token.weight"] = _t(dec["iou_token"])
    sd["mask_decoder.mask_tokens.weight"] = _t(dec["mask_tokens"])
    two_way("mask_decoder.transformer.final_attn_token_to_image", dec["final_t2i"])
    _ln(sd, "mask_decoder.transformer.norm_final_attn", dec["ln_final"])
    sd["mask_decoder.output_upscaling.0.weight"] = _conv_transpose(dec["up1"]["kernel"])
    sd["mask_decoder.output_upscaling.0.bias"] = _t(dec["up1"]["bias"])
    _ln(sd, "mask_decoder.output_upscaling.1", dec["up_ln"])
    sd["mask_decoder.output_upscaling.3.weight"] = _conv_transpose(dec["up2"]["kernel"])
    sd["mask_decoder.output_upscaling.3.bias"] = _t(dec["up2"]["bias"])
    for i in range(cfg.decoder_depth):
        b, k = dec[f"block{i}"], f"mask_decoder.transformer.layers.{i}"
        two_way(f"{k}.self_attn", b["self_attn"])
        two_way(f"{k}.cross_attn_token_to_image", b["cross_t2i"])
        two_way(f"{k}.cross_attn_image_to_token", b["cross_i2t"])
        for j in range(1, 5):
            _ln(sd, f"{k}.norm{j}", b[f"ln{j}"])
        _dense(sd, f"{k}.mlp.lin1", b["mlp_fc1"])
        _dense(sd, f"{k}.mlp.lin2", b["mlp_fc2"])
    for i in range(cfg.mask_tokens):
        k = f"mask_decoder.output_hypernetworks_mlps.{i}.layers"
        for j, nm in enumerate((f"hyper{i}_fc0", f"hyper{i}_fc1", f"hyper{i}_out")):
            _dense(sd, f"{k}.{j}", dec[nm])
    for j, nm in enumerate(("iou_fc0", "iou_fc1", "iou_out")):
        _dense(sd, f"mask_decoder.iou_prediction_head.layers.{j}", dec[nm])
    return sd


def clip_state_from_flax(params, cfg) -> dict:
    """A flax CLIP parameter tree {"visual": ..., "text": ...} (numpy
    arrays) → an open_clip state dict of float32 tensors: the exact
    inverse of the JAX package's `load_openclip_state_dict`. `logit_scale`
    (ckpt_inventory.CLIP_UNUSED_KEYS) is not carried by the flax tree."""
    p = _unwrap(params)
    vis, txt = p["visual"], p["text"]
    sd: dict = {}

    def blocks(prefix, tree, layers):
        for i in range(layers):
            b, k = tree[f"block{i}"], f"{prefix}.resblocks.{i}"
            _ln(sd, f"{k}.ln_1", b["ln_1"])
            sd[f"{k}.attn.in_proj_weight"] = _t(np.asarray(b["attn"]["in_proj"]["kernel"]).T)
            sd[f"{k}.attn.in_proj_bias"] = _t(b["attn"]["in_proj"]["bias"])
            _dense(sd, f"{k}.attn.out_proj", b["attn"]["out_proj"])
            _ln(sd, f"{k}.ln_2", b["ln_2"])
            _dense(sd, f"{k}.mlp.c_fc", b["mlp_fc"])
            _dense(sd, f"{k}.mlp.c_proj", b["mlp_proj"])

    sd["visual.conv1.weight"] = _conv(vis["patch_embed"]["kernel"])
    sd["visual.class_embedding"] = _t(vis["class_embedding"])
    sd["visual.positional_embedding"] = _t(vis["positional_embedding"])
    _ln(sd, "visual.ln_pre", vis["ln_pre"])
    _ln(sd, "visual.ln_post", vis["ln_post"])
    sd["visual.proj"] = _t(vis["proj"])
    blocks("visual.transformer", vis, cfg.vision_layers)
    sd["token_embedding.weight"] = _t(txt["token_embedding"])
    sd["positional_embedding"] = _t(txt["positional_embedding"])
    _ln(sd, "ln_final", txt["ln_final"])
    sd["text_projection"] = _t(txt["text_projection"])
    blocks("transformer", txt, cfg.text_layers)
    return sd
