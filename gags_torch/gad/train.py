"""GAD distillation: the train step (port of gags_tpu.gad.train).

One step renders the F-dim features of a camera with the frozen geometry
(kernel K1 forward; K2 and K3 in the backward), decodes a 3-way scale map
and the CLIP-space features, forms the blended-GT supervision L1 and the
region losses (kernel K4), and applies three Adam updates.

Gradient topology (as the reference): the scale decoder sees a DETACHED
feature map but receives the L1 gradient through the scale-blended GT map
plus the entropy regulariser; the Gaussian features and the feature
decoder train through the L1 and the region-variance loss on the F-dim
map; geometry is frozen. The schedule weights (entropy_w, regionvar_w)
are plain floats: (0.001, 0) before `schedule_switch`, (0.002, 0.1) after.

Traced (utils/tracing), each span timed by CUDA events on the stream as
well: `gad.render`
(the rasterizer's forward), `gad.decoders` (the scale and feature
decoders' forwards, the latter up to its normalisation), `gad.losses`
(mixed segmentation, the normalisation and supervision L1 (J6 on CUDA),
region losses, entropy), `gad.backward` and `gad.adam` (the three updates).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
from typing import Dict, Tuple

import torch

from gags_torch import resolve_device
from gags_torch.gad import losses
from gags_torch.gad.supervision import (blend_gt_feature_map, mixed_seg_map,
                                        normalised_supervision_l1)
from gags_torch.models.decoders import FeatureDecoder, ScaleDecoder, l2_normalise
from gags_torch.scene.gaussian_data import GaussianScene
from gags_torch.splat.rasterizer import RasterizeConfig, rasterize, rasterize_binned
from gags_torch.utils import tracing


@dataclasses.dataclass(frozen=True)
class GadConfig:
    feature_dim: int = 16          # distilled dim
    clip_dim: int = 512
    feature_lr: float = 1e-3
    decoder_lr: float = 1e-4
    adam_eps_features: float = 1e-15
    max_segments: int = 4096       # segment capacity of the region losses
    entropy_w_early: float = 1e-3
    entropy_w_late: float = 2e-3
    regionvar_w_late: float = 0.1
    schedule_switch: int = 15001
    single_scale: str = ""         # "", "s", "m", "l", "mix"
    # residual-free normalisation, supervision and L1, J6 on CUDA (same math
    # as the generic composition; applies on the same-resolution default
    # supervision path only)
    fused_supervision: bool = True
    # decoders under bfloat16 autocast: bf16 matmuls and activations, f32
    # parameters, f32 final normalise and softmax
    decoder_bf16: bool = False
    raster: RasterizeConfig = RasterizeConfig()

    def save(self, model_dir: str) -> None:
        with open(os.path.join(model_dir, "gad_cfg.json"), "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)

    @staticmethod
    def load(model_dir: str, **overrides) -> "GadConfig":
        """The training config a model dir carries (gad_cfg.json), with
        overrides on top; a missing file gives the defaults. Fields the
        port does not know (the JAX package's TPU switches) are dropped."""
        path = os.path.join(model_dir, "gad_cfg.json")
        data = {}
        if os.path.exists(path):
            with open(path) as f:
                data = json.load(f)
        raster = data.pop("raster", None)
        overrides = dict(overrides)
        ov_raster = overrides.pop("raster", None)
        data.update(overrides)
        fields = {f.name for f in dataclasses.fields(GadConfig) if f.name != "raster"}
        cfg = {k: v for k, v in data.items() if k in fields}
        if ov_raster is not None:
            cfg["raster"] = ov_raster
        elif raster is not None:
            rfields = {f.name for f in dataclasses.fields(RasterizeConfig)}
            cfg["raster"] = RasterizeConfig(**{k: v for k, v in raster.items() if k in rfields})
        return GadConfig(**cfg)


@dataclasses.dataclass
class TrainState:
    step: int
    features: torch.Tensor  # (N, F) trainable leaf
    decoder: FeatureDecoder
    scale_decoder: ScaleDecoder
    opt_feat: torch.optim.Adam
    opt_dec: torch.optim.Adam
    opt_scale: torch.optim.Adam

    @property
    def device(self) -> torch.device:
        return self.features.device


def create_train_state(scene: GaussianScene, cfg: GadConfig, seed: int = 0,
                       device="cuda") -> TrainState:
    """Features (the scene's, or zeros), decoders initialised from a seeded
    torch.Generator, and the three Adam optimisers, on `device` (default
    "cuda", which raises when CUDA is absent; the steps run where the state
    lives, so tests pass "cpu")."""
    device = resolve_device(device)
    n = scene.num_gaussians
    if scene.semantic_features is None:
        feats = torch.zeros((n, cfg.feature_dim), dtype=torch.float32)
    elif scene.semantic_features.shape[1] == cfg.feature_dim:
        feats = scene.semantic_features.detach().to(torch.float32)
    else:
        raise ValueError(
            f"scene carries {scene.semantic_features.shape[1]}-dim semantic "
            f"features but cfg.feature_dim={cfg.feature_dim}; pass the "
            "matching feature_dim or strip the features to train fresh"
        )
    features = feats.to(device).clone().requires_grad_(True)
    gen = torch.Generator().manual_seed(seed)
    dec = FeatureDecoder(in_dim=cfg.feature_dim, output_dim=cfg.clip_dim, generator=gen,
                         device="cpu").to(device)
    scl = ScaleDecoder(in_dim=cfg.feature_dim, generator=gen, device="cpu").to(device)
    return TrainState(
        step=0,
        features=features,
        decoder=dec,
        scale_decoder=scl,
        opt_feat=torch.optim.Adam([features], lr=cfg.feature_lr, eps=cfg.adam_eps_features),
        opt_dec=torch.optim.Adam(dec.parameters(), lr=cfg.decoder_lr),
        opt_scale=torch.optim.Adam(scl.parameters(), lr=cfg.decoder_lr),
    )


def loss_weights(step: int, cfg: GadConfig) -> Tuple[float, float]:
    if step < cfg.schedule_switch:
        return cfg.entropy_w_early, 0.0
    return cfg.entropy_w_late, cfg.regionvar_w_late


def frozen_geometry(scene: GaussianScene) -> Dict[str, torch.Tensor]:
    """Activated frozen geometry arrays (the step's runtime arguments)."""
    return dict(means=scene.means, quats=scene.quats, scales=scene.scales,
                opacities=scene.opacities)


_SINGLE_SCALE = {"s": (1.0, 0.0, 0.0), "m": (0.0, 1.0, 0.0),
                 "l": (0.0, 0.0, 1.0), "mix": (1 / 3, 1 / 3, 1 / 3)}


def _decoder_precision(cfg: GadConfig, device: torch.device):
    if cfg.decoder_bf16:
        return torch.autocast(device.type, dtype=torch.bfloat16)
    return contextlib.nullcontext()


def supervised_l1_pix(cfg: GadConfig, raw, scale_map, batch):
    """Masked per-pixel L1 of the feature decoder's rows against the
    blended GT map; `raw` is its last layer before the normalisation
    (`FeatureDecoder.unnormalised`). Where the fused autograd Function
    applies (supervision at render resolution, default mode) it is
    `normalised_supervision_l1` (J6 on CUDA); otherwise the rows are
    normalised and composed generically."""
    seg_map = batch["seg_map"]
    lead = tuple(raw.shape[:-1])
    n_px = 1
    for s in lead:
        n_px *= int(s)
    if cfg.fused_supervision and n_px == int(seg_map.shape[0]) * int(seg_map.shape[1]):
        return normalised_supervision_l1(raw, batch["img_embed"],
                                         seg_map[..., 1:4].reshape(lead + (3,)), scale_map)
    decoded = l2_normalise(raw)
    gt_map, mask = blend_gt_feature_map(batch["img_embed"], seg_map, scale_map)
    maskf = mask.to(torch.float32)
    return losses.l1_map(decoded * maskf, gt_map * maskf)


def _scale_map_fn(cfg: GadConfig, scale_decoder, feat_map):
    """Learned 3-way granularity map of the DETACHED features, or a fixed
    one under single_scale; keeps feat_map's leading shape."""
    if cfg.single_scale:
        w = torch.tensor(_SINGLE_SCALE[cfg.single_scale], dtype=torch.float32,
                         device=feat_map.device)
        return w.expand(feat_map.shape[:-1] + (3,))
    with _decoder_precision(cfg, feat_map.device):
        return scale_decoder(feat_map.detach()).float()


def _supervision_losses(cfg: GadConfig, decoder, scale_decoder, feat_map, batch):
    """Scale decode → mixed-seg compose → feature decode → L1 / entropy /
    region variance. Pixels run flat (H*W, ·) where the fused supervision
    applies. Returns (l1_feature, ent, regvar, scale_px)."""
    hw = tuple(feat_map.shape[:2])
    flat_ok = cfg.fused_supervision and tuple(batch["seg_map"].shape[:2]) == hw
    px = feat_map.reshape(-1, feat_map.shape[-1]) if flat_ok else feat_map
    dev = px.device
    with tracing.span("gad.decoders", device=dev):
        scale_px = _scale_map_fn(cfg, scale_decoder, px)
    with tracing.span("gad.losses", device=dev):
        seg_mixed = mixed_seg_map(batch["seg_map"], scale_px.reshape(hw + (3,)))
    with tracing.span("gad.decoders", device=dev), _decoder_precision(cfg, dev):
        raw = decoder.unnormalised(px)
    with tracing.span("gad.losses", device=dev):
        l1_pix = supervised_l1_pix(cfg, raw, scale_px, batch)
        l1_feature = losses.region_balanced_l1(l1_pix, seg_mixed, cfg.max_segments)
        ent = losses.scale_entropy_loss(scale_px)
        regvar = losses.region_variance_loss(px, seg_mixed, cfg.max_segments)
    return l1_feature, ent, regvar, scale_px


def _metrics(total, l1_feature, ent, regvar, scale_px, overflow):
    return dict(
        loss=total.detach(),
        l1_feature=l1_feature.detach(),
        entropy=ent.detach(),
        region_var=regvar.detach(),
        scale_mean_s=scale_px[..., 0].mean().detach(),
        scale_mean_m=scale_px[..., 1].mean().detach(),
        scale_mean_l=scale_px[..., 2].mean().detach(),
        overflow=overflow,
    )


def _apply(state: TrainState, total: torch.Tensor) -> None:
    """Backward and the three Adam updates."""
    opts = (state.opt_feat, state.opt_dec, state.opt_scale)
    for opt in opts:
        opt.zero_grad(set_to_none=True)
    with tracing.span("gad.backward", device=state.device):
        total.backward()
    with tracing.span("gad.adam", device=state.device):
        for opt in opts:
            opt.step()
    state.step += 1


def camera_loss(state: TrainState, geom, batch, entropy_w: float, regionvar_w: float,
                width: int, height: int, cfg: GadConfig, binned: bool = False):
    """One camera's GAD loss, differentiable in the features and both
    decoders: (total, metrics). With `binned` the batch carries the
    camera's cached binning (`make_train_step_binned`)."""
    dev = state.device
    bg = torch.zeros((cfg.feature_dim,), dtype=torch.float32, device=dev)
    with tracing.span("gad.render", device=dev):
        if binned:
            feat_map, _alpha = rasterize_binned(
                geom["means"], geom["quats"], geom["scales"], geom["opacities"],
                state.features, batch["viewmat"], batch["K"],
                batch["inst_gid"], batch["tile_starts"], batch["tile_counts"],
                width, height, background=bg, config=cfg.raster,
                order=batch["order"], red_slot=batch["red_slot"],
                red_rank=batch["red_rank"], red_block=batch["red_block"],
            )
            overflow = torch.zeros((), dtype=torch.int32, device=dev)  # checked at cache build
        else:
            res = rasterize(geom["means"], geom["quats"], geom["scales"], geom["opacities"],
                            state.features, batch["viewmat"], batch["K"], width, height,
                            background=bg, config=cfg.raster, device=dev)
            feat_map, overflow = res.image, res.overflow
    l1_feature, ent, regvar, scale_px = _supervision_losses(
        cfg, state.decoder, state.scale_decoder, feat_map, batch)
    total = l1_feature + entropy_w * ent + regionvar_w * regvar
    return total, _metrics(total, l1_feature, ent, regvar, scale_px, overflow)


def make_train_step(width: int, height: int, cfg: GadConfig):
    """step(state, geom, batch, entropy_w, regionvar_w) → (state, metrics),
    binning the camera inside the step. `geom`: `frozen_geometry` tensors;
    `batch`: viewmat (4, 4), K (3, 3), img_embed (M, clip_dim), seg_map
    (H, W, 4) int32, all on the state's device. Updates `state` in place."""
    def step(state: TrainState, geom, batch, entropy_w: float, regionvar_w: float):
        total, metrics = camera_loss(state, geom, batch, entropy_w, regionvar_w,
                                     width, height, cfg)
        _apply(state, total)
        return state, metrics

    return step


def make_train_step_binned(width: int, height: int, cfg: GadConfig):
    """The train step over a cached per-camera binning: the batch also
    holds inst_gid, tile_starts, tile_counts, order, red_slot, red_rank
    and red_block from `rasterizer.prepare_binning` (frozen geometry: a
    camera's binning never changes). Updates `state` in place."""
    def step(state: TrainState, geom, batch, entropy_w: float, regionvar_w: float):
        total, metrics = camera_loss(state, geom, batch, entropy_w, regionvar_w,
                                     width, height, cfg, binned=True)
        _apply(state, total)
        return state, metrics

    return step


def make_eval_step(width: int, height: int, cfg: GadConfig):
    """Held-out evaluation: the train losses without gradients, on the
    unaligned (forward-only) layout; returns (metrics, scale_map)."""
    raster_fwd = dataclasses.replace(cfg.raster, aligned=False)

    @torch.no_grad()
    def eval_step(state: TrainState, geom, batch):
        dev = state.device
        bg = torch.zeros((cfg.feature_dim,), dtype=torch.float32, device=dev)
        res = rasterize(geom["means"], geom["quats"], geom["scales"], geom["opacities"],
                        state.features, batch["viewmat"], batch["K"], width, height,
                        background=bg, config=raster_fwd, device=dev)
        feat_map = res.image
        scale_map = _scale_map_fn(cfg, state.scale_decoder, feat_map)
        seg_mixed = mixed_seg_map(batch["seg_map"], scale_map)
        gt_map, mask = blend_gt_feature_map(batch["img_embed"], batch["seg_map"], scale_map)
        maskf = mask.to(torch.float32)
        with _decoder_precision(cfg, dev):
            decoded = state.decoder(feat_map).float()
        l1_pix = losses.l1_map(decoded * maskf, gt_map * maskf)
        metrics = dict(
            l1_feature=losses.region_balanced_l1(l1_pix, seg_mixed, cfg.max_segments),
            l1_pixel_mean=torch.sum(l1_pix * maskf[..., 0]) / torch.clamp_min(maskf.sum(), 1.0),
            region_var=losses.region_variance_loss(feat_map, seg_mixed, cfg.max_segments),
        )
        return metrics, scale_map

    return eval_step


@torch.no_grad()
def render_feature_map(geometry: GaussianScene, state: TrainState, viewmat, K,
                       width: int, height: int, cfg: GadConfig, decode: bool = False):
    """Inference helper: the F-dim map (optionally decoded to CLIP space)."""
    dev = state.device
    res = rasterize(geometry.means, geometry.quats, geometry.scales, geometry.opacities,
                    state.features, viewmat, K, width, height,
                    background=torch.zeros((cfg.feature_dim,), dtype=torch.float32, device=dev),
                    config=dataclasses.replace(cfg.raster, aligned=False), device=dev)
    if not decode:
        return res.image
    return state.decoder(res.image)

