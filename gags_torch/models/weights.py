"""Carry parameters into the port: flax decoder parameters (as numpy
arrays) → torch state dicts, raw Gaussian arrays → GaussianScene
(`scene_from_arrays`, defined beside GaussianScene), a JAX GAD train
state → the port's (`load_jax_train_state`), a JAX RGB pretraining state
→ the port's (`load_jax_rgb_state`), and the `decoders.pt` file that
`cli.serve.load_server` reads."""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from gags_torch.scene.gaussian_data import scene_from_arrays

__all__ = ["decoder_state_from_flax", "scene_from_arrays", "save_decoders",
           "load_decoder_state", "load_jax_train_state", "load_jax_rgb_state"]


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
