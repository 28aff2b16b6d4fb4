"""On-device autotuning of the GAD train step (port of gags_tpu.gad.autotune).

Which of two numerically equivalent step variants runs faster is a
question for the device at hand, so the trainer can time them for a few
steps on the running device and train with the faster one. The JAX
package times four combinations of two switches; in the port one of them
runs the same code either way:

  * `fused_supervision`: the feature decoder's normalisation, the
    supervision blend, mask and L1 as one autograd Function whose
    residuals are its raw inputs (same math; on CUDA the kernel J6) —
    a candidate;
  * `raster.fast_fwd_aligned`: kept only so JAX configs load; an aligned
    binning always launches K1 (`splat/rasterizer.py`), so flipping it
    times the same step twice — not a candidate.

Each candidate runs one step from the same starting state and must land
within `loss_rtol` of the base step's loss, finite; then it is timed.
Only that gate rejects a candidate: an exception (a kernel that fails to
build or launch) propagates. The port's step updates the state in place
(features, both decoders, three Adam states), so each candidate runs on
its own deep copy of the state: the trainer's state is never touched.
"""

from __future__ import annotations

import copy
import dataclasses
import sys
from typing import Dict, Optional, Tuple

import numpy as np

from gags_torch.gad.train import GadConfig, TrainState, make_train_step_binned
from gags_torch.utils.timing import device_time_drain

_DROPPED = ("raster.fast_fwd_aligned: not a candidate, an aligned binning always "
            "launches K1 whichever way it is set")


def cand_cfg_summary(cfg: GadConfig) -> str:
    return f"fsup={cfg.fused_supervision}"


def autotune_train_step(width: int, height: int, cfg: GadConfig, state: TrainState, geom,
                        batch, *, k: int = 8, loss_rtol: float = 1e-3, force: bool = False,
                        verbose: bool = True, times: Optional[Dict[str, float]] = None
                        ) -> Tuple[GadConfig, object]:
    """Return (winning GadConfig, its binned step). `batch` is one full
    training batch with the cached binning arrays, on the state's device.
    On the CPU timing means nothing: the base config is returned untimed
    unless `force` (tests). `state` is left as it was found. A `times`
    dict receives each timed candidate's seconds per step, by summary."""
    base_step = make_train_step_binned(width, height, cfg)
    if state.device.type == "cpu" and not force:
        return cfg, base_step
    ew, rw = cfg.entropy_w_early, 0.0

    def log(msg: str) -> None:
        if verbose:
            print(f"# train-autotune: {msg}", file=sys.stderr, flush=True)

    def trial(step):
        """(loss of one step, a closure timing further steps), both on one
        deep copy of `state`."""
        st = copy.deepcopy(state)
        loss = float(step(st, geom, batch, ew, rw)[1]["loss"])
        return loss, lambda: device_time_drain(lambda: step(st, geom, batch, ew, rw)[1]["loss"],
                                               k=k, warmup=2)

    log(_DROPPED)
    base_loss, base_timer = trial(base_step)
    best_cfg, best_step, best_t = cfg, base_step, base_timer()
    times = {} if times is None else times
    times[cand_cfg_summary(cfg)] = best_t
    log(f"base {cand_cfg_summary(cfg)} {best_t * 1e3:.3f} ms (loss {base_loss:.6f})")
    cand_cfg = dataclasses.replace(cfg, fused_supervision=not cfg.fused_supervision)
    cand_step = make_train_step_binned(width, height, cand_cfg)
    loss, timer = trial(cand_step)
    rel = abs(loss - base_loss) / (abs(base_loss) + 1e-12)
    if not (np.isfinite(loss) and rel <= loss_rtol):
        log(f"{cand_cfg_summary(cand_cfg)} loss drift {rel:.2e}: rejected")
    else:
        t = timer()
        times[cand_cfg_summary(cand_cfg)] = t
        log(f"{cand_cfg_summary(cand_cfg)} {t * 1e3:.3f} ms (loss {loss:.6f})")
        if t < best_t:
            best_cfg, best_step, best_t = cand_cfg, cand_step, t
    log(f"winner {cand_cfg_summary(best_cfg)} {best_t * 1e3:.3f} ms")
    return best_cfg, best_step
