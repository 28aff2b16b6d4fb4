"""gags_torch.gad.autotune.autotune_train_step on the CPU (force=True), after
tests/test_train_autotune.py: without force the base config comes back
untimed; the state after tuning equals the state before bit for bit; an
exception in a candidate's step propagates; a candidate off the loss gate
is rejected; the CLI's --autotune_train and --profile. The winner's
loss-equivalence and its JAX parity are test_torch_train_step.py's
test_autotune_returns_equivalent_step (it shares that file's JAX compile);
these tests need only the port's state."""

import copy

import numpy as np
import pytest
import torch

from gags_torch.gad import autotune
from gags_torch.gad.autotune import autotune_train_step

from test_torch_train_step import W, H, _port_parts


@pytest.fixture()
def parts():
    """The train-step tests' port set-up: a fresh state after one step."""
    return _port_parts()


def _state_tensors(state):
    """Every tensor of a TrainState, by name, cloned (Adam moments and step
    counts, gradients included)."""
    out = {"features": state.features.detach().clone(), "step": state.step}
    out["features.grad"] = None if state.features.grad is None else state.features.grad.clone()
    for name, mod in (("dec", state.decoder), ("scale", state.scale_decoder)):
        for k, p in mod.named_parameters():
            out[f"{name}.{k}"] = p.detach().clone()
            out[f"{name}.{k}.grad"] = None if p.grad is None else p.grad.clone()
    for name, opt in (("opt_feat", state.opt_feat), ("opt_dec", state.opt_dec),
                      ("opt_scale", state.opt_scale)):
        for i, p in enumerate(q for g in opt.param_groups for q in g["params"]):
            for k, v in opt.state.get(p, {}).items():
                out[f"{name}.{i}.{k}"] = v.clone()
    return out


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_cpu_skips_timing(parts):
    st, cfg = parts["tstate"], parts["tcfg"]
    times = {}
    win_cfg, _ = autotune_train_step(W, H, cfg, st, parts["tgeom"], parts["tbatch"],
                                     verbose=False, times=times)
    assert win_cfg == cfg and times == {}


def test_state_unchanged_bit_for_bit(parts):
    st, cfg = parts["tstate"], parts["tcfg"]
    parts["tstep"](st, cfg.entropy_w_early, 0.0)  # gradients and moments in place
    before = _state_tensors(st)
    twin = copy.deepcopy(st)
    autotune_train_step(W, H, cfg, st, parts["tgeom"], parts["tbatch"], k=2, force=True,
                        verbose=False)
    _assert_same(_state_tensors(st), before)
    # the trainer's next step from the restored state equals one from an untuned twin
    _, m = parts["tstep"](st, 2e-3, 0.1)
    _, mt = parts["tstep"](twin, 2e-3, 0.1)
    assert float(m["loss"]) == float(mt["loss"])
    _assert_same(_state_tensors(st), _state_tensors(twin))


def test_candidate_exception_propagates(parts, monkeypatch):
    real = autotune.make_train_step_binned

    def failing(width, height, cfg):
        if cfg.fused_supervision != parts["tcfg"].fused_supervision:
            def step(*a):
                raise RuntimeError("kernel failed to launch")
            return step
        return real(width, height, cfg)

    monkeypatch.setattr(autotune, "make_train_step_binned", failing)
    with pytest.raises(RuntimeError, match="kernel failed to launch"):
        autotune_train_step(W, H, parts["tcfg"], parts["tstate"], parts["tgeom"],
                            parts["tbatch"], k=1, force=True, verbose=False)


def test_candidate_off_the_loss_gate_is_rejected(parts, monkeypatch):
    real = autotune.make_train_step_binned

    def drifting(width, height, cfg):
        step = real(width, height, cfg)
        if cfg.fused_supervision == parts["tcfg"].fused_supervision:
            return step

        def wrapped(*a):
            s, m = step(*a)
            return s, {**m, "loss": m["loss"] * 1.01}
        return wrapped

    monkeypatch.setattr(autotune, "make_train_step_binned", drifting)
    times = {}
    win_cfg, _ = autotune_train_step(W, H, parts["tcfg"], parts["tstate"], parts["tgeom"],
                                     parts["tbatch"], k=1, force=True, verbose=False,
                                     times=times)
    assert win_cfg == parts["tcfg"] and list(times) == ["fsup=True"]


def test_train_cli_autotune_and_profile(tmp_path):
    """--autotune_train on the CPU keeps the base config untimed and saves
    it; --profile writes a Chrome trace of iterations 50-60 (reached in
    12 steps from a reference 13-tuple warm start at iteration 48)."""
    import json
    import os

    from gags_torch.cli.train_gad import RunConfig, run
    from gags_torch.gad.train import GadConfig
    from gags_torch.utils.synthetic import make_scene

    from test_torch_interop import N_FIX, _capture
    from test_torch_train_cli import build_fixture, _cfg

    root, model = str(tmp_path / "scene"), str(tmp_path / "model")
    build_fixture(root)
    ck = str(tmp_path / "chkpnt48.pth")
    feats = np.zeros((N_FIX, 8), np.float32)
    torch.save((_capture(make_scene(N_FIX, seed=3), feats), 48), ck)
    seen = []
    rc = RunConfig(source_path=root, model_path=model, start_checkpoint=ck, resolution=1,
                   iterations=60, save_iterations="", test_iterations="", profile=True,
                   autotune_train=True, device="cpu")
    run(rc, _cfg(), on_step=lambda it, st, m: seen.append(it))
    assert seen == list(range(48, 61))
    assert GadConfig.load(model) == _cfg()
    tuned = json.load(open(os.path.join(model, "train_autotune.json")))
    assert tuned == {"times_ms": {}, "winner": "fsup=True"}
    trace = json.load(open(os.path.join(model, "profile", "trace_iter50-60.json")))
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
