"""gags_torch.cli.train_gad with --devices: two gloo ranks on the CPU
against one process that accumulates the same two cameras' gradients,
halves them and takes the three Adam steps; rank 0 alone writes; and the
NCCL backend refused with fewer cards than ranks."""

import os

import numpy as np
import pytest
import torch

from gags_torch.cli.train_gad import RunConfig, _bin_cache, run
from gags_torch.gad import train as ttrain
from gags_torch.gad.data import GadDataset
from gags_torch.scene.dataset import detect_and_load
from gags_torch.scene.gaussian_data import GaussianScene

from test_torch_train_cli import _cfg, build_fixture


class StepLog:
    """A picklable on_step: appends each call's iteration to a file."""

    def __init__(self, path):
        self.path = path

    def __call__(self, it, state, metrics):
        with open(self.path, "a") as f:
            f.write(f"{it} {os.getpid()}\n")


def _one_process_step(root, ply, seed=0):
    """Iteration 1 of a two-rank run, in this process: the cameras
    order[0] and order[1] of the seeded epoch order, their gradients
    accumulated and halved, the three Adam steps."""
    cfg = _cfg()
    info = detect_and_load(root)
    ds = GadDataset(info.train_cameras, resolution=1)
    scene = GaussianScene.from_ply(ply, device="cpu")
    state = ttrain.create_train_state(scene, cfg, seed=seed, device="cpu")
    geom = ttrain.frozen_geometry(scene)
    cache, _ = _bin_cache(geom, ds, cfg, torch.device("cpu"))
    order = ds.epoch_order(np.random.default_rng(seed))
    ew, rw = ttrain.loss_weights(1, cfg)
    for i in order[:2]:
        batch = {k: torch.as_tensor(v) for k, v in ds.batch(int(i)).items()}
        batch.update(cache[int(i)])
        ttrain.camera_loss(state, geom, batch, ew, rw, ds.width, ds.height, cfg,
                           binned=True)[0].backward()
    params = [state.features] + list(state.decoder.parameters()) + list(
        state.scale_decoder.parameters())
    for p in params:
        p.grad /= 2
    for opt in (state.opt_feat, state.opt_dec, state.opt_scale):
        opt.step()
    return state


def test_train_gad_devices_2_matches_one_process(tmp_path):
    root, model = str(tmp_path / "scene"), str(tmp_path / "model")
    ply = build_fixture(root, n_cams=3)
    log = str(tmp_path / "steps.txt")
    rc = RunConfig(source_path=root, model_path=model, ply_path=ply, resolution=1,
                   iterations=3, save_iterations="1", test_iterations="", device="cpu",
                   devices=2, deadline=240)
    state = run(rc, _cfg(), on_step=StepLog(log))
    assert state.step == 3 and state.features.device.type == "cpu"
    # on_step ran on rank 0 only: each iteration once, from one process
    lines = [line.split() for line in open(log)]
    assert [int(it) for it, _ in lines] == [0, 1, 2, 3] and len({pid for _, pid in lines}) == 1
    assert sorted(os.listdir(model)) == sorted(
        ["cameras.json", "cfg.json", "gad_cfg.json", "chkpnt1", "chkpnt3", "decoders.pt",
         "metrics.jsonl", "point_cloud"] + [n for n in os.listdir(model) if "tfevents" in n])
    assert sorted(os.listdir(os.path.join(model, "point_cloud"))) == ["iteration_1",
                                                                      "iteration_3"]
    blob = torch.load(os.path.join(model, "chkpnt1", "state.pt"), weights_only=True)
    assert blob["step"] == 1
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks run: the same sums in the same order
    try:
        want = _one_process_step(root, ply)
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(blob["features"], want.features.detach())
    for key, module in (("decoder", want.decoder), ("scale_decoder", want.scale_decoder)):
        for name, t in module.state_dict().items():
            assert torch.equal(blob[key][name], t), name
    torch.testing.assert_close(state.features.detach(),
                               torch.load(os.path.join(model, "chkpnt3", "state.pt"),
                                          weights_only=True)["features"], rtol=0, atol=0)


def test_train_gad_devices_nccl_needs_a_card_a_rank(tmp_path):
    """NCCL takes one card a rank: with fewer cards the run raises naming
    both counts before anything starts."""
    rc = RunConfig(source_path=str(tmp_path), model_path=str(tmp_path / "m"), ply_path="x.ply",
                   devices=2, device="cuda", dist_backend="nccl")
    cards = torch.cuda.device_count()
    if cards >= 2:
        pytest.skip(f"{cards} CUDA devices: enough for two NCCL ranks")
    with pytest.raises(RuntimeError, match=rf"2 ranks over nccl .* only {cards} CUDA devices"):
        run(rc)
    assert not os.path.exists(tmp_path / "m")
