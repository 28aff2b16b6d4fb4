"""gags_torch.utils.lpips and gags_torch.cli.metrics against gags_tpu.

The three LPIPS nets load one torchvision-layout state dict (the random
towers of tests/test_lpips_parity.py, whose builders and reference
forward are reused) through both packages' converters: the port within
rtol 1e-6 of that torch reference forward and within rtol 2e-4 of the
JAX LPIPS (the JAX package's own parity tolerance). The metrics CLI on a
tmp_path tree writes results.json / per_view.json equal to JAX's
evaluate_dir (PSNR, SSIM rtol 1e-5; LPIPS rtol 2e-4), and runs without PIL."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.nn as tnn

from gags_tpu.utils.lpips import LPIPS as JLPIPS
from gags_tpu.utils.lpips import convert_lpips_weights as jconvert
from gags_torch.cli import metrics as metrics_cli
from gags_torch.utils.image import encode_png
from gags_torch.utils.lpips import LPIPS, convert_lpips_weights, lpips_from_checkpoints

from test_lpips_parity import _BUILDERS, _MEAN, _STD, _torch_lpips

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _random_net(net_type, size, seed=0):
    """(features, target layers, linear heads, feat_state, lin_state)."""
    torch.manual_seed(seed)
    features, target_layers = _BUILDERS[net_type]()
    x = torch.rand(1, 3, size, size)
    n_ch = []
    with torch.no_grad():
        h = (x - _MEAN) / _STD
        for i, layer in enumerate(features, 1):
            h = layer(h)
            if i in target_layers:
                n_ch.append(h.shape[1])
    lins = [tnn.Conv2d(c, 1, 1, bias=False) for c in n_ch]
    feat_state = {f"features.{k}": v for k, v in features.state_dict().items()}
    lin_state = {f"lin{i}.model.1.weight": lin.weight.detach() for i, lin in enumerate(lins)}
    return features, target_layers, lins, feat_state, lin_state


@pytest.mark.parametrize("net_type", ["vgg", "alex", "squeeze"])
def test_lpips_matches_reference_and_jax(net_type):
    size = 64 if net_type == "vgg" else 96  # alex / squeeze stride-4 / 2 stems
    features, target_layers, lins, feat_state, lin_state = _random_net(net_type, size)
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 1, (size, size, 3)).astype(np.float32)
    b = rng.uniform(0, 1, (size, size, 3)).astype(np.float32)
    model = LPIPS(net_type)
    model.load_state_dict(convert_lpips_weights(feat_state, lin_state, net_type))
    with torch.no_grad():
        got = float(model(torch.from_numpy(a), torch.from_numpy(b)))
        ref = float(_torch_lpips(features, target_layers, lins,
                                 torch.from_numpy(a).permute(2, 0, 1)[None],
                                 torch.from_numpy(b).permute(2, 0, 1)[None]))
    want = float(jax.jit(JLPIPS(net_type=net_type).apply)(
        jconvert(feat_state, lin_state, net_type), a, b))
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6)


def _write_tree(model, rng, size=64):
    """<model>/test/ours_{3,7}/{renders,gt}/*.png, three views each."""
    for method in ("ours_3", "ours_7"):
        for sub in ("renders", "gt"):
            os.makedirs(os.path.join(model, "test", method, sub))
        for v in range(3):
            gt = rng.uniform(0, 1, (size, size + 8, 3))
            render = np.clip(gt + rng.normal(0, 0.1, gt.shape), 0, 1)
            for sub, img in (("renders", render), ("gt", gt)):
                with open(os.path.join(model, "test", method, sub, f"{v:05d}.png"), "wb") as f:
                    f.write(encode_png(img))
    os.makedirs(os.path.join(model, "test", "not_a_method"))


def test_metrics_cli_matches_jax_evaluate_dir(tmp_path):
    from gags_tpu.cli.metrics import evaluate_dir

    model = str(tmp_path / "model")
    _write_tree(model, np.random.default_rng(0))
    _, _, _, feat_state, lin_state = _random_net("vgg", 64)
    torch.save(feat_state, tmp_path / "vgg.pth")
    torch.save(lin_state, tmp_path / "lin.pth")
    metrics_cli.main(["-m", model, "--vgg_ckpt", str(tmp_path / "vgg.pth"),
                      "--lpips_lin_ckpt", str(tmp_path / "lin.pth"), "--device", "cpu"])
    results = json.load(open(os.path.join(model, "results.json")))
    per_view = json.load(open(os.path.join(model, "per_view.json")))
    assert list(results) == list(per_view) == ["ours_3", "ours_7"]
    jmodel = JLPIPS(net_type="vgg")
    jparams = jconvert(feat_state, lin_state, "vgg")
    jfn = jax.jit(lambda a, b: jmodel.apply(jparams, a, b))
    for method in results:
        jsum, jview = evaluate_dir(os.path.join(model, "test", method), jfn)
        assert list(results[method]) == list(jsum) == ["PSNR", "SSIM", "LPIPS"]
        for key, rtol in (("PSNR", 1e-5), ("SSIM", 1e-5), ("LPIPS", 2e-4)):
            assert list(per_view[method][key]) == list(jview[key])
            np.testing.assert_allclose(list(per_view[method][key].values()),
                                       list(jview[key].values()), rtol=rtol, err_msg=key)
            np.testing.assert_allclose(results[method][key], jsum[key], rtol=rtol, err_msg=key)
    # the loaded metric is the converted one
    m = lpips_from_checkpoints(str(tmp_path / "vgg.pth"), str(tmp_path / "lin.pth"))
    assert not m.training and torch.equal(m.lin0, lin_state["lin0.model.1.weight"].reshape(-1))


def test_metrics_cli_runs_without_pil(tmp_path):
    """PSNR / SSIM only (no LPIPS files): results.json without LPIPS, the
    same numbers as in-process, with PIL unimportable."""
    model = str(tmp_path / "model")
    _write_tree(model, np.random.default_rng(1), size=32)
    code = ("import sys\nsys.modules['PIL'] = None\n"
            "from gags_torch.cli.metrics import main\n"
            f"main(['-m', {model!r}, '--device', 'cpu'])\n"
            "assert 'PIL' not in sys.modules or sys.modules['PIL'] is None\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    results = json.load(open(os.path.join(model, "results.json")))
    assert set(results["ours_3"]) == {"PSNR", "SSIM"}
    summary, _ = metrics_cli.evaluate_dir(os.path.join(model, "test", "ours_3"), device="cpu")
    assert summary == results["ours_3"]


def test_metrics_cli_reads_jpeg_ground_truth_as_jax_does(tmp_path):
    """JPEG images (datasets ship their ground truth so): PSNR and SSIM of
    the port's CLI equal the JAX package's evaluate_dir, which reads
    through PIL."""
    from PIL import Image

    from gags_tpu.cli.metrics import evaluate_dir

    model = str(tmp_path / "model")
    _write_tree(model, np.random.default_rng(2), size=24)
    method = os.path.join(model, "test", "ours_3")
    for sub in ("gt", "renders"):
        for name in os.listdir(os.path.join(method, sub)):
            png = os.path.join(method, sub, name)
            Image.open(png).save(png[:-4] + ".jpg", quality=85)
            os.remove(png)
    summary, per_view = metrics_cli.evaluate_dir(method, device="cpu")
    jsum, jview = evaluate_dir(method)
    for key in ("PSNR", "SSIM"):
        assert list(per_view[key]) == list(jview[key]) == ["00000.jpg", "00001.jpg", "00002.jpg"]
        np.testing.assert_allclose(list(per_view[key].values()), list(jview[key].values()),
                                   rtol=1e-5, err_msg=key)
