"""The port stands alone: no JAX, no gags_tpu, and no silent CPU fallback."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "gags_tpu"}


def _port_files():
    files = sorted((ROOT / "gags_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    return files


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


def test_no_jax_imports_in_port():
    bad = {
        str(p.relative_to(ROOT)): sorted(set(_imported_roots(p)) & FORBIDDEN)
        for p in _port_files()
    }
    assert not {k: v for k, v in bad.items() if v}


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'gags_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import gags_torch.cli.serve, gags_torch.splat.render, gags_torch.splat.kernels\n"
        "import gags_torch.query, gags_torch.models.weights, gags_torch.utils.synthetic\n"
        "import gags_torch.cli.train_gad, gags_torch.gad.checkpoints\n"
        "import gags_torch.cli.train_rgb, gags_torch.rgb.train, gags_torch.knn\n"
        "import gags_torch.scene.densify, gags_torch.utils.metrics\n"
        "import gags_torch.cli.render, gags_torch.splat.autotune, gags_torch.utils.timing\n"
        "import gags_torch.cli.relevancy, gags_torch.cli.evaluate, gags_torch.cli.edit\n"
        "import gags_torch.query.clip_editor, gags_torch.query.alpha_encoder\n"
        "import gags_torch.utils.pcd, gags_torch.utils.pose_paths, gags_torch.utils.video\n"
        "import gags_torch.probes.vpu_probe, gags_torch.probes.slab_probe\n"
        "import gags_torch.gad.interop, gags_torch.gad.autotune, gags_torch.utils.lpips\n"
        "import gags_torch.utils.viewer, gags_torch.utils._surface_scene\n"
        "import gags_torch.cli.metrics, gags_torch.cli.convert, gags_torch.cli.visualize_prompts\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _tiny():
    from gags_torch.models.decoders import FeatureDecoder
    from gags_torch.models.weights import scene_from_arrays
    from gags_torch.utils.synthetic import make_camera, make_scene

    raw = make_scene(10, seed=0)
    scene = scene_from_arrays(
        raw["means"], raw["quats"], np.log(raw["scales"]),
        np.log(raw["opacities"] / (1 - raw["opacities"])), raw["sh"],
        semantic_features=raw["features"],
    )
    return raw, scene, FeatureDecoder(), make_camera(32, 16)


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    from gags_torch import resolve_device
    from gags_torch.cli.serve import SceneServer, load_server, main
    from gags_torch.splat.rasterizer import rasterize
    from gags_torch.splat.render import render

    raw, scene, dec, cam = _tiny()
    t = {k: torch.as_tensor(v) for k, v in raw.items()}
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        rasterize(t["means"], t["quats"], t["scales"], t["opacities"], t["features"],
                  cam.viewmat, cam.K, 32, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        render(cam, means=t["means"], quats=t["quats"], scales=t["scales"],
               opacities=t["opacities"], semantic_features=t["features"], feature_mode=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        SceneServer(scene, dec)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_server("/nonexistent", 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["-m", "/nonexistent"])
    from gags_torch.cli import render as render_cli
    from gags_torch.splat.rasterizer import rasterize_exit_stats

    with pytest.raises(RuntimeError, match="CUDA"):
        render_cli.run("/nonexistent", "/nonexistent")
    with pytest.raises(RuntimeError, match="CUDA"):
        rasterize_exit_stats(t["means"], t["quats"], t["scales"], t["opacities"],
                             t["features"], cam.viewmat, cam.K, 32, 16)
    from gags_torch.cli import metrics as metrics_cli
    from gags_torch.gad.interop import load_reference_checkpoint

    with pytest.raises(RuntimeError, match="CUDA"):
        metrics_cli.run(["/nonexistent"])
    with pytest.raises(RuntimeError, match="CUDA"):
        load_reference_checkpoint("/nonexistent.pth")
    # the CPU is taken only when asked for
    out = rasterize(t["means"], t["quats"], t["scales"], t["opacities"], t["features"],
                    cam.viewmat, cam.K, 32, 16, device="cpu")
    assert out.image.device.type == "cpu"
