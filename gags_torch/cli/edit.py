"""Scene editing CLI: apply an edit_*.yaml config to a trained scene (port
of gags_tpu.cli.edit).

  python -m gags_torch.cli.edit -m <model> --config edit.yaml \
      --text_embeds objects.npz [--iteration 30000] [-o edited.ply] [--device cuda]

The model dir is read by `cli.relevancy.load_query_model`; objects.npz
(cli/encode_text) holds 'labels' and 'pos' covering the config's
objects. The edited Gaussian PLY goes to -o, or to
<model>/edits/<operation>_<targets>.ply.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from gags_torch import resolve_device
from gags_torch.cli.relevancy import load_query_model
from gags_torch.query.edit import EditConfig, apply_edit, parse_color_func, select_by_text
from gags_torch.query.grounding import decode_features_chunked


@torch.no_grad()
def run(model_path: str, cfg: EditConfig, text_embeds: str, iteration: int = 30000,
        output: Optional[str] = None, device="cuda") -> dict:
    """Select, edit, write; returns {selected, n_in, n_out, path, mask}."""
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False  # decode and similarity in full float32
    scene, decoder = load_query_model(model_path, iteration, dev)
    data = np.load(text_embeds)
    labels = [str(l) for l in data["labels"]]
    embeds = torch.as_tensor(data["pos"][[labels.index(o) for o in cfg.objects]], device=dev)
    decoded = decode_features_chunked(decoder, scene.semantic_features)
    target_ids = [cfg.objects.index(t) for t in cfg.targets]
    mask = select_by_text(decoded, embeds, target_ids, cfg.threshold)
    selected = int(mask.sum())
    print(f"selected {selected}/{scene.num_gaussians} gaussians for {cfg.targets}")
    color_fn = parse_color_func(cfg.color_func) if cfg.operation == "color_func" else None
    edited = apply_edit(scene, mask, cfg.operation, color_fn)
    out = output or os.path.join(model_path, "edits",
                                 f"{cfg.operation}_{'_'.join(cfg.targets)}.ply")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    edited.save_ply(out)
    print(f"wrote {out} ({edited.num_gaussians} gaussians)")
    return dict(selected=selected, n_in=scene.num_gaussians, n_out=edited.num_gaussians,
                path=out, mask=mask.cpu().numpy())


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-m", "--model_path", required=True)
    p.add_argument("--config", required=True)
    p.add_argument("--text_embeds", required=True)
    p.add_argument("--iteration", type=int, default=30000)
    p.add_argument("-o", "--output", default="")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    run(a.model_path, EditConfig.from_yaml(a.config), a.text_embeds, a.iteration,
        a.output or None, a.device)


if __name__ == "__main__":
    main()
