"""Precompute CLIP text embeddings for the server and query tools (port of
gags_tpu.cli.encode_text).

  python -m gags_torch.cli.encode_text --clip_ckpt ViT-B-16.pt --bpe vocab.gz \
      --labels "sheep,bear,teapot" -o embeds.npz [--device cpu]

Writes an npz with 'labels', 'pos' (L, 512) and 'neg' (4, 512) unit-norm
embeddings (negatives: object / things / stuff / texture), the file
`gags_torch.cli.serve --text_embeds` reads. The checkpoint and the BPE
merges file are the user's (none ships with the repository).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from gags_torch import resolve_device
from gags_torch.models.clip import CLIPConfig, load_openclip_checkpoint
from gags_torch.models.tokenizer import ClipTokenizer
from gags_torch.query.relevancy import DEFAULT_NEGATIVES


def run(clip_ckpt: str, labels: Sequence[str], output: str, bpe: Optional[str] = None,
        clip_cfg: Optional[CLIPConfig] = None, device="cuda") -> dict:
    """Embed `labels` and the default negatives; write and return
    {labels, pos, neg}."""
    dev = resolve_device(device)
    # true float32 on the card, as the parity tests hold the CPU to the JAX package
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, _ = load_openclip_checkpoint(clip_ckpt, clip_cfg, device=dev)
    tok = ClipTokenizer(bpe or None)

    @torch.no_grad()
    def embed(texts):
        e = model.encode_text(torch.as_tensor(tok(texts), device=dev)).cpu().numpy()
        return e / np.linalg.norm(e, axis=-1, keepdims=True)

    out = dict(labels=np.array(list(labels)), pos=embed(list(labels)),
               neg=embed(list(DEFAULT_NEGATIVES)))
    np.savez(output, **out)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--clip_ckpt", required=True)
    p.add_argument("--bpe", default="")
    p.add_argument("--labels", required=True, help="comma-separated prompts")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    labels = [s.strip() for s in a.labels.split(",") if s.strip()]
    run(a.clip_ckpt, labels, a.output, a.bpe or None, device=a.device)
    print(f"wrote {a.output}: {len(labels)} prompts + {len(DEFAULT_NEGATIVES)} negatives")


if __name__ == "__main__":
    main()
