"""CLIP BPE tokenizer (a copy of gags_tpu.models.tokenizer).

Standard byte-pair-encoding tokenizer matching CLIP/OpenCLIP semantics
(lowercase + whitespace-collapse cleaning, byte→unicode alphabet, merges
ranked by a vocab file, word-final `</w>`, <start_of_text>/<end_of_text>
wrapping, 77-token context with truncation-keeps-EOT).

The merge table itself (bpe_simple_vocab_16e6.txt.gz, ~1.3 MB) is not
shipped with the repository. Pass its path explicitly or set
GAGS_CLIP_BPE; without it, tokenizer construction raises and callers can
fall back to pre-tokenized prompts.
"""

from __future__ import annotations

import gzip
import html
import os
import re
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte → printable-unicode mapping (GPT-2/CLIP standard)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    text = re.sub(r"\s+", " ", text.strip())
    return text.lower()


_WORD_RE = re.compile(
    r"<start_of_text>|<end_of_text>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"
    if False
    else r"<start_of_text>|<end_of_text>|'s|'t|'re|'ve|'m|'ll|'d|[a-z]+|[0-9]|[^\sa-z0-9]+",
    re.IGNORECASE,
)


class ClipTokenizer:
    CONTEXT = 77

    def __init__(self, bpe_path: Optional[str] = None):
        bpe_path = bpe_path or os.environ.get("GAGS_CLIP_BPE")
        if not bpe_path or not os.path.exists(bpe_path):
            raise FileNotFoundError(
                "CLIP BPE merges file not found; set GAGS_CLIP_BPE or pass "
                "bpe_path (bpe_simple_vocab_16e6.txt.gz)"
            )
        if bpe_path.endswith(".gz"):
            with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
                merges = f.read().split("\n")
        else:
            with open(bpe_path, encoding="utf-8") as f:
                merges = f.read().split("\n")
        merges = merges[1 : 49152 - 256 - 2 + 1]
        merge_pairs = [tuple(m.split()) for m in merges]

        self.byte_encoder = bytes_to_unicode()
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(p) for p in merge_pairs)
        vocab.extend(["<start_of_text>", "<end_of_text>"])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {p: i for i, p in enumerate(merge_pairs)}
        self.sot = self.encoder["<start_of_text>"]
        self.eot = self.encoder["<end_of_text>"]
        self._cache: Dict[str, str] = {}

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word: Tuple[str, ...] = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
        if not pairs:
            return token + "</w>"
        while True:
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 30))
            if best not in self.bpe_ranks:
                break
            first, second = best
            out: List[str] = []
            i = 0
            while i < len(word):
                if (
                    i < len(word) - 1
                    and word[i] == first
                    and word[i + 1] == second
                ):
                    out.append(first + second)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = tuple(out)
            if len(word) == 1:
                break
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
        result = " ".join(word)
        self._cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in _WORD_RE.findall(_clean(text)):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(tok).split(" "))
        return ids

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        """(B, 77) int32 with SOT/EOT, zero padding, truncation keeps EOT."""
        out = np.zeros((len(texts), self.CONTEXT), np.int32)
        for i, t in enumerate(texts):
            ids = [self.sot] + self.encode(t) + [self.eot]
            if len(ids) > self.CONTEXT:
                ids = ids[: self.CONTEXT]
                ids[-1] = self.eot
            out[i, : len(ids)] = ids
        return out
