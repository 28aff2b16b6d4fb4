"""Training observability: JSONL metrics + EMA progress + optional
TensorBoard (a copy of gags_tpu.utils.logging).

The primary sink is a JSONL file (greppable, no dependencies);
TensorBoard is attached when torch's SummaryWriter imports.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict


class MetricsWriter:
    def __init__(self, model_dir: str, filename: str = "metrics.jsonl"):
        os.makedirs(model_dir, exist_ok=True)
        self.path = os.path.join(model_dir, filename)
        self._f = open(self.path, "a", buffering=1)
        self._tb = None
        try:  # optional TensorBoard (torch ships one)
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(model_dir)
        except Exception:
            pass

    def write(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), step)

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()


class EmaProgress:
    """EMA-smoothed loss progress line (reference train.py:179-182)."""

    def __init__(self, total: int, print_every: int = 10):
        self.total = total
        self.print_every = print_every
        self.ema = 0.0
        self.t0 = time.time()

    def update(self, step: int, loss: float) -> None:
        self.ema = 0.4 * loss + 0.6 * self.ema
        if step % self.print_every == 0:
            rate = step / max(time.time() - self.t0, 1e-9)
            sys.stdout.write(
                f"\r[{step}/{self.total}] loss={self.ema:.7f} {rate:.1f} it/s   "
            )
            sys.stdout.flush()
        if step == self.total:
            sys.stdout.write("\n")
