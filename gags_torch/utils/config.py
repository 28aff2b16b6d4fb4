"""Dataclass config system with JSON round-trip (a copy of
gags_tpu.utils.config).

The "model dir carries its config" convention: training writes `cfg.json`
into the model dir and downstream tools rehydrate from it, with CLI
overrides merged on top.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Any, Type, TypeVar, get_type_hints

T = TypeVar("T")


def save_config(cfg: Any, model_dir: str, name: str = "cfg.json") -> str:
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, name)
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)
    return path


def load_config(cls: Type[T], model_dir: str, name: str = "cfg.json", **overrides) -> T:
    path = os.path.join(model_dir, name)
    data = {}
    if os.path.exists(path):
        with open(path) as f:
            data = json.load(f)
    data.update({k: v for k, v in overrides.items() if v is not None})
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in data.items() if k in fields})


def add_dataclass_args(parser: argparse.ArgumentParser, cls: Type, prefix: str = "") -> None:
    """Auto-generate --flags from dataclass fields (bool → store_true pairs)."""
    hints = get_type_hints(cls)
    for f in dataclasses.fields(cls):
        t = hints.get(f.name, str)
        flag = f"--{prefix}{f.name}"
        if t is bool:
            parser.add_argument(flag, action="store_true", default=None)
            parser.add_argument(
                f"--no_{prefix}{f.name}", dest=f.name, action="store_false", default=None
            )
        elif t in (int, float, str):
            parser.add_argument(flag, type=t, default=None)
        # nested dataclasses / complex types are configured via cfg.json


def collect_overrides(args: argparse.Namespace, cls: Type) -> dict:
    fields = {f.name for f in dataclasses.fields(cls)}
    return {
        k: v for k, v in vars(args).items() if k in fields and v is not None
    }
