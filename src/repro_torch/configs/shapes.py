"""The four assigned input shapes. Each (arch x shape) cell is a dry-run unit.

``train_*`` lowers train_step; ``prefill_*`` lowers the serve prefill;
``decode_*``/``long_*`` lower serve_step (one new token against a KV cache of
``seq_len``). ``long_500k`` requires sub-quadratic attention
(cfg.subquadratic); pure full-attention archs skip it (DESIGN.md §5).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")

SHAPES: Tuple[ShapeSpec, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def get_shape(name: str) -> ShapeSpec:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}; known: {[s.name for s in SHAPES]}")


def applicable(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """(runs?, reason-if-skipped) per the assignment rules."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, (
            f"{cfg.name} has full-attention layers; 500k-KV decode is "
            "quadratic-cost — skipped per shape definition (DESIGN.md §5)"
        )
    return True, ""
