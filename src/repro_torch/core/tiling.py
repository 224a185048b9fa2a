"""Tile shapes and the constraint record a kernel's tile space is declared by.

The port's copy of ``repro/core/tiling.py`` (the part this slice needs). A
:class:`TileShape` is a tuple of block dims — on Hopper, the block a CUDA
thread block owns (e.g. ``(bm, bk, bn)`` for the GEMM) — and
:class:`TileConstraints` records the per-dim bounds and alignment a kernel
declares for it. Enumerating and sweeping tile spaces waits for the Hopper
estimator and autotuner.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

DTYPE_BYTES = {
    "float32": 4, "bfloat16": 2, "float16": 2, "int8": 1,
    "int32": 4, "uint8": 1, "float64": 8,
}


def dtype_bytes(dtype) -> int:
    """Bytes per element; accepts a name or a ``torch.dtype``."""
    return DTYPE_BYTES[str(dtype).replace("torch.", "")]


@dataclasses.dataclass(frozen=True, order=True)
class TileShape:
    """A block shape for one operand-tiling decision, e.g. (bm, bk, bn)."""

    dims: Tuple[int, ...]

    def __iter__(self):
        return iter(self.dims)

    def __getitem__(self, i):
        return self.dims[i]

    def __len__(self):
        return len(self.dims)

    @property
    def size(self) -> int:
        return math.prod(self.dims)

    def __str__(self) -> str:
        return "x".join(str(d) for d in self.dims)


@dataclasses.dataclass(frozen=True)
class TileConstraints:
    """Legality constraints for a kernel's tile space on given hardware.

    ``vmem_fraction`` is the share of the per-block fast memory
    (``HardwareModel.vmem_bytes``; shared memory on Hopper) a tile's working
    set may use.
    """

    rank: int
    # Per-dim upper bounds (problem dims; tiles never exceed the problem).
    max_dims: Tuple[int, ...]
    # Dims that feed the matrix unit want multiples of its width.
    mxu_dims: Tuple[int, ...] = ()
    # The minor (contiguous) dim index.
    lane_dim: Optional[int] = None
    # The second-minor dim index.
    sublane_dim: Optional[int] = None
    vmem_fraction: float = 0.5


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b

