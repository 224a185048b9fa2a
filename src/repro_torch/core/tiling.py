"""Tile shapes and the constraint system that filters candidate tilings.

The port's copy of ``repro/core/tiling.py``. A :class:`TileShape` is a tuple
of block dims — on Hopper, the block a CUDA thread block owns (e.g.
``(bm, bk, bn)`` for the GEMM); :class:`TileConstraints` records the per-dim
bounds and alignment a kernel declares for it, and :func:`enumerate_tiles`
generates the legal candidate space the autotuner sweeps — the tile axis of
the paper's Fig. 3. A kernel makes a tile it cannot launch illegal by giving
it an infinite working set (``KernelSpec.vmem_bytes``).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import TYPE_CHECKING, List, Optional, Sequence, Tuple

if TYPE_CHECKING:
    from repro_torch.core.hardware import HardwareModel

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
    # Per-dim floors of the sweep: smaller tiles may launch, but are not
    # candidates (unless the problem dim itself is smaller).
    min_dims: Tuple[int, ...] = ()

    def alignment(self, hw: "HardwareModel", dtype: str, dim_index: int) -> int:
        if dim_index == self.lane_dim:
            return hw.lane_count
        if dim_index == self.sublane_dim:
            return hw.sublane[dtype] if dtype in ("float32", "bfloat16") else 8
        if dim_index in self.mxu_dims:
            return hw.mxu_dim
        return 1


def _candidates_for_dim(limit: int, align: int) -> List[int]:
    """Powers-of-two multiples of ``align`` up to ``limit`` (plus limit itself)."""
    out = []
    v = align
    while v < limit:
        out.append(v)
        v *= 2
    out.append(limit)
    return list(dict.fromkeys(out))


def enumerate_tiles(
    constraints: TileConstraints,
    hw: "HardwareModel",
    dtype: str,
    vmem_bytes_fn,
    max_candidates: int = 512,
) -> List[TileShape]:
    """Generate the legal tile space — the sweep axis of the paper's Fig. 3.

    ``vmem_bytes_fn(tile)`` gives the tile's working set (shared memory per
    block on Hopper); candidates over ``hw.vmem_bytes * vmem_fraction`` are
    discarded, as the paper discards blocks over 512 threads.
    """
    axes: List[List[int]] = []
    for i in range(constraints.rank):
        align = constraints.alignment(hw, dtype, i)
        if i < len(constraints.min_dims):
            align = max(align, constraints.min_dims[i])
        limit = constraints.max_dims[i]
        axes.append([limit] if limit <= align
                    else _candidates_for_dim(limit, align))

    budget = hw.vmem_bytes * constraints.vmem_fraction
    tiles = [TileShape(tuple(dims)) for dims in itertools.product(*axes)]
    tiles = [t for t in tiles if vmem_bytes_fn(t) <= budget]
    # Prefer larger tiles first (fewer blocks) as the tie-break ordering.
    tiles.sort(key=lambda t: (-t.size, t.dims))
    return tiles[:max_candidates]


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b



def padded_extent(extent: int, tile: int) -> int:
    """Problem extent after padding to a whole number of tiles."""
    return cdiv(extent, tile) * tile


def grid_for(shape: Sequence[int], tile: TileShape) -> Tuple[int, ...]:
    assert len(shape) == len(tile)
    return tuple(cdiv(s, t) for s, t in zip(shape, tile))
