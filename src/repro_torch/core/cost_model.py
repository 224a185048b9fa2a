"""The per-tile workload record kernels declare (``repro/core/cost_model.py``).

Only :class:`TileWorkload` is ported: a Hopper estimator that turns it into
time, and the autotuner built on it, come with the plan compiler.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TileWorkload:
    """What one tile (one thread block's share) of a kernel does.

    ``row_segments`` is the number of distinct strided segments the tile
    reads/writes; ``row_stride_bytes`` is the stride between them.
    """

    flops: float                 # useful FLOPs in the tile
    hbm_bytes: float             # device-memory bytes moved (reads + writes)
    row_segments: int            # strided segment count
    row_stride_bytes: float      # stride between segments
    threads: int = 0             # threads per block
    pad_waste: float = 1.0       # >=1: padded work / useful work
