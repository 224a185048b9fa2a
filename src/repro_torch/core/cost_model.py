"""Analytic tile cost model: the reference's GPU estimator, extended to Hopper.

The port's copy of ``repro/core/cost_model.py``. Every descriptor of the
port is a GPU, so only the GPU estimator is ported; it encodes the paper's
§IV reasoning:

1. **Row-crossing cost** (Fig. 4): a tile issuing ``h`` strided row segments
   pays a penalty per crossing that grows with the stride (image width).
2. **Occupancy** (§III.B): blocks per SM are bounded by the active-thread
   ceiling (a 512-thread tile fits twice on the GTX260, once on the 8800GTS).
3. **Sensitivity vs core count** (§IV.C): waves = ceil(blocks / (SMs x
   blocks per SM)) flattens as the SM count grows.

On the H100 a block's shared memory bounds residency as well: blocks per SM
are at most ``smem_per_sm // vmem_bytes`` (228 KB per SM), as the TPU
estimator bounds a tile by VMEM, and a tile over the 227 KB one block may
use is infinite. Compute is charged at the CUDA cores' rate
(``simt_flops``), which is what the port's kernels run on. The paper's two
GPUs leave those fields at 0 and get the reference's numbers exactly.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.hardware import HardwareModel
from repro_torch.core.tiling import cdiv

DRAM_PAGE_BYTES = 4096
GPU_WARP = 32


@dataclasses.dataclass(frozen=True)
class TileWorkload:
    """What one tile (one thread block's share) of a kernel does.

    Kernels construct this from (problem, tile, dtype); the estimator turns
    it into time. ``row_segments`` is the number of distinct strided
    segments the tile reads/writes (the paper's row crossings);
    ``row_stride_bytes`` is the stride between them.
    """

    flops: float                 # useful FLOPs in the tile
    hbm_bytes: float             # device-memory bytes moved (reads + writes)
    row_segments: int            # strided segment count (paper Fig. 4)
    row_stride_bytes: float      # stride between segments
    threads: int = 0             # threads per block
    pad_waste: float = 1.0       # >=1: padded work / useful work


@dataclasses.dataclass(frozen=True)
class CostBreakdown:
    compute_s: float
    memory_s: float
    overhead_s: float
    utilization: float           # 0..1 parallel-unit utilization
    total_s: float

    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "overhead": self.overhead_s,
        }
        return max(terms, key=terms.get)


INFEASIBLE = CostBreakdown(math.inf, math.inf, math.inf, 0.0, math.inf)


def row_penalty_s(hw: HardwareModel, stride_bytes: float) -> float:
    """Bandwidth-consuming cost of one strided row crossing (grows with the
    stride, so wider final images amplify it: the paper's scales 6-10)."""
    pages = max(1.0, stride_bytes / DRAM_PAGE_BYTES)
    return hw.dma_row_latency * pages


def estimate_gpu(
    hw: HardwareModel,
    work: TileWorkload,
    n_tiles: int,
    vmem_bytes: float = 0.0,
) -> CostBreakdown:
    """Throughput model of one launch of ``n_tiles`` blocks on a GPU."""
    if work.threads <= 0:
        raise ValueError("GPU estimate requires threads per block")
    if work.threads > hw.max_threads_per_block or vmem_bytes > hw.vmem_bytes:
        return INFEASIBLE

    # Occupancy: the paper's §III.B active-thread ceiling, and on Hopper the
    # SM's shared memory.
    blocks_per_sm = min(hw.max_active_threads // work.threads,
                        hw.max_blocks_per_sm)
    if hw.smem_per_sm and vmem_bytes > 0:
        blocks_per_sm = min(blocks_per_sm, int(hw.smem_per_sm // vmem_bytes))
    if blocks_per_sm == 0:
        return INFEASIBLE
    active_threads = blocks_per_sm * work.threads
    utilization = active_threads / hw.max_active_threads

    # Little's law: DRAM bandwidth saturates only with enough resident
    # threads (a 32x16 tile fits twice on the GTX260 but once on the
    # 8800GTS, leaving bandwidth on the table).
    bw_frac = 1.0
    if hw.saturation_threads:
        bw_frac = min(1.0, active_threads / hw.saturation_threads)

    # Warp granularity: a 16-thread block still occupies whole warps.
    warp_pad = cdiv(work.threads, GPU_WARP) * GPU_WARP / work.threads

    # DRAM bank thrash: a tile touching more strided rows than there are
    # open banks re-opens pages superlinearly.
    segs = work.row_segments
    seg_eff = segs * max(1.0, segs / hw.dram_banks)

    sm_flops = (hw.simt_flops or hw.peak_flops_bf16) / hw.num_sm
    sm_bw = hw.hbm_bw / hw.num_sm

    per_block_compute = work.flops * warp_pad * work.pad_waste / sm_flops
    per_block_memory = (
        work.hbm_bytes / (sm_bw * bw_frac)
        + seg_eff * row_penalty_s(hw, work.row_stride_bytes)
    )

    # One resident set = blocks_per_sm blocks co-scheduled on an SM: compute
    # serializes on the cores, memory on the SM's bandwidth share; the larger
    # bounds the set. Block dispatch adds a small fixed cost per block.
    set_compute = blocks_per_sm * per_block_compute
    set_memory = blocks_per_sm * per_block_memory
    set_time = max(set_compute, set_memory) + blocks_per_sm * hw.sched_overhead

    waves = cdiv(n_tiles, hw.num_sm * blocks_per_sm)
    total = waves * set_time + hw.launch_overhead
    return CostBreakdown(
        compute_s=waves * set_compute,
        memory_s=waves * set_memory,
        overhead_s=hw.launch_overhead,
        utilization=utilization,
        total_s=total,
    )


def estimate(
    hw: HardwareModel,
    work: TileWorkload,
    n_tiles: int,
    vmem_bytes: float = 0.0,
) -> CostBreakdown:
    if hw.family != "gpu":
        raise ValueError(f"the port models GPUs only, not {hw.name!r}")
    return estimate_gpu(hw, work, n_tiles, vmem_bytes)
