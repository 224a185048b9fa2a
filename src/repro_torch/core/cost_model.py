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
use is infinite. Compute is charged at the rate of the unit the kernel's
regime runs on (``TileWorkload.unit``, :func:`compute_rate`): the CUDA
cores (``simt_flops``), float32 as 3xTF32 on the tensor cores
(``tf32x3_flops``), or the bf16 tensor cores (``peak_flops_bf16``, the
reference's matrix-unit rate). A SIMT tile's shared-memory loads add to
its compute time, at the SM's shared-memory rate; a kernel fed by TMA or
cp.async needs no resident threads to keep the memory busy. A kernel whose launch is
followed by a second pass (a split's combine) charges that pass's launch
and bytes. The paper's two GPUs leave the Hopper fields at 0 and get the
reference's numbers exactly.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.hardware import HardwareModel
from repro_torch.core.tiling import cdiv

DRAM_PAGE_BYTES = 4096
GPU_WARP = 32

# The units a kernel's FLOPs run on (``TileWorkload.unit``).
SIMT = "simt"                # the CUDA cores (float32 FMA)
TF32X3 = "tf32x3"            # float32 as three TF32 tensor-core products
BF16_TENSOR = "bf16_tensor"  # bf16 tensor cores (wgmma, mma.sync)


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
    unit: str = SIMT             # what computes the FLOPs (compute_rate)
    smem_bytes: float = 0.0      # shared-memory bytes its threads load
    bulk_copies: bool = False    # fed by TMA or cp.async, not thread loads
    extra_launches: int = 0      # launches of a pass after the blocks'
    extra_bytes: float = 0.0     # device-memory bytes that pass moves


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


def compute_rate(hw: HardwareModel, unit: str) -> float:
    """FLOP/s of ``unit`` on ``hw``. A descriptor without Hopper rates
    (the paper's GPUs) charges every unit at ``peak_flops_bf16``."""
    if unit == BF16_TENSOR:
        return hw.peak_flops_bf16
    if unit == TF32X3 and hw.tf32x3_flops:
        return hw.tf32x3_flops
    return hw.simt_flops or hw.peak_flops_bf16


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
    # On Hopper descriptors (``simt_flops`` set) a kernel fed by TMA or
    # cp.async keeps its bytes in flight without resident threads, and a
    # last, partial wave is charged only the blocks it holds.
    hopper = bool(hw.simt_flops)
    bulk_copies = hopper and work.bulk_copies

    # Warp granularity: a 16-thread block still occupies whole warps.
    warp_pad = cdiv(work.threads, GPU_WARP) * GPU_WARP / work.threads

    # DRAM bank thrash: a tile touching more strided rows than there are
    # open banks re-opens pages superlinearly.
    segs = work.row_segments
    seg_eff = segs * max(1.0, segs / hw.dram_banks)

    sm_flops = compute_rate(hw, work.unit) / hw.num_sm
    sm_bw = hw.hbm_bw / hw.num_sm
    per_block_compute = work.flops * warp_pad * work.pad_waste / sm_flops
    if hopper:
        # A SIMT tile issues its shared-memory loads from the warps that
        # issue its FMAs: the loads add to its compute time.
        per_block_compute += work.smem_bytes / (hw.vmem_bw / hw.num_sm)

    def resident_set(blocks: int):
        """(compute, memory, time) of ``blocks`` blocks co-scheduled on an
        SM: compute serializes on the cores, memory on the SM's bandwidth
        share; the larger bounds the set. Block dispatch adds a small fixed
        cost per block."""
        # Little's law: DRAM bandwidth saturates only with enough resident
        # threads (a 32x16 tile fits twice on the GTX260 but once on the
        # 8800GTS, leaving bandwidth on the table).
        bw_frac = 1.0
        if hw.saturation_threads and not bulk_copies:
            bw_frac = min(1.0, blocks * work.threads / hw.saturation_threads)
        per_block_memory = (
            work.hbm_bytes / (sm_bw * bw_frac)
            + seg_eff * row_penalty_s(hw, work.row_stride_bytes)
        )
        compute = blocks * per_block_compute
        memory = blocks * per_block_memory
        return compute, memory, max(compute, memory) + blocks * hw.sched_overhead

    waves = cdiv(n_tiles, hw.num_sm * blocks_per_sm)
    set_compute, set_memory, set_time = resident_set(blocks_per_sm)
    compute_s, memory_s = waves * set_compute, waves * set_memory
    blocks_time = waves * set_time
    rest = n_tiles % (hw.num_sm * blocks_per_sm)
    if hopper and rest:
        last = resident_set(cdiv(rest, hw.num_sm))
        compute_s += last[0] - set_compute
        memory_s += last[1] - set_memory
        blocks_time += last[2] - set_time

    # A second pass (a split's combine) streams its bytes at the card's
    # rate after the blocks, at the cost of one more launch.
    extra_memory = work.extra_bytes / hw.hbm_bw
    overhead = hw.launch_overhead * (1 + work.extra_launches)
    total = blocks_time + extra_memory + overhead
    return CostBreakdown(
        compute_s=compute_s,
        memory_s=memory_s + extra_memory,
        overhead_s=overhead,
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
