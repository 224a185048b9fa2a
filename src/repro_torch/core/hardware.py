"""Hardware model descriptors: the port's registry, with the H100 as target.

The same :class:`HardwareModel` record as ``repro/core/hardware.py``; every
tile decision in the port is a function of ``(kernel, problem,
HardwareModel)``. The fields keep their TPU-era names so plan artifacts and
specs line up with the reference; :data:`H100_SXM` documents what each one
means on Hopper.

Beside the H100, the registry keeps the paper's two GPUs (its Table I) as
*modelled* descriptors, with the reference's calibration, so the paper's
analytic claims (Fig. 3, the 32x4 principle) hold in the port. No machine
here has them: plans for them come from the cost model only (:data:`MODELLED`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """A single accelerator model's performance-relevant parameters."""

    name: str
    family: str                    # "tpu" | "gpu"
    # Compute ----------------------------------------------------------------
    peak_flops_bf16: float         # FLOP/s per chip at the bf16 matrix rate
    num_cores: int                 # parallel cores per chip
    mxu_dim: int                   # matrix-unit width
    # Memory hierarchy -------------------------------------------------------
    hbm_bytes: int                 # device memory capacity
    hbm_bw: float                  # bytes/s device memory <-> chip
    vmem_bytes: int                # fast scratch one tile may use
    vmem_bw: float                 # bytes/s of that scratch (modelled)
    # Layout geometry --------------------------------------------------------
    lane_count: int                # minor-dim access width
    sublane_fp32: int              # second-minor tiling for fp32
    sublane_bf16: int              # second-minor tiling for bf16
    # Interconnect -----------------------------------------------------------
    ici_bw_per_link: float         # bytes/s per chip-to-chip link
    ici_links: int                 # links per chip
    # Scheduling (GPU fields) ------------------------------------------------
    max_active_threads: int = 0    # resident threads per SM
    max_threads_per_block: int = 0
    num_sm: int = 0                # streaming multiprocessors
    saturation_threads: int = 0
    dram_banks: int = 8
    sched_overhead: float = 0.0    # per-block scheduling cost, seconds
    # Fixed overheads (seconds) ----------------------------------------------
    dma_row_latency: float = 0.0
    launch_overhead: float = 0.0
    # Hopper estimator fields (0 keeps the paper GPUs' model unchanged) -------
    smem_per_sm: int = 0           # shared memory of one SM: bounds blocks/SM
    max_blocks_per_sm: int = 8     # resident blocks per SM
    simt_flops: float = 0.0        # FLOP/s of the CUDA cores (0: peak_flops_bf16)

    @property
    def sublane(self) -> Dict[str, int]:
        return {"float32": self.sublane_fp32, "bfloat16": self.sublane_bf16}


# ---------------------------------------------------------------------------
# NVIDIA H100 SXM (Hopper, sm_90a) — NVIDIA's data sheet and the Hopper
# architecture white paper. Field meanings on this card:
#
# peak_flops_bf16  989e12: dense bf16 tensor-core rate (wgmma). Float32 outside
#                  the tensor cores is 67e12, TF32 495e12.
# num_cores        132: the SMs, the units thread blocks are scheduled onto.
# mxu_dim          64: rows of one warpgroup wgmma tile (N is a multiple of 8
#                  up to 256, K is 32 bytes deep).
# hbm_bytes/hbm_bw 80 GB of HBM3 at 3.35 TB/s.
# vmem_bytes       232,448 (227 KB): the shared memory ONE thread block may
#                  use (of the SM's 228 KB), above 48 KB only as dynamic
#                  shared memory opted into per kernel. This is the bound a
#                  tile's working set must fit — the role VMEM plays on a TPU.
# vmem_bw          33 TB/s: shared-memory bandwidth summed over the SMs
#                  (128 B/clock/SM at ~1.98 GHz boost), modelled.
# lane_count       32: a warp; loads coalesce when 32 neighbouring threads read
#                  neighbouring addresses (16 B a thread is the fast width).
# sublane_*        1: a GPU has no second-minor register tiling.
# ici_*            NVLink 4: 900 GB/s all-to-all per card, 18 links.
# max_active_*     2048 resident threads, 1024 per block; the SM's 65,536
#                  32-bit registers bound how many are resident in practice.
# num_sm           132.
# launch_overhead  ~3 us per kernel launch from the host (modelled).
# smem_per_sm      233,472 (228 KB): the SM's shared memory, which bounds how
#                  many blocks of a tile are resident at once.
# max_blocks_per_sm 32 resident blocks per SM.
# simt_flops       67e12: float32 FMA on the CUDA cores, the rate every
#                  kernel of the port computes at (none uses wgmma yet).
# ---------------------------------------------------------------------------

H100_SXM = HardwareModel(
    name="h100_sxm", family="gpu",
    peak_flops_bf16=989e12, num_cores=132, mxu_dim=64,
    hbm_bytes=80 * 10**9, hbm_bw=3.35e12,
    vmem_bytes=232_448, vmem_bw=33e12,
    lane_count=32, sublane_fp32=1, sublane_bf16=1,
    ici_bw_per_link=50e9, ici_links=18,
    max_active_threads=2048, max_threads_per_block=1024, num_sm=132,
    saturation_threads=1024, dram_banks=16, sched_overhead=0.0,
    dma_row_latency=0.0, launch_overhead=3.0e-6,
    smem_per_sm=233_472, max_blocks_per_sm=32, simt_flops=67e12,
)

# ---------------------------------------------------------------------------
# The paper's two GPUs (Table I), with the reference's calibration for the
# Fig. 3 reproduction (``repro/core/hardware.py``).
#
# peak_flops: SPs x clock x 2 (MAD) — GTX260: 192 x 1.242GHz x 2 = 477 GFLOP/s
#             8800GTS(320MB, G80): 96 x 1.2GHz x 2 = 230 GFLOP/s
# hbm_bw:     GTX260 448-bit GDDR3 ~111.9 GB/s; 8800GTS 320-bit ~64 GB/s
# dma_row_latency / launch_overhead are calibrated so the cost model
# reproduces Fig. 3's qualitative ordering.
# ---------------------------------------------------------------------------

GTX260 = HardwareModel(
    name="gtx260", family="gpu",
    peak_flops_bf16=477e9, num_cores=192, mxu_dim=32,
    hbm_bytes=1 * 2**30, hbm_bw=111.9e9,
    vmem_bytes=16 * 2**10, vmem_bw=1.4e12,
    lane_count=32, sublane_fp32=1, sublane_bf16=1,
    ici_bw_per_link=0.0, ici_links=0,
    max_active_threads=1024, max_threads_per_block=512, num_sm=24,
    saturation_threads=512, dram_banks=16, sched_overhead=4.0e-7,
    dma_row_latency=2.0e-8, launch_overhead=3.0e-6,
)

GEFORCE_8800GTS = HardwareModel(
    name="geforce_8800gts", family="gpu",
    peak_flops_bf16=230e9, num_cores=96, mxu_dim=32,
    hbm_bytes=320 * 2**20, hbm_bw=64e9,
    vmem_bytes=16 * 2**10, vmem_bw=0.7e12,
    lane_count=32, sublane_fp32=1, sublane_bf16=1,
    ici_bw_per_link=0.0, ici_links=0,
    max_active_threads=768, max_threads_per_block=512, num_sm=12,
    saturation_threads=640, dram_banks=8, sched_overhead=5.0e-7,
    dma_row_latency=3.5e-8, launch_overhead=5.0e-6,
)

REGISTRY: Dict[str, HardwareModel] = {
    m.name: m for m in (H100_SXM, GTX260, GEFORCE_8800GTS)}

# Descriptors the cost model stands in for: plans for them are analytic.
MODELLED = frozenset({GTX260.name, GEFORCE_8800GTS.name})

PRODUCTION_TARGET = H100_SXM


def get(name: str) -> HardwareModel:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown hardware model {name!r}; known: {sorted(REGISTRY)}"
        ) from None
