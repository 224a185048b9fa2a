"""Bilinear upscale on Hopper: the wrapper of ``csrc/bilinear.cu`` and the
registry declarations.

Two KernelSpecs share the problem ``{"src_h", "src_w", "scale"}`` and a tile
rank 2 = output ``(bh, bw)``:

* ``bilinear``      — the kernel that runs on the H100: one thread per
  output pixel, tile = thread block ``(bh, bw)`` (``bh * bw <= 1024``
  threads), no shared memory. Any tile launches: the ragged edge is masked.
* ``bilinear_cuda`` — the paper's gather implementation as executed on its
  GPUs (4 reads + ~10 flops per pixel, one thread per pixel), unchanged from
  the reference; modelled only, for the GTX260 and 8800GTS descriptors.
"""
from __future__ import annotations

import ctypes
import math
from typing import Mapping

import torch

from repro_torch.core import registry
from repro_torch.core.cost_model import TileWorkload
from repro_torch.core.hardware import H100_SXM
from repro_torch.core.tiling import TileConstraints, TileShape, cdiv, dtype_bytes
from repro_torch.kernels import build
from repro_torch.kernels.bilinear.ref import bilinear_upscale_ref

MAX_GRID_Y = 65535


def _lib():
    fn = build.load("bilinear").repro_bilinear
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def launch_tile(tile, problem: Mapping[str, int]):
    """The ``(bh, bw)`` thread block the kernel runs for ``tile``. Raises
    ValueError for a block it cannot launch."""
    bh, bw = (int(x) for x in tile)
    oh = problem["src_h"] * problem["scale"]
    if bh <= 0 or bw <= 0 or bh * bw > H100_SXM.max_threads_per_block:
        raise ValueError(f"bilinear tile ({bh}, {bw}) must be a block of 1 to "
                         f"{H100_SXM.max_threads_per_block} threads")
    if cdiv(oh, bh) > MAX_GRID_Y:
        raise ValueError(f"bilinear tile height {bh} gives {cdiv(oh, bh)} "
                         f"block rows; the grid takes {MAX_GRID_Y}")
    return bh, bw


def upscale(src: torch.Tensor, scale: int, tile=None) -> torch.Tensor:
    """Upscale ``src`` [H, W] by integer ``scale`` -> [H*scale, W*scale].

    CPU tensors take :func:`bilinear_upscale_ref`. CUDA tensors launch the
    kernel with thread block ``tile`` = (bh, bw) (default: the spec's Hopper
    tile) or raise; the tile need not divide the output.
    """
    if src.dim() != 2:
        raise ValueError(f"expected [H, W] image, got {tuple(src.shape)}")
    scale = int(scale)
    if scale < 1:
        raise ValueError("scale must be a positive integer")
    if src.device.type == "cpu":
        return bilinear_upscale_ref(src, scale)
    build.check_cuda_operands("bilinear", src)
    h, w = src.shape
    problem = dict(src_h=h, src_w=w, scale=scale)
    bh, bw = launch_tile(tile if tile is not None
                         else SPEC.default_tile(problem, str(src.dtype)), problem)
    out = torch.empty((h * scale, w * scale), dtype=src.dtype, device=src.device)
    if out.numel() == 0:
        return out
    rc = _lib()(src.data_ptr(), out.data_ptr(), h, w, scale,
                build.dtype_code(src.dtype), bh, bw, build.stream_ptr(src.device))
    build.check(rc, "bilinear")
    build.LAUNCHES["bilinear"] += 1
    return out


# --------------------------------------------------------------------------
# Registry: the Hopper kernel.
# --------------------------------------------------------------------------

def _out_dims(problem: Mapping[str, int]):
    return problem["src_h"] * problem["scale"], problem["src_w"] * problem["scale"]


def _constraints(problem: Mapping[str, int]) -> TileConstraints:
    oh, ow = _out_dims(problem)
    return TileConstraints(rank=2, max_dims=(oh, ow), lane_dim=1,
                           sublane_dim=0, vmem_fraction=1.0)


def _vmem_bytes(tile: TileShape, problem: Mapping[str, int], dtype: str) -> float:
    try:
        launch_tile(tile, problem)
    except ValueError:
        return math.inf
    return 0.0  # no shared memory


def _workload(tile: TileShape, problem: Mapping[str, int], dtype: str) -> TileWorkload:
    bh, bw = tile
    s = problem["scale"]
    b = dtype_bytes(dtype)
    _, ow = _out_dims(problem)
    # The block writes bh x bw pixels and reads the source rows and columns
    # they fall between (the four-point gathers hit L1 after the first).
    src = (bh // s + 2) * (bw // s + 2) * b
    return TileWorkload(
        flops=10.0 * bh * bw,
        hbm_bytes=float(bh * bw * b + src),
        row_segments=bh + bh // s + 2,
        row_stride_bytes=float(ow * b),
        threads=bh * bw,
    )


def _n_tiles(tile: TileShape, problem: Mapping[str, int]) -> int:
    oh, ow = _out_dims(problem)
    return cdiv(oh, tile[0]) * cdiv(ow, tile[1])


def _default_tile(problem: Mapping[str, int], dtype: str) -> TileShape:
    # The paper's 32x4 principle: 32 wide (one warp per row), 4 rows.
    return TileShape((4, 32))


SPEC = registry.register(registry.KernelSpec(
    name="bilinear",
    constraints=_constraints,
    vmem_bytes=_vmem_bytes,
    workload=_workload,
    n_tiles=_n_tiles,
    default_tile=_default_tile,
))


# --------------------------------------------------------------------------
# Registry: the paper's CUDA gather implementation on its own GPUs
# (modelled only; the reference's spec, unchanged).
# --------------------------------------------------------------------------

def _cuda_constraints(problem: Mapping[str, int]) -> TileConstraints:
    oh, ow = _out_dims(problem)
    # CUDA blocks: <=512 threads enforced by the cost model; dims bounded by
    # the paper's sweep range.
    return TileConstraints(
        rank=2, max_dims=(min(oh, 512), min(ow, 512)),
        lane_dim=None, sublane_dim=None,
    )


def _cuda_vmem(tile: TileShape, problem: Mapping[str, int], dtype: str) -> float:
    return 0.0  # the paper's kernel uses no shared memory


GPU_TRANSACTION_BYTES = 128  # G80/GT200 coalesced global transaction size


def _cuda_workload(tile: TileShape, problem: Mapping[str, int], dtype: str) -> TileWorkload:
    bh, bw = tile  # (height, width) = CUDA (blockDim.y, blockDim.x)
    oh, ow = _out_dims(problem)
    b = dtype_bytes(dtype)
    pixels = bh * bw
    s = problem["scale"]
    # Coalescing: each (warp, row) segment moves whole 128B transactions, so
    # narrow tiles (bw < 32) waste bandwidth — this is why every winner in
    # the paper's Fig. 3 is 32 wide. Output: bh segments of bw pixels.
    # Source: each output row reads its two neighbor rows (no cache on G80),
    # segments of ~bw/s + 1 pixels.
    seg = lambda width_px: max(width_px * b, GPU_TRANSACTION_BYTES)  # noqa: E731
    out_bytes = bh * seg(bw)
    src_bytes = 2 * bh * seg(bw // s + 1)
    # DRAM page switches: distinct rows touched, stride = final image width.
    segments = bh + (bh // s + 2)
    return TileWorkload(
        flops=10.0 * pixels,
        hbm_bytes=float(out_bytes + src_bytes),
        row_segments=segments,
        row_stride_bytes=float(ow * b),
        threads=pixels,
    )


CUDA_SPEC = registry.register(registry.KernelSpec(
    name="bilinear_cuda",
    constraints=_cuda_constraints,
    vmem_bytes=_cuda_vmem,
    workload=_cuda_workload,
    n_tiles=_n_tiles,
    default_tile=lambda p, d: TileShape((4, 32)),
))


__all__ = ["CUDA_SPEC", "SPEC", "bilinear_upscale_ref", "launch_tile", "upscale"]
