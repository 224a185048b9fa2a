"""Bilinear upscale on Hopper: the wrapper of ``csrc/bilinear.cu`` and the
registry declarations.

Two KernelSpecs share the problem ``{"src_h", "src_w", "scale"}`` and a tile
rank 2 = ``(bh, bw)``:

* ``bilinear``      — the kernel that runs on the H100. The tile is the
  thread block (``bh * bw <= 1024`` threads), as in the paper's Fig. 3; a
  thread writes :func:`vector_pixels` neighbouring pixels of a row (16
  bytes: 4 float32, 8 bf16) on :data:`ROWS` consecutive rows, so a block
  covers ``(ROWS * bh) x (V * bw)`` output pixels (:func:`footprint`). Shared
  memory holds the block's source positions. Any tile launches: the ragged
  edge is masked.
* ``bilinear_cuda`` — the paper's gather implementation as executed on its
  GPUs (4 reads + ~10 flops per pixel, one thread per pixel), unchanged from
  the reference; modelled only, for the GTX260 and 8800GTS descriptors.
"""
from __future__ import annotations

import ctypes
import math
import re
from typing import Mapping, Tuple

import torch

from repro_torch.core import registry
from repro_torch.core.cost_model import TileWorkload
from repro_torch.core.hardware import H100_SXM
from repro_torch.core.tiling import TileConstraints, TileShape, cdiv, dtype_bytes
from repro_torch.kernels import build
from repro_torch.kernels.bilinear.ref import bilinear_upscale_ref

MAX_GRID_Y = 65535
MAX_SIDE = 1 << 24      # output sides whose indices are exact floats
VECTOR_BYTES = 16       # one store a thread a row
# The rows a thread writes: ``ROWS`` in the source, the one place it is set.
ROWS = int(re.search(r"constexpr int ROWS = (\d+);", (
    build.CSRC / build.SOURCES["bilinear"]).read_text()).group(1))


def _lib():
    fn = build.load("bilinear").repro_bilinear
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def vector_pixels(dtype) -> int:
    """V: the pixels of one 16-byte store, 4 in float32 and 8 in bf16."""
    return VECTOR_BYTES // dtype_bytes(dtype)


def footprint(tile, dtype) -> Tuple[int, int]:
    """The output pixels one block writes: ``(ROWS * bh, V * bw)``."""
    return ROWS * int(tile[0]), vector_pixels(dtype) * int(tile[1])


def smem_bytes(tile, dtype) -> int:
    """The block's shared memory: one float32 source position per column
    and per row of its footprint."""
    fh, fw = footprint(tile, dtype)
    return 4 * (fh + fw)


def store_path(problem: Mapping[str, int], dtype) -> str:
    """Which stores the kernel issues for ``problem``, as the source decides
    (needs the built kernel): ``vector`` (16 bytes a thread) or ``scalar``
    (one pixel a store, where a row's bytes are no multiple of 16)."""
    fn = build.load("bilinear").repro_bilinear_vector_stores
    vec = fn(int(problem["src_w"]), int(problem["scale"]), build.dtype_code(dtype))
    return "vector" if vec else "scalar"


def launch_tile(tile, problem: Mapping[str, int], dtype="float32"):
    """The ``(bh, bw)`` thread block the kernel runs for ``tile``. Raises
    ValueError for a block it cannot launch."""
    bh, bw = (int(x) for x in tile)
    oh = problem["src_h"] * problem["scale"]
    ow = problem["src_w"] * problem["scale"]
    if bh <= 0 or bw <= 0 or bh * bw > H100_SXM.max_threads_per_block:
        raise ValueError(f"bilinear tile ({bh}, {bw}) must be a block of 1 to "
                         f"{H100_SXM.max_threads_per_block} threads")
    if max(oh, ow) > MAX_SIDE:
        raise ValueError(f"bilinear output {oh}x{ow} has a side over {MAX_SIDE}")
    fh = footprint(tile, dtype)[0]
    if cdiv(oh, fh) > MAX_GRID_Y:
        raise ValueError(f"bilinear tile height {bh} x {ROWS} rows gives "
                         f"{cdiv(oh, fh)} block rows; the grid takes {MAX_GRID_Y}")
    return bh, bw


def upscale(src: torch.Tensor, scale: int, tile=None) -> torch.Tensor:
    """Upscale ``src`` [H, W] by integer ``scale`` -> [H*scale, W*scale].

    CPU tensors take :func:`bilinear_upscale_ref`. CUDA tensors launch the
    kernel with thread block ``tile`` = (bh, bw) (default: the spec's Hopper
    tile), or raise; the tile need not divide the output.
    """
    if src.dim() != 2:
        raise ValueError(f"expected [H, W] image, got {tuple(src.shape)}")
    scale = int(scale)
    if scale < 1:
        raise ValueError("scale must be a positive integer")
    if src.device.type == "cpu":
        return bilinear_upscale_ref(src, scale)
    build.refuse_grad("bilinear", src)
    build.check_cuda_operands("bilinear", src)
    h, w = src.shape
    problem = dict(src_h=h, src_w=w, scale=scale)
    if tile is None:
        tile = SPEC.default_tile(problem, str(src.dtype))
    bh, bw = launch_tile(tile, problem, src.dtype)
    out = torch.empty((h * scale, w * scale), dtype=src.dtype, device=src.device)
    if out.numel() == 0:
        return out
    meta = build.is_meta(src)
    if meta:
        build.meta_work("bilinear", flops(h * scale, w * scale),
                        build.nbytes(src, out))
    else:
        rc = _lib()(src.data_ptr(), out.data_ptr(), h, w, scale,
                    build.dtype_code(src.dtype), bh, bw,
                    build.stream_ptr(src.device))
        build.check(rc, "bilinear")
    build.launched("bilinear", meta)
    return out


def flops(out_h: int, out_w: int) -> float:
    """The upscale's operations: three blends (two along a row, one
    between the rows) an output pixel."""
    return 3.0 * out_h * out_w


# --------------------------------------------------------------------------
# Registry: the Hopper kernel. Bilinear cells are compiled in float32
# (compile_plans.kernel_dtypes), so the spec models float32's footprint:
# the problem carries no dtype, and ``n_tiles`` must count blocks without
# one. In bf16 a block covers twice the columns, the same bytes.
# --------------------------------------------------------------------------

SPEC_DTYPE = "float32"


def _out_dims(problem: Mapping[str, int]):
    return problem["src_h"] * problem["scale"], problem["src_w"] * problem["scale"]


def _constraints(problem: Mapping[str, int]) -> TileConstraints:
    # A tile is a thread block: its dims are bounded by the thread grid.
    oh, ow = _out_dims(problem)
    return TileConstraints(rank=2, max_dims=(cdiv(oh, ROWS),
                                             cdiv(ow, vector_pixels(SPEC_DTYPE))),
                           lane_dim=1, sublane_dim=0, vmem_fraction=1.0)


def _vmem_bytes(tile: TileShape, problem: Mapping[str, int], dtype: str) -> float:
    try:
        launch_tile(tile, problem, SPEC_DTYPE)
    except ValueError:
        return math.inf
    return float(smem_bytes(tile, SPEC_DTYPE))


def _workload(tile: TileShape, problem: Mapping[str, int], dtype: str) -> TileWorkload:
    bh, bw = tile
    s = problem["scale"]
    b = dtype_bytes(dtype)
    _, ow = _out_dims(problem)
    fh, fw = footprint(tile, SPEC_DTYPE)
    src_rows, src_cols = fh // s + 2, fw // s + 2
    # The block writes its footprint and reads the source rows and columns
    # it falls between; a pixel is one blend (3 flops), each source row of
    # the window one lerp per column (3 more).
    return TileWorkload(
        flops=3.0 * fh * fw + 3.0 * src_rows * fw,
        hbm_bytes=float(fh * fw * b + src_rows * src_cols * b),
        row_segments=fh + src_rows,
        row_stride_bytes=float(ow * b),
        threads=bh * bw,
    )


def _n_tiles(tile: TileShape, problem: Mapping[str, int]) -> int:
    oh, ow = _out_dims(problem)
    fh, fw = footprint(tile, SPEC_DTYPE)
    return cdiv(oh, fh) * cdiv(ow, fw)


def _default_tile(problem: Mapping[str, int], dtype: str) -> TileShape:
    # 32 threads wide (a warp stores 512 contiguous bytes), 8 high: of the
    # Fig. 3 tiles the one nearest the best at every scale and dtype on the
    # H100 (within 7% at scales 2, 6 and 10, PERF.md); the paper's (4, 32)
    # came within 12%.
    return TileShape((8, 32))


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


def _cuda_n_tiles(tile: TileShape, problem: Mapping[str, int]) -> int:
    # One thread per pixel: a block covers its own (bh, bw) pixels.
    oh, ow = _out_dims(problem)
    return cdiv(oh, tile[0]) * cdiv(ow, tile[1])


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
    n_tiles=_cuda_n_tiles,
    default_tile=lambda p, d: TileShape((4, 32)),
))


__all__ = ["CUDA_SPEC", "ROWS", "SPEC", "bilinear_upscale_ref", "footprint",
           "flops", "launch_tile", "smem_bytes", "store_path", "upscale",
           "vector_pixels"]
