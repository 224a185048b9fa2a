"""Hopper tiled matmul: the wrapper of ``csrc/matmul.cu`` and its KernelSpec.

Problem dims ``{"m", "k", "n"}``; tile rank 3 = ``(bm, bk, bn)``, the output
block one thread block owns and the K step it walks in. The source compiles
the tiles in :data:`COMPILED_TILES`; a tile larger than the problem is
masked at the ragged edge, so no tile has to divide the problem. The
shared-memory working set per block is the float32 A tile (padded by one
column) plus the float32 B tile — a few KB, far inside the 227 KB a block
may use, where the TPU's (256, 512, 512) default needs 1.5 MiB of VMEM.
Every other tile has an infinite working set in the spec, so the plan
compiler sweeps exactly the compiled tiles; the tile axes reach at least
the compiled dims even for a one-row decode problem.
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
from repro_torch.kernels.matmul.ref import matmul_ref

# (bm, bk, bn) tiles matmul.cu instantiates: a GEMV tile for decode and a
# square tile for prefill.
COMPILED_TILES = ((8, 32, 128), (64, 16, 64))
THREADS = 256   # threads per block of both compiled tiles
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = build.load("matmul")
    fn = lib.repro_matmul
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def split_k(m: int, n: int, k: int, tile) -> int:
    """K splits that bring a too-small output grid up to ~2 blocks per SM."""
    bm, bk, bn = tile
    blocks = cdiv(m, bm) * cdiv(n, bn)
    if blocks >= H100_SXM.num_sm:
        return 1
    return max(1, min(cdiv(2 * H100_SXM.num_sm, blocks), k // (4 * bk)))


def mm(a: torch.Tensor, b: torch.Tensor, tile=None) -> torch.Tensor:
    """``a`` [M, K] @ ``b`` [K, N] -> [M, N] in ``a``'s dtype.

    CPU tensors take :func:`matmul_ref`. CUDA tensors launch the kernel with
    ``tile`` (default: the spec's Hopper tile for this problem) or raise.
    """
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"bad matmul shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_ref(a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"matmul needs both operands on one CUDA device, got "
                         f"{a.device} and {b.device}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"matmul takes float32 or bfloat16 operands of one "
                        f"dtype, got {a.dtype} and {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul needs contiguous operands")
    m, k = a.shape
    n = b.shape[1]
    t = tuple(int(x) for x in (tile if tile is not None else _default_tile(
        dict(m=m, k=k, n=n), str(a.dtype))))
    if t not in COMPILED_TILES:
        raise ValueError(f"matmul tile {t} is not compiled; "
                         f"compiled tiles: {COMPILED_TILES}")
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    splits = split_k(m, n, k, t)
    ws = (torch.empty((splits, m, n), dtype=torch.float32, device=a.device)
          if splits > 1 else None)
    rc = _lib()(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                ws.data_ptr() if ws is not None else None,
                m, n, k, _DTYPES[a.dtype], *t, splits,
                build.stream_ptr(a.device))
    build.check(rc, "matmul")
    build.LAUNCHES["matmul"] += 1
    return out


def _constraints(problem: Mapping[str, int]) -> TileConstraints:
    # Ragged edges are masked, so a tile may exceed the problem: the axes
    # reach the compiled dims however small the problem is.
    reach = [max(t[i] for t in COMPILED_TILES) for i in range(3)]
    dims = (problem["m"], problem["k"], problem["n"])
    return TileConstraints(rank=3, max_dims=tuple(max(p, r) for p, r in
                                                  zip(dims, reach)),
                           lane_dim=2, sublane_dim=0, vmem_fraction=1.0)


def _vmem_bytes(tile: TileShape, problem: Mapping[str, int], dtype: str) -> float:
    if tuple(tile) not in COMPILED_TILES:
        return math.inf
    bm, bk, bn = tile
    return 4.0 * (bk * (bm + 1) + bk * bn)  # float32 A (padded) + B tiles


def _workload(tile: TileShape, problem: Mapping[str, int], dtype: str) -> TileWorkload:
    bm, bk, bn = tile
    m, k, n = problem["m"], problem["k"], problem["n"]
    splits = split_k(m, n, k, tile)
    b = dtype_bytes(dtype)
    k_block = k / splits
    return TileWorkload(
        flops=2.0 * bm * bn * k_block,
        hbm_bytes=(bm + bn) * k_block * b + bm * bn * (4 if splits > 1 else b),
        row_segments=bm,
        row_stride_bytes=float(k * b),
        threads=THREADS,
    )


def _n_tiles(tile: TileShape, problem: Mapping[str, int]) -> int:
    bm, _, bn = tile
    m, k, n = problem["m"], problem["k"], problem["n"]
    return cdiv(m, bm) * cdiv(n, bn) * split_k(m, n, k, tile)


def _default_tile(problem: Mapping[str, int], dtype: str) -> TileShape:
    # Decode rows (a handful of tokens) take the GEMV tile: bytes bound it,
    # so the masked rows of an 8-row block cost nothing. Longer row counts
    # take the square tile.
    return TileShape(COMPILED_TILES[0] if problem["m"] <= 16 else COMPILED_TILES[1])


SPEC = registry.register(registry.KernelSpec(
    name="matmul",
    constraints=_constraints,
    vmem_bytes=_vmem_bytes,
    workload=_workload,
    n_tiles=_n_tiles,
    default_tile=_default_tile,
))


def default_tile(m: int, k: int, n: int, dtype=torch.float32) -> TileShape:
    return SPEC.default_tile(dict(m=m, k=k, n=n), str(dtype))


__all__ = ["COMPILED_TILES", "SPEC", "default_tile", "matmul_ref", "mm",
           "split_k"]
