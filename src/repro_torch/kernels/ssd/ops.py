"""Mamba-2 SSD on Hopper: the wrapper of ``csrc/ssd.cu``, the whole layer
(discretisation in PyTorch, chunk scan in the kernel) and its KernelSpec.

Problem dims ``{"s", "h", "p", "n"}`` (one batch row); tile rank 1 =
``(chunk,)``. One 256-thread block per (b, h) loops over the chunks, so the
tile's shared memory is the float32 chunk of log_a (and its decay weights),
x, B (padded by one column) and C, the [Q, Q] scores and the [N, P] state:
129 KB at Q = 64 for mamba2-2.7b (P = 64, N = 128), while Q = 128 needs
258 KB and the TPU default Q = 256 far more — over the 227 KB a block may
use, so the spec makes them illegal.
"""
from __future__ import annotations

import ctypes
import math
from typing import Mapping, Optional

import torch

from repro_torch.core import registry
from repro_torch.core.cost_model import TileWorkload
from repro_torch.core.hardware import H100_SXM
from repro_torch.core.tiling import TileConstraints, TileShape, cdiv, dtype_bytes
from repro_torch.kernels import build
from repro_torch.kernels.ssd.ref import (
    discretize, ssd_chunked_ref, ssd_ref, ssd_scan_ref,
)

THREADS = 256


def _lib():
    fn = build.load("ssd").repro_ssd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def smem_bytes(q: int, p: int, n: int) -> int:
    """Shared memory of one block: float32 cumsum and decay weights [Q],
    x [Q, P], B [Q, N + 1], C [Q, N], scores [Q, Q], state [N, P]."""
    return 4 * (2 * q + q * p + q * (n + 1) + q * n + q * q + n * p)


def launch_chunk(chunk, problem: Mapping[str, int]) -> int:
    """The chunk the kernel runs for ``chunk`` (clamped to the sequence).
    Raises ValueError for a chunk it cannot launch."""
    q = min(int(chunk), problem["s"])
    if q < 1:
        raise ValueError(f"ssd chunk must be positive, got {chunk}")
    need = smem_bytes(q, problem["p"], problem["n"])
    if need > H100_SXM.vmem_bytes:
        raise ValueError(f"ssd chunk {q} needs {need} B of shared memory; a "
                         f"block may use {H100_SXM.vmem_bytes}")
    return q


def ssd_scan(log_a, dtx, Bm, C, h0, chunk: Optional[int] = None):
    """The chunk scan: log_a [B, H, S], dtx [B, S, H, P], Bm, C [B, S, N],
    h0 [B, H, N, P] -> (y [B, S, H, P], h_last [B, H, N, P]).

    CPU tensors take :func:`ssd_scan_ref`. CUDA tensors launch the kernel
    with chunk ``chunk`` (default: the spec's Hopper tile) or raise; the
    chunk need not divide S.
    """
    b, s, h, p = dtx.shape
    n = Bm.shape[-1]
    if (log_a.shape != (b, h, s) or Bm.shape != (b, s, n) or C.shape != Bm.shape
            or h0.shape != (b, h, n, p)):
        raise ValueError(f"bad ssd shapes log_a {tuple(log_a.shape)} dtx "
                         f"{tuple(dtx.shape)} B {tuple(Bm.shape)} C "
                         f"{tuple(C.shape)} h0 {tuple(h0.shape)}")
    problem = dict(s=s, h=h, p=p, n=n)
    if chunk is None:
        chunk = SPEC.default_tile(problem, str(dtx.dtype))[0]
    tensors = (log_a, dtx, Bm, C, h0)
    if all(t.device.type == "cpu" for t in tensors):
        return ssd_scan_ref(log_a, dtx, Bm, C, h0, chunk=chunk)
    build.check_cuda_operands("ssd", *tensors)
    q = launch_chunk(chunk, problem)
    y = torch.empty_like(dtx)
    h_last = torch.empty_like(h0)
    if y.numel() == 0:
        return y, h_last
    rc = _lib()(log_a.data_ptr(), dtx.data_ptr(), Bm.data_ptr(), C.data_ptr(),
                h0.data_ptr(), y.data_ptr(), h_last.data_ptr(), b, h, s, p, n,
                q, build.dtype_code(dtx.dtype), build.stream_ptr(dtx.device))
    build.check(rc, "ssd")
    build.LAUNCHES["ssd"] += 1
    return y, h_last


def ssd(x, dt, A, Bm, C, D=None, h0=None, chunk: Optional[int] = None):
    """The whole SSD layer: discretisation in PyTorch, the chunk scan in the
    kernel (on CUDA tensors). x [B, S, H, P], dt [B, S, H], A [H], Bm, C
    [B, S, N], D [H] or None, h0 [B, H, N, P] or None -> (y, h_last)."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    log_a, dtx = discretize(x, dt, A)
    h0 = torch.zeros((b, h, n, p), dtype=x.dtype, device=x.device) if h0 is None else h0
    y, h_last = ssd_scan(log_a.to(x.dtype), dtx.to(x.dtype), Bm, C, h0,
                         chunk=chunk)
    if D is not None:
        y = y + (D.float()[None, None, :, None] * x.float()).to(y.dtype)
    return y, h_last


def _constraints(problem: Mapping[str, int]) -> TileConstraints:
    return TileConstraints(rank=1, max_dims=(problem["s"],), vmem_fraction=1.0)


def _vmem_bytes(tile: TileShape, problem: Mapping[str, int], dtype: str) -> float:
    try:
        q = launch_chunk(tile[0], problem)
    except ValueError:
        return math.inf
    return float(smem_bytes(q, problem["p"], problem["n"]))


def _workload(tile: TileShape, problem: Mapping[str, int], dtype: str) -> TileWorkload:
    # One block scans the whole sequence of one head.
    q = launch_chunk(tile[0], problem)
    s, p, n = problem["s"], problem["p"], problem["n"]
    b = dtype_bytes(dtype)
    n_c = cdiv(s, q)
    flops = n_c * (2.0 * q * q * n + 2.0 * q * q * p + 4.0 * q * n * p)
    hbm = s * (1 + 2 * p + 2 * n) * b + 2 * n * p * b
    return TileWorkload(flops=flops, hbm_bytes=float(hbm), row_segments=n_c,
                        row_stride_bytes=float(problem["h"] * p * b),
                        threads=THREADS)


def _n_tiles(tile: TileShape, problem: Mapping[str, int]) -> int:
    return problem["h"]


def _default_tile(problem: Mapping[str, int], dtype: str) -> TileShape:
    for q in (64, 32, 16, 8, 4, 2, 1):
        tile = TileShape((min(q, problem["s"]),))
        if math.isfinite(_vmem_bytes(tile, problem, dtype)):
            return tile
    return tile


SPEC = registry.register(registry.KernelSpec(
    name="ssd",
    constraints=_constraints,
    vmem_bytes=_vmem_bytes,
    workload=_workload,
    n_tiles=_n_tiles,
    default_tile=_default_tile,
))


__all__ = ["SPEC", "launch_chunk", "smem_bytes", "ssd", "ssd_chunked_ref",
           "ssd_ref", "ssd_scan", "ssd_scan_ref"]
