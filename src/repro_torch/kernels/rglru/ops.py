"""RG-LRU on Hopper: the wrapper of ``csrc/rglru.cu``, the whole unit (gate
math in PyTorch, the scan in the kernel) and its KernelSpec.

Problem dims ``{"s", "f"}`` (one batch row); tile rank 2 = ``(bt, bf)``:
bf features, one thread each, per block (at most 1024), and bt time rows
staged per step in 8 * bt * bf bytes of shared memory (float32 a and x).
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
from repro_torch.kernels.rglru.ref import gates, rglru_ref, rglru_scan_ref


def _lib():
    fn = build.load("rglru").repro_rglru
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def smem_bytes(bt: int, bf: int) -> int:
    return 8 * bt * bf


def launch_tile(tile, problem: Mapping[str, int]):
    """The ``(bt, bf)`` the kernel runs for ``tile`` (clamped to the
    problem). Raises ValueError for a tile it cannot launch."""
    bt = min(int(tile[0]), problem["s"])
    bf = min(int(tile[1]), problem["f"])
    if bt < 1 or bf < 1 or bf > H100_SXM.max_threads_per_block:
        raise ValueError(f"rglru tile ({bt}, {bf}) needs bt >= 1 and 1 to "
                         f"{H100_SXM.max_threads_per_block} features a block")
    if smem_bytes(bt, bf) > H100_SXM.vmem_bytes:
        raise ValueError(f"rglru tile ({bt}, {bf}) needs {smem_bytes(bt, bf)} "
                         f"B of shared memory; a block may use "
                         f"{H100_SXM.vmem_bytes}")
    return bt, bf


def rglru_scan(a, x, h0, tile=None):
    """Scan h_t = a_t * h_{t-1} + x_t: a, x [B, S, F], h0 [B, F] ->
    (y [B, S, F], h_last [B, F]).

    CPU tensors take :func:`rglru_scan_ref`. CUDA tensors launch the kernel
    with ``tile`` = (bt, bf) (default: the spec's Hopper tile) or raise; the
    tile need not divide the problem.
    """
    b, s, f = x.shape
    if a.shape != x.shape or h0.shape != (b, f):
        raise ValueError(f"bad rglru shapes a {tuple(a.shape)} x "
                         f"{tuple(x.shape)} h0 {tuple(h0.shape)}")
    if all(t.device.type == "cpu" for t in (a, x, h0)):
        return rglru_scan_ref(a, x, h0)
    build.check_cuda_operands("rglru", a, x, h0)
    problem = dict(s=s, f=f)
    bt, bf = launch_tile(tile if tile is not None
                         else SPEC.default_tile(problem, str(x.dtype)), problem)
    y = torch.empty_like(x)
    h_last = torch.empty_like(h0)
    if y.numel() == 0:
        return y, h_last
    rc = _lib()(a.data_ptr(), x.data_ptr(), h0.data_ptr(), y.data_ptr(),
                h_last.data_ptr(), b, s, f, bt, bf, build.dtype_code(x.dtype),
                build.stream_ptr(x.device))
    build.check(rc, "rglru")
    build.LAUNCHES["rglru"] += 1
    return y, h_last


def rglru(x, r, i, a_param, h0=None, c: float = 8.0, tile=None):
    """The whole RG-LRU: gate math in PyTorch, the scan in the kernel (on
    CUDA tensors). x, r, i [B, S, F], a_param [F], h0 [B, F] or None."""
    b, _, f = x.shape
    a, inp = gates(x, r, i, a_param, c)
    h0 = torch.zeros((b, f), dtype=x.dtype, device=x.device) if h0 is None else h0
    return rglru_scan(a.to(x.dtype), inp.to(x.dtype), h0, tile=tile)


def _constraints(problem: Mapping[str, int]) -> TileConstraints:
    return TileConstraints(rank=2, max_dims=(problem["s"], problem["f"]),
                           lane_dim=1, sublane_dim=0, vmem_fraction=1.0)


def _vmem_bytes(tile: TileShape, problem: Mapping[str, int], dtype: str) -> float:
    try:
        bt, bf = launch_tile(tile, problem)
    except ValueError:
        return math.inf
    return float(smem_bytes(bt, bf))


def _workload(tile: TileShape, problem: Mapping[str, int], dtype: str) -> TileWorkload:
    # One block scans the whole sequence of its bf features.
    bt, bf = launch_tile(tile, problem)
    s = problem["s"]
    b = dtype_bytes(dtype)
    return TileWorkload(
        flops=2.0 * s * bf,                     # a * h + x per element
        hbm_bytes=float(3 * s * bf * b + 2 * bf * b),   # a, x, y; h0, h_last
        row_segments=cdiv(s, bt),               # one staging round per bt rows
        row_stride_bytes=float(problem["f"] * b),
        threads=bf,
    )


def _n_tiles(tile: TileShape, problem: Mapping[str, int]) -> int:
    _, bf = launch_tile(tile, problem)
    return cdiv(problem["f"], bf)


def _default_tile(problem: Mapping[str, int], dtype: str) -> TileShape:
    # 128 features a block (32 blocks at F = 4096), 64 rows staged a step.
    return TileShape((min(64, problem["s"]), min(128, problem["f"])))


SPEC = registry.register(registry.KernelSpec(
    name="rglru",
    constraints=_constraints,
    vmem_bytes=_vmem_bytes,
    workload=_workload,
    n_tiles=_n_tiles,
    default_tile=_default_tile,
))


__all__ = ["SPEC", "launch_tile", "rglru", "rglru_ref", "rglru_scan",
           "rglru_scan_ref", "smem_bytes"]
