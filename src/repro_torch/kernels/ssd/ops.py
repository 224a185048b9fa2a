"""Mamba-2 SSD on Hopper: the wrapper of ``csrc/ssd.cu``, the whole layer
(discretisation in PyTorch, chunk scan in the kernels) and its KernelSpec.

Problem dims ``{"s", "h", "p", "n"}`` (one batch row); tile rank 1 =
``(chunk,)``. The scan is three launches (``csrc/ssd.cu``): the chunks'
own states, a pass over the chunks carrying the state, and the chunks'
outputs, each chunk in parallel. Blocks tile the chunk by TQ rows and the
state by 128 x TP, so shared memory bounds only N (up to 368 in float32,
544 in bf16; 104 KB a float32 block at N = 128) and any chunk up to QMAX
launches; the state entering every chunk goes through a float32 workspace
of ceil(S / Q) * H * N * P floats a batch row, which the wrapper
allocates. TQ, TP and QMAX are read from the source.
"""
from __future__ import annotations

import ctypes
import functools
import math
import re
from typing import Dict, Mapping, Optional

import torch

from repro_torch.core import registry
from repro_torch.core.cost_model import BF16_TENSOR, TF32X3, TileWorkload
from repro_torch.core.hardware import H100_SXM
from repro_torch.core.tiling import TileConstraints, TileShape, cdiv, dtype_bytes
from repro_torch.kernels import build
from repro_torch.kernels.ssd.ref import (
    discretize, ssd_chunked_ref, ssd_ref, ssd_scan_ref, ssd_scan_split_ref,
)

THREADS = 128          # four warps in the state kernel
# A chunk under this many steps (short of the whole sequence) launches but
# is not swept: it fills under a quarter of the 64-row tiles, and its
# workspace, N * P floats a chunk, outgrows the inputs (at Q = 16 and
# P = 64, N = 128, 8x x).
MIN_SWEPT_CHUNK = 16


def _lib():
    fn = build.load("ssd").repro_ssd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _layout() -> Dict[str, int]:
    """The kernels' tile constants (``constexpr int`` in ``csrc/ssd.cu``):
    TQ time rows and TP state columns a tile, QMAX the longest chunk."""
    text = (build.CSRC / build.SOURCES["ssd"]).read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (TQ|TP|QMAX) = (\d+);", text)}


def smem_bytes(n: int, dtype) -> int:
    """Shared memory of an output block, the larger kernel's (``out_smem``
    in ``csrc/ssd.cu``, which ``repro_ssd_smem`` returns on the card): the
    chunk's cumsum [QMAX] float32, the row slabs' scores [4, 16, TQ + 8],
    C rows [TQ, N + 8], then float32 h_in [N, TP + 4] (N rounded up to 16
    for bf16's k16 steps) or B rows [TQ, N + 8] with x rows [TQ, TP + 4]
    (TP + 8 in bf16); all but the cumsum and h_in in the input's type."""
    c, es = _layout(), dtype_bytes(dtype)
    tq, tp = c["TQ"], c["TP"]
    ld_row, ld_col = n + 8, tp + (4 if es == 4 else 8)
    nk = n if es == 4 else cdiv(n, 16) * 16
    return (4 * c["QMAX"] + es * 4 * 16 * (tq + 8) + es * tq * ld_row
            + max(4 * nk * (tp + 4), es * tq * (ld_row + ld_col)))


def launch_chunk(chunk, problem: Mapping[str, int], dtype) -> int:
    """The chunk the kernels run for ``chunk`` (clamped to the sequence).
    Raises ValueError for a chunk or a width they cannot launch in
    ``dtype``."""
    q, qmax = min(int(chunk), problem["s"]), _layout()["QMAX"]
    if not 1 <= q <= qmax:
        raise ValueError(f"ssd chunk must be 1 to {qmax}, got {chunk}")
    p, n = problem["p"], problem["n"]
    if p % 8 or n % 8:
        raise ValueError(f"ssd needs P and N in multiples of 8, got {p}, {n}")
    need = smem_bytes(n, dtype)
    if need > H100_SXM.vmem_bytes:
        raise ValueError(f"ssd at N = {n} needs {need} B of shared memory; a "
                         f"block may use {H100_SXM.vmem_bytes}")
    return q


def workspace_floats(q: int, problem: Mapping[str, int], b: int = 1) -> int:
    """Float32 workspace of the chunk states (0 with one chunk)."""
    nc = cdiv(problem["s"], q)
    return 0 if nc == 1 else b * nc * problem["h"] * problem["n"] * problem["p"]


def ssd_scan(log_a, dtx, Bm, C, h0, chunk: Optional[int] = None):
    """The chunk scan: log_a [B, H, S], dtx [B, S, H, P], Bm, C [B, S, N],
    h0 [B, H, N, P] -> (y [B, S, H, P], h_last [B, H, N, P]).

    CPU tensors take :func:`ssd_scan_ref`. CUDA tensors launch the kernels
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
    build.refuse_grad("ssd", *tensors,
                      why="its CUDA gradient is the first item of ROADMAP.md "
                      "§1 (then mamba2 trains on the card)")
    build.check_cuda_operands("ssd", *tensors)
    q = launch_chunk(chunk, problem, dtx.dtype)
    if any(t.data_ptr() % 16 for t in (dtx, Bm, C, h0)):
        raise ValueError("ssd needs dtx, B, C and h0 to start on 16 bytes")
    y = torch.empty_like(dtx)
    h_last = torch.empty_like(h0)
    if y.numel() == 0:
        return y, h_last
    ws = decay = None
    if cdiv(s, q) > 1:
        ws = torch.empty(workspace_floats(q, problem, b), dtype=torch.float32,
                         device=dtx.device)
        decay = torch.empty(cdiv(s, q) * b * h, dtype=torch.float32,
                            device=dtx.device)
    rc = _lib()(log_a.data_ptr(), dtx.data_ptr(), Bm.data_ptr(), C.data_ptr(),
                h0.data_ptr(), y.data_ptr(), h_last.data_ptr(),
                None if ws is None else ws.data_ptr(),
                None if decay is None else decay.data_ptr(), b, h, s, p, n,
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
    return TileConstraints(rank=1, max_dims=(problem["s"],), vmem_fraction=1.0,
                           min_dims=(MIN_SWEPT_CHUNK,))


def _vmem_bytes(tile: TileShape, problem: Mapping[str, int], dtype: str) -> float:
    try:
        launch_chunk(tile[0], problem, dtype)
    except ValueError:
        return math.inf
    return float(smem_bytes(problem["n"], dtype))


def flops(q: int, problem: Mapping[str, int]) -> float:
    """The scan's operations at chunk ``q`` (one batch row): per chunk of L
    steps (the last may be ragged) and head, L (L + 1) / 2 causal pairs for
    C B^T and for scores . x, and L N P products each for C h_in and the
    chunk state; two operations a product."""
    s, h, p, n = problem["s"], problem["h"], problem["p"], problem["n"]
    q = min(q, s)

    def chunk(ln):
        return ln * (ln + 1) * (n + p) + 4.0 * ln * n * p

    return h * ((s // q) * chunk(q) + chunk(s % q))


def _workload(tile: TileShape, problem: Mapping[str, int], dtype: str) -> TileWorkload:
    # One output block: TQ rows of a chunk, TP columns of P, with its share
    # of the chunk-state and state-pass work and of the workspace traffic
    # (written by the states, read and rewritten by the pass, read by the
    # outputs).
    q = launch_chunk(tile[0], problem, dtype)
    s, h, p, n = problem["s"], problem["h"], problem["p"], problem["n"]
    tq, tp = _layout()["TQ"], _layout()["TP"]
    b = dtype_bytes(dtype)
    blocks = cdiv(s, q) * cdiv(q, tq) * cdiv(p, tp)
    hbm = (s * (1 + 2 * p + 2 * n) * b + 2 * n * p * b
           + 4 * 4 * workspace_floats(q, problem) / h)
    # The products run on mma.sync: 3xTF32 in float32, bf16 in bfloat16,
    # on tiles staged by cp.async. Three launches (states, pass, outputs),
    # one for a decode step.
    return TileWorkload(flops=flops(q, problem) / h / blocks,
                        hbm_bytes=float(hbm) / blocks, row_segments=min(q, tq),
                        row_stride_bytes=float(h * p * b), threads=THREADS,
                        unit=TF32X3 if b == 4 else BF16_TENSOR,
                        bulk_copies=True,
                        extra_launches=2 if s > 1 else 0)


def _n_tiles(tile: TileShape, problem: Mapping[str, int]) -> int:
    q = min(int(tile[0]), problem["s"])
    tq, tp = _layout()["TQ"], _layout()["TP"]
    return (problem["h"] * cdiv(problem["s"], q) * cdiv(q, tq)
            * cdiv(problem["p"], tp))


def _default_tile(problem: Mapping[str, int], dtype: str) -> TileShape:
    # The measured best at mamba2-2.7b's width (PERF.md): 64 in float32,
    # where the 3xTF32 products of the longer chunk cost more than its
    # smaller workspace saves, 128 in bf16; then shorter.
    first = 64 if dtype_bytes(dtype) == 4 else 128
    for q in (first, 64, 32, 16):
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


__all__ = ["SPEC", "flops", "launch_chunk", "smem_bytes", "ssd", "ssd_chunked_ref",
           "ssd_ref", "ssd_scan", "ssd_scan_ref", "ssd_scan_split_ref",
           "workspace_floats"]
