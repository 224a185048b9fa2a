"""Hopper matmul: the wrapper of ``csrc/matmul.cu`` and its KernelSpec.

Problem dims ``{"m", "k", "n"}``; tile rank 3 = ``(bm, bk, bn)``, the output
block one thread block owns and the K step it walks in. :func:`regime`
picks one of the source's four kernels from M, N, K and the dtype alone:

* ``skinny`` (M <= 16, decode): a streamed GEMV, bytes-bound; tile
  ``(16, 64, 256)`` (16 rows at most, 64 K rows a step, 256 columns a
  block);
* ``simt`` (M > 16, float32): full-float32 SIMT tiles ``(128, 16, 128)``
  and ``(64, 16, 128)`` with a cp.async ring;
* ``wgmma`` (M > 16, bfloat16): tensor-core tiles ``(128, 64, 128)`` and
  ``(64, 64, 128)``, fed by TMA;
* ``plain``: a row of A or B that is no multiple of 16 bytes, which TMA and
  16-byte loads cannot take; the simt tiles with scalar loads, any M.

Each tile's shared memory is what its kernel allocates (the skinny A rows
and k-lane sums; two float32 stages of the simt tiles; four bf16 stages of
the wgmma ring). A tile of another regime than the problem's has an
infinite working set in the spec, so the plan compiler sweeps exactly the
problem's compiled tiles; a tile larger than the problem is masked at the
ragged edge. When the output tiles are too few for the card, K is split
(:func:`split_k`) and a second kernel sums the float32 partials in order.
"""
from __future__ import annotations

import contextlib
import ctypes
import math
from typing import Mapping, Tuple

import torch

from repro_torch.core import registry
from repro_torch.core.cost_model import BF16_TENSOR, SIMT, TileWorkload
from repro_torch.core.hardware import H100_SXM
from repro_torch.core.tiling import TileConstraints, TileShape, cdiv, dtype_bytes
from repro_torch.kernels import build
from repro_torch.kernels.matmul.ref import matmul_ref

SKINNY_M = 16   # the most rows the skinny kernel keeps
REGIME_TILES = {
    "skinny": ((16, 64, 256),),
    "simt": ((128, 16, 128), (64, 16, 128)),
    "wgmma": ((128, 64, 128), (64, 64, 128)),
}
REGIME_TILES["plain"] = REGIME_TILES["simt"]
_REGIME_CODE = {"skinny": 0, "simt": 1, "wgmma": 2, "plain": 3}
# Every (bm, bk, bn) tile matmul.cu instantiates.
COMPILED_TILES = tuple(t for r in ("skinny", "simt", "wgmma")
                       for t in REGIME_TILES[r])
WGMMA_STAGES = 4
SIMT_STAGES = 2
SKINNY_KC = 512   # A rows the skinny kernel stages at a time (SK_KC)


def threads(tile) -> int:
    """Threads of one block: 256, or 128 a warpgroup of a wgmma tile."""
    bm, bk, _ = tile
    return 2 * bm if tuple(tile) in REGIME_TILES["wgmma"] else 256


def smem_bytes(tile, dtype) -> int:
    """Shared memory one block of ``tile`` allocates for ``dtype`` operands."""
    bm, bk, bn = tile
    if tuple(tile) in REGIME_TILES["skinny"]:
        vec = 16 // dtype_bytes(dtype)
        k_lanes = 256 // (bn // vec)
        return 4 * (bm * SKINNY_KC + k_lanes * bn)
    if tuple(tile) in REGIME_TILES["simt"]:
        return 4 * SIMT_STAGES * bk * ((bm + 4) + bn)   # A padded, float32
    if tuple(tile) in REGIME_TILES["wgmma"]:
        return WGMMA_STAGES * (bm * bk + bk * bn) * 2 + 1024 + 16 * WGMMA_STAGES
    raise ValueError(f"matmul tile {tuple(tile)} is not compiled")


def regime(m: int, n: int, k: int, dtype) -> str:
    """The kernel a problem runs on: from M, N, K and the dtype alone."""
    esize = dtype_bytes(dtype)
    if (k * esize) % 16 or (n * esize) % 16:
        return "plain"
    if m <= SKINNY_M:
        return "skinny"
    return "wgmma" if esize == 2 else "simt"


def launch_tile(tile, m: int, n: int, k: int, dtype) -> Tuple[int, int, int]:
    """``tile`` as ints, or ValueError if the problem's regime has no such
    compiled tile."""
    t = tuple(int(x) for x in tile)
    r = regime(m, n, k, dtype)
    if t not in REGIME_TILES[r]:
        raise ValueError(f"matmul tile {t} is not a compiled {r} tile; "
                         f"{r} tiles: {REGIME_TILES[r]}")
    return t


def split_plan(m: int, n: int, k: int, tile) -> Tuple[int, int]:
    """``(splits, k_split)``: K runs of ``k_split`` rows (a multiple of bk)
    over the grid. A skinny grid splits until >= 2 blocks sit on each SM,
    the others until one wave fills the card; every split keeps at least
    four K steps."""
    bm, bk, bn = tile
    blocks = cdiv(m, bm) * cdiv(n, bn)
    sms = H100_SXM.num_sm
    want = cdiv(2 * sms, blocks) if bm <= SKINNY_M else sms // blocks
    want = max(1, min(want, k // (4 * bk)))
    k_split = cdiv(cdiv(k, want), bk) * bk
    return cdiv(k, k_split), k_split


def split_k(m: int, n: int, k: int, tile) -> int:
    """K splits the kernel runs for this problem and tile."""
    return split_plan(m, n, k, tile)[0]


def _lib():
    lib = build.load("matmul")
    fn = lib.repro_matmul
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def mm(a: torch.Tensor, b: torch.Tensor, tile=None) -> torch.Tensor:
    """``a`` [M, K] @ ``b`` [K, N] -> [M, N] in ``a``'s dtype.

    CPU tensors take :func:`matmul_ref` (differentiable as it is). CUDA
    tensors launch the kernel of their :func:`regime` with ``tile``
    (default: the spec's Hopper tile for this problem) or raise; under grad
    mode, with an operand that requires grad, through :class:`_MatmulFn`,
    whose backward launches the same kernel. Inside a layer checkpointed
    under remat "dots" (:func:`kept_product_contexts`) the output is kept,
    and the layer's recompute takes it back instead of launching.
    """
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"bad matmul shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    kept = _KEPT[-1] if _KEPT else None
    if kept is not None and kept.replaying:
        return kept.replay(a, b, tile)
    grad = torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)
    if a.device.type == "cpu" and b.device.type == "cpu":
        if kept is not None and grad:
            # The Function the recompute replays through: it saves the same
            # tensors, as the checkpoint requires.
            with torch.no_grad():
                out = matmul_ref(a, b)
            out = _KeptPlainFn.apply(a, b, [out])
        else:
            out = matmul_ref(a, b)
    elif grad:
        out = _MatmulFn.apply(a, b, tile)
    else:
        out = _mm_cuda(a, b, tile)
    if kept is not None:
        kept.outputs.append(out.detach())
    return out


# -- remat "dots": a checkpointed layer keeps its products ---------------------
# The reference's ``dots_with_no_batch_dims_saveable`` policy saves the
# outputs of a rematerialised layer's products and recomputes the rest. The
# port's products are ``mm`` calls, which launch the kernel through ctypes
# where no aten-level policy sees them, so the checkpoint's two contexts
# (``layers.maybe_checkpoint``) keep them here: its forward appends each
# ``mm`` output to a :class:`KeptProducts`, its recompute takes them back in
# call order, launching nothing, with the same backward as the call it
# replays.
_KEPT: list = []


class KeptProducts:
    """The ``mm`` outputs of one checkpointed call, in call order."""

    def __init__(self):
        self.outputs: list = []
        self.replaying = False

    def replay(self, a, b, tile):
        out = self.outputs.pop(0)
        if out.shape != (a.shape[0], b.shape[1]):
            raise RuntimeError("a recomputed layer called mm in another "
                               "order than its forward")
        if not (torch.is_grad_enabled()
                and (a.requires_grad or b.requires_grad)):
            return out
        if a.device.type == "cpu" and b.device.type == "cpu":
            return _KeptPlainFn.apply(a, b, [out])
        return _MatmulFn.apply(a, b, tile, [out])

    @contextlib.contextmanager
    def keeping(self):
        _KEPT.append(self)
        try:
            yield
        finally:
            _KEPT.remove(self)

    @contextlib.contextmanager
    def reusing(self):
        self.replaying = True
        _KEPT.append(self)
        try:
            yield
        finally:
            _KEPT.remove(self)
            self.outputs.clear()


def kept_product_contexts():
    """``torch.utils.checkpoint``'s ``context_fn`` for remat "dots": the
    forward keeps every ``mm`` output, the recompute reuses them."""
    kept = KeptProducts()
    return kept.keeping(), kept.reusing()


class _KeptPlainFn(torch.autograd.Function):
    """A kept CPU product: its output as it was, and the plain version's
    gradient (:func:`matmul_ref`'s, at the recomputed operands)."""

    @staticmethod
    def forward(ctx, a, b, kept):
        ctx.save_for_backward(a, b)
        return kept[0].view_as(kept[0])

    @staticmethod
    def backward(ctx, dc):
        a, b = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need) for t, need in
                      zip((a, b), ctx.needs_input_grad[:2])]
            out = matmul_ref(*leaves)
            wanted = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, dc))
        return (*(next(grads) if t.requires_grad else None for t in leaves),
                None)


def _grad_operand(t: torch.Tensor) -> torch.Tensor:
    """A backward product's operand as the kernel takes it: contiguous and
    on 16 bytes (a transpose is copied; a gradient may arrive as a view)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


class _MatmulFn(torch.autograd.Function):
    """C = A B through the kernel, forward and backward: dA = dC Bᵀ and
    dB = Aᵀ dC are the same kernel on transposed copies (each launch counted
    under ``matmul``), at the default tile of their own shapes. The
    reference differentiates its Pallas matmul through JAX; the products are
    the same."""

    @staticmethod
    def forward(ctx, a, b, tile, kept=None):
        ctx.save_for_backward(a, b)
        if kept is not None:              # a kept product: no launch
            return kept[0].view_as(kept[0])
        return _mm_cuda(a, b, tile)

    @staticmethod
    def backward(ctx, dc):
        a, b = ctx.saved_tensors
        dc = _grad_operand(dc)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _mm_cuda(dc, _grad_operand(b.t()), None)
        if ctx.needs_input_grad[1]:
            db = _mm_cuda(_grad_operand(a.t()), dc, None)
        return da, db, None, None


def _mm_cuda(a: torch.Tensor, b: torch.Tensor, tile) -> torch.Tensor:
    """One launch of the kernel (no autograd history); on ``meta``
    tensors the same decisions and outputs, counted and not launched."""
    build.check_cuda_operands("matmul", a, b)
    m, k = a.shape
    n = b.shape[1]
    t = launch_tile(tile if tile is not None else _default_tile(
        dict(m=m, k=k, n=n), str(a.dtype)), m, n, k, a.dtype)
    reg = regime(m, n, k, a.dtype)
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    if reg != "plain" and (a.data_ptr() % 16 or b.data_ptr() % 16):
        raise ValueError(f"matmul's {reg} kernel needs 16-byte aligned "
                         "operands")
    splits, k_split = split_plan(m, n, k, t)
    ws = (torch.empty((splits, m, n), dtype=torch.float32, device=a.device)
          if splits > 1 else None)
    meta = build.is_meta(a, b)
    if meta:
        build.meta_work("matmul", flops(m, n, k),
                        build.nbytes(a, b, out, ws))
    else:
        rc = _lib()(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                    ws.data_ptr() if ws is not None else None,
                    m, n, k, build.dtype_code(a.dtype), _REGIME_CODE[reg], *t,
                    k_split, splits, build.stream_ptr(a.device))
        build.check(rc, "matmul")
    build.launched("matmul", meta)
    return out


def flops(m: int, n: int, k: int) -> float:
    """The product's operations: two a multiply-add."""
    return 2.0 * m * n * k


def _constraints(problem: Mapping[str, int]) -> TileConstraints:
    # Ragged edges are masked, so a tile may exceed the problem: the axes
    # reach the compiled dims however small the problem is.
    reach = [max(t[i] for t in COMPILED_TILES) for i in range(3)]
    dims = (problem["m"], problem["k"], problem["n"])
    return TileConstraints(rank=3, max_dims=tuple(max(p, r) for p, r in
                                                  zip(dims, reach)),
                           lane_dim=2, sublane_dim=0, vmem_fraction=1.0)


def _vmem_bytes(tile: TileShape, problem: Mapping[str, int], dtype: str) -> float:
    try:
        t = launch_tile(tile, problem["m"], problem["n"], problem["k"], dtype)
    except ValueError:
        return math.inf
    return float(smem_bytes(t, dtype))


def _workload(tile: TileShape, problem: Mapping[str, int], dtype: str) -> TileWorkload:
    # A block computes all bm rows of its tile, masked rows too (wgmma in
    # whole 64-row warpgroup tiles): rows past M are pad waste. The skinny
    # and simt kernels run on the CUDA cores, wgmma on the bf16 tensor
    # cores. A simt thread owns bm / 16 rows of 8 columns and loads its
    # rows' and columns' float32 operands from shared memory each K step.
    # A split K adds the reduce kernel, which reads the float32 partials
    # and writes C.
    bm, bk, bn = tile
    m, k, n = problem["m"], problem["k"], problem["n"]
    splits, k_split = split_plan(m, n, k, tile)
    b = dtype_bytes(dtype)
    k_block = k / splits
    rows = min(bm, m)
    reg = regime(m, n, k, dtype)
    wgmma = reg == "wgmma"
    simt_smem = (k_block * threads(tile) * (bm // 16 + 8) * 4.0
                 if reg in ("simt", "plain") else 0.0)
    return TileWorkload(
        flops=2.0 * rows * bn * k_block,
        hbm_bytes=(bm + bn) * k_block * b + bm * bn * (4 if splits > 1 else b),
        row_segments=bm,
        row_stride_bytes=float(k * b),
        threads=threads(tile),
        pad_waste=bm / rows,
        unit=BF16_TENSOR if wgmma else SIMT,
        smem_bytes=simt_smem,
        bulk_copies=reg in ("simt", "wgmma"),     # cp.async ring, TMA
        extra_launches=int(splits > 1),
        extra_bytes=float(m * n * (4 * splits + b)) if splits > 1 else 0.0,
    )


def _n_tiles(tile: TileShape, problem: Mapping[str, int]) -> int:
    bm, _, bn = tile
    m, k, n = problem["m"], problem["k"], problem["n"]
    return cdiv(m, bm) * cdiv(n, bn) * split_k(m, n, k, tile)


def _default_tile(problem: Mapping[str, int], dtype: str) -> TileShape:
    """The regime's first tile: 128 rows a simt or wgmma block, split over
    K where the grid is short of the card. On the H100 it won every
    65536-row cell of the plan compile in both dtypes (PERF.md)."""
    m, k, n = problem["m"], problem["k"], problem["n"]
    return TileShape(REGIME_TILES[regime(m, n, k, dtype)][0])


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


__all__ = ["COMPILED_TILES", "REGIME_TILES", "SKINNY_M", "SPEC",
           "default_tile", "flops", "launch_tile", "matmul_ref", "mm", "regime",
           "smem_bytes", "split_k", "split_plan", "threads"]
