"""RG-LRU on Hopper: the wrapper of ``csrc/rglru.cu``, the whole unit (gate
math in PyTorch, the scan in the kernels) and its KernelSpec.

Problem dims ``{"s", "f"}`` (one batch row); tile rank 2 = ``(bt, bf)``:
the chunk length in time and the features a block takes (at most 1024).
The scan is chunked over time in three launches (chunk summaries, the carry
over the chunks, a rescan of each chunk), so ceil(S / bt) * F chains run in
parallel. A thread takes 4 float32 or 8 bf16 neighbouring features (one
16-byte load) where F and bf allow, else one. No shared memory; a float32
workspace of 3 * ceil(S / bt) * F floats a batch row holds the summaries
and the carries. The backward (:class:`_RglruScanFn`, ``repro_rglru_bwd``)
is the same three launches over time reversed.
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
from repro_torch.kernels.rglru.ref import (
    gates, rglru_ref, rglru_scan_chunked_ref, rglru_scan_ref,
)


def _lib():
    fn = build.load("rglru").repro_rglru
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def launch_tile(tile, problem: Mapping[str, int]):
    """The ``(bt, bf)`` the kernels run for ``tile`` (clamped to the
    problem). Raises ValueError for a tile they cannot launch."""
    bt = min(int(tile[0]), problem["s"])
    bf = min(int(tile[1]), problem["f"])
    if bt < 1 or bf < 1 or bf > H100_SXM.max_threads_per_block:
        raise ValueError(f"rglru tile ({bt}, {bf}) needs bt >= 1 and 1 to "
                         f"{H100_SXM.max_threads_per_block} features a block")
    return bt, bf


def features_per_thread(bf: int, f: int, dtype) -> int:
    """4 float32 or 8 bf16 features (one 16-byte load) where F and bf are
    multiples of it, else 1 (``csrc/rglru.cu``)."""
    vec = 16 // dtype_bytes(dtype)
    return vec if f % vec == 0 and bf % vec == 0 else 1


def rglru_scan(a, x, h0, tile=None):
    """Scan h_t = a_t * h_{t-1} + x_t: a, x [B, S, F], h0 [B, F] ->
    (y [B, S, F], h_last [B, F]).

    CPU tensors take :func:`rglru_scan_ref`. CUDA tensors launch the kernels
    with ``tile`` = (bt, bf) (default: the spec's Hopper tile) or raise; the
    tile need not divide the problem. Under grad mode, with an input that
    requires grad, CUDA tensors go through :class:`_RglruScanFn`, whose
    backward launches the same kernels.
    """
    b, s, f = x.shape
    if a.shape != x.shape or h0.shape != (b, f):
        raise ValueError(f"bad rglru shapes a {tuple(a.shape)} x "
                         f"{tuple(x.shape)} h0 {tuple(h0.shape)}")
    if all(t.device.type == "cpu" for t in (a, x, h0)):
        return rglru_scan_ref(a, x, h0)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (a, x, h0)):
        return _RglruScanFn.apply(a, x, h0, tile)
    y, h_last = _rglru_cuda(a, x, h0, tile)
    build.launched("rglru", x.is_meta)
    return y, h_last


def _rglru_cuda(a, x, h0, tile=None):
    """One run of the kernels (uncounted, no autograd history)."""
    b, s, f = x.shape
    build.check_cuda_operands("rglru", a, x, h0)
    problem = dict(s=s, f=f)
    bt, bf = launch_tile(tile if tile is not None
                         else SPEC.default_tile(problem, str(x.dtype)), problem)
    y = torch.empty_like(x)
    h_last = torch.empty_like(h0)
    if y.numel() == 0:
        return y, h_last
    nc = cdiv(s, bt)
    ws = (torch.empty(3 * b * nc * f, dtype=torch.float32, device=x.device)
          if nc > 1 else None)
    if build.is_meta(a, x, h0):
        build.meta_work("rglru", flops(b, s, f),
                        build.nbytes(a, x, h0, y, h_last, ws))
        return y, h_last
    rc = _lib()(a.data_ptr(), x.data_ptr(), h0.data_ptr(), y.data_ptr(),
                h_last.data_ptr(), None if ws is None else ws.data_ptr(), b, s,
                f, bt, bf, build.dtype_code(x.dtype), build.stream_ptr(x.device))
    build.check(rc, "rglru")
    return y, h_last


def flops(b: int, s: int, f: int) -> float:
    """The scan's operations: a multiply and an add a step and feature."""
    return 2.0 * b * s * f


def bwd_flops(b: int, s: int, f: int) -> float:
    """The backward's: the reversed scan's (:func:`flops`) and da's product
    a step and feature."""
    return 3.0 * b * s * f


def rglru_scan_backward(a, y, h0, dy, dh_last, scan):
    """The scan's gradients (da, dx, dh0) from dy [B, S, F] and dh_last
    [B, F] (None: zero), given the forward's y (its h_t).

    ``scan(a, x, h0) -> (y, h_last)`` is the forward. The adjoint g_t =
    dL/dh_t obeys g_t = a_{t+1} g_{t+1} + dy_t from g_{S-1} = dy_{S-1} +
    dh_last: the scan itself on dy reversed in time, with a' = [1, a
    reversed without its first step] and h0' = dh_last. Then dx = g,
    da_t = g_t h_{t-1} (h_{-1} = h0) and dh0 = a_0 g_0, g_0 being that
    scan's h_last. CPU tests run it with :func:`rglru_scan_ref` in the
    kernel's place; ``repro_rglru_bwd`` computes the same function with the
    reversal in its indexing (the plain version of that kernel is this
    function over :func:`rglru_scan_ref`).
    """
    if dh_last is None:
        dh_last = torch.zeros_like(h0)
    r_a = torch.cat([torch.ones_like(a[:, :1]),
                     torch.flip(a[:, 1:], (1,))], dim=1)
    r_dy = torch.flip(dy, (1,)).contiguous()
    r_g, g0 = scan(r_a, r_dy, dh_last.contiguous())
    g = torch.flip(r_g, (1,))
    h_prev = torch.cat([h0[:, None].float(), y[:, :-1].float()], dim=1)
    da = (g.float() * h_prev).to(a.dtype)
    dh0 = (a[:, 0].float() * g0.float()).to(h0.dtype)
    return da, g.to(y.dtype), dh0


def _bwd_lib():
    fn = build.load("rglru").repro_rglru_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _rglru_bwd_cuda(a, y, h0, dy, dh_last, tile=None):
    """One run of ``repro_rglru_bwd`` (uncounted): :func:`rglru_scan_backward`'s
    function, (da, dx, dh0), with the reversal in the kernels' indexing and
    da folded into the rescan; ``tile`` (default: the spec's) as the
    forward's."""
    b, s, f = y.shape
    dy, dh_last = dy.contiguous(), dh_last.contiguous()
    build.check_cuda_operands("rglru_bwd", a, y, h0, dy, dh_last)
    problem = dict(s=s, f=f)
    bt, bf = launch_tile(tile if tile is not None
                         else SPEC.default_tile(problem, str(y.dtype)), problem)
    dx, da, dh0 = torch.empty_like(y), torch.empty_like(a), torch.empty_like(h0)
    if y.numel() == 0:
        return da, dx, dh0
    nc = cdiv(s, bt)
    ws = (torch.empty(3 * b * nc * f, dtype=torch.float32, device=y.device)
          if nc > 1 else None)
    if build.is_meta(a, y, h0, dy, dh_last):
        build.meta_work("rglru_bwd", bwd_flops(b, s, f),
                        build.nbytes(a, y, h0, dy, dh_last, dx, da, dh0, ws))
        return da, dx, dh0
    rc = _bwd_lib()(a.data_ptr(), y.data_ptr(), h0.data_ptr(), dy.data_ptr(),
                    dh_last.data_ptr(), dx.data_ptr(), da.data_ptr(),
                    dh0.data_ptr(), None if ws is None else ws.data_ptr(), b,
                    s, f, bt, bf, build.dtype_code(y.dtype),
                    build.stream_ptr(y.device))
    build.check(rc, "rglru_bwd")
    return da, dx, dh0


class _RglruScanFn(torch.autograd.Function):
    """The scan through the kernels, forward and backward: the forward is
    ``repro_rglru`` (counted under ``rglru``); the backward is
    ``repro_rglru_bwd`` (counted once under ``rglru_bwd``), the same chunked
    scan over time reversed at the default tile, which computes
    :func:`rglru_scan_backward`'s function. The reference differentiates its
    jnp scan through JAX."""

    @staticmethod
    def forward(ctx, a, x, h0, tile):
        y, h_last = _rglru_cuda(a, x, h0, tile)
        build.launched("rglru", x.is_meta)
        ctx.save_for_backward(a, y, h0)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        a, y, h0 = ctx.saved_tensors
        da, dx, dh0 = _rglru_bwd_cuda(a, y, h0, dy, dh_last)
        build.launched("rglru_bwd", y.is_meta)
        return da, dx, dh0, None


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
        launch_tile(tile, problem)
    except ValueError:
        return math.inf
    return 0.0                                  # no shared memory


def _workload(tile: TileShape, problem: Mapping[str, int], dtype: str) -> TileWorkload:
    # One (chunk, feature-block) of the summary and rescan launches, with its
    # share of the carry; with one chunk the rescan alone.
    bt, bf = launch_tile(tile, problem)
    s, f = problem["s"], problem["f"]
    b = dtype_bytes(dtype)
    chunked = cdiv(s, bt) > 1
    # read a, x (twice if chunked), write y; the workspace A, e, h_in.
    hbm = (5 if chunked else 3) * bt * bf * b + (5 * 4 * bf if chunked else 2 * bf * b)
    return TileWorkload(
        flops=(5.0 if chunked else 2.0) * bt * bf,
        hbm_bytes=float(hbm),
        row_segments=bt,                        # one row of bf features a step
        row_stride_bytes=float(f * b),
        threads=cdiv(bf, features_per_thread(bf, f, dtype)),
        extra_launches=2 if chunked else 0,     # the carry and the rescan
    )


def _n_tiles(tile: TileShape, problem: Mapping[str, int]) -> int:
    bt, bf = launch_tile(tile, problem)
    return cdiv(problem["f"], bf) * cdiv(problem["s"], bt)


def _default_tile(problem: Mapping[str, int], dtype: str) -> TileShape:
    # The measured best at recurrentgemma-9b's F = 4096 (PERF.md): 32-step
    # chunks, 128 features a block (in float32 within 1% of the best).
    return TileShape((min(32, problem["s"]), min(128, problem["f"])))


SPEC = registry.register(registry.KernelSpec(
    name="rglru",
    constraints=_constraints,
    vmem_bytes=_vmem_bytes,
    workload=_workload,
    n_tiles=_n_tiles,
    default_tile=_default_tile,
))


__all__ = ["SPEC", "bwd_flops", "features_per_thread", "flops", "launch_tile",
           "rglru", "rglru_ref",
           "rglru_scan", "rglru_scan_backward", "rglru_scan_chunked_ref",
           "rglru_scan_ref"]
