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

Gradients (:class:`_SsdScanFn`, :func:`ssd_scan_backward`): the forward
keeps that workspace (the state entering every chunk); the backward runs
the three launches on the time-reversed problem, read in place (``repro_ssd``
with ``reverse = 1``, whose output launch also forms d log_a's dot
products), then ``repro_ssd_bwd`` once for dB and dC, counted once under
``ssd_bwd``.
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
    compute_dtype, discretize, ssd_chunk_states_ref, ssd_chunked_ref, ssd_ref,
    ssd_db_dc_ref, ssd_scan_bwd_ref, ssd_scan_ref, ssd_scan_rev_ref,
    ssd_scan_split_ref,
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
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _layout() -> Dict[str, int]:
    """The kernels' tile constants (``constexpr int`` in ``csrc/ssd.cu``):
    TQ time rows and TP state columns a tile, QMAX the longest chunk, TN
    the N columns of a backward block."""
    text = (build.CSRC / build.SOURCES["ssd"]).read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (TQ|TP|TN|QMAX) = (\d+);", text)}


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


def bwd_stages(p: int, q: int, hpb: int, dtype) -> int:
    """The stages of a ``repro_ssd_bwd`` block's head pipeline (``bwd_stages``
    in ``csrc/ssd.cu``): two where they fit a block's shared memory, else
    one; 0 where not even one does (the kernel refuses)."""
    for stages in (2, 1):
        if _bwd_smem(p, q, hpb, stages, dtype) <= H100_SXM.vmem_bytes:
            return stages
    return 0


def _bwd_smem(p, q, hpb, stages, dtype):
    c, es = _layout(), dtype_bytes(dtype)
    tq, tn = c["TQ"], c["TN"]
    pk = p if es == 4 else cdiv(p, 16) * 16
    stage = 2 * es * tq * (p + 8) + 4 * tn * (pk + 8)
    return (stages * stage + es * tq * (tn + (4 if es == 4 else 8))
            + es * 4 * 16 * (tq + 8) + 4 * hpb * cdiv(q, 32) * 32)


def smem_bwd_bytes(p: int, q: int, hpb: int, dtype) -> int:
    """Shared memory of a ``repro_ssd_bwd`` block (``bwd_smem`` in
    ``csrc/ssd.cu``) at head width ``p``, chunk ``q`` and ``hpb`` heads a
    block, at :func:`bwd_stages` (one if none fits): each stage dy and x
    rows [TQ, P + 8] and float32 h_in rows [TN, Pk + 8] (Pk: P rounded up
    to 16 in bf16); then B columns [TQ, TN + 4] (TN + 8 in bf16), the
    scores [4, 16, TQ + 8], and the heads' cumsums [hpb, q rounded up to
    32] float32; all but h_in and the cumsums in the input's type."""
    return _bwd_smem(p, q, hpb, max(1, bwd_stages(p, q, hpb, dtype)), dtype)


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
    chunk need not divide S. Under grad mode, with an input that requires
    grad, CUDA tensors go through :class:`_SsdScanFn`, whose backward
    launches the kernels too. Under ``flags.SSD_COMPUTE_BF16`` float32
    CUDA (or ``meta``) tensors run the kernels' bf16 mode; CPU tensors the
    plain scan with bf16 products.
    """
    b, s, h, p = dtx.shape
    n = Bm.shape[-1]
    if (log_a.shape != (b, h, s) or Bm.shape != (b, s, n) or C.shape != Bm.shape
            or h0.shape != (b, h, n, p)):
        raise ValueError(f"bad ssd shapes log_a {tuple(log_a.shape)} dtx "
                         f"{tuple(dtx.shape)} B {tuple(Bm.shape)} C "
                         f"{tuple(C.shape)} h0 {tuple(h0.shape)}")
    tensors = (log_a, dtx, Bm, C, h0)
    on_cpu = all(t.device.type == "cpu" for t in tensors)
    if not on_cpu and compute_dtype() is not None \
            and dtx.dtype == torch.float32:
        # The reference's SSD_COMPUTE_BF16: the kernels' bf16 mode on bf16
        # copies, y and the state back in float32.
        y, h_last = ssd_scan(*(t.to(torch.bfloat16) for t in tensors),
                             chunk=chunk)
        return y.to(dtx.dtype), h_last.to(h0.dtype)
    if chunk is None:
        chunk = SPEC.default_tile(dict(s=s, h=h, p=p, n=n), str(dtx.dtype))[0]
    if on_cpu:
        return ssd_scan_ref(log_a, dtx, Bm, C, h0, chunk=chunk,
                            compute_dtype=compute_dtype())
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _SsdScanFn.apply(log_a, dtx, Bm, C, h0, chunk)
    y, h_last, _ = _ssd_cuda(log_a, dtx, Bm, C, h0, chunk)
    build.launched("ssd", dtx.is_meta)
    return y, h_last


def _ssd_cuda(log_a, dtx, Bm, C, h0, chunk):
    """One run of the forward kernels (uncounted, no autograd history) ->
    (y, h_last, the state entering each chunk as [B, H, nc, N, P] float32,
    or None with one chunk: then h0 is that state)."""
    b, s, h, p = dtx.shape
    n = Bm.shape[-1]
    build.check_cuda_operands("ssd", log_a, dtx, Bm, C, h0)
    problem = dict(s=s, h=h, p=p, n=n)
    q = launch_chunk(chunk, problem, dtx.dtype)
    if any(t.data_ptr() % 16 for t in (dtx, Bm, C, h0)):
        raise ValueError("ssd needs dtx, B, C and h0 to start on 16 bytes")
    y = torch.empty_like(dtx)
    h_last = torch.empty_like(h0)
    if y.numel() == 0:
        return y, h_last, None
    ws = decay = None
    nc = cdiv(s, q)
    if nc > 1:
        ws = torch.empty((b, h, nc, n, p), dtype=torch.float32,
                         device=dtx.device)
        decay = torch.empty(nc * b * h, dtype=torch.float32, device=dtx.device)
    if build.is_meta(log_a, dtx, Bm, C, h0):
        build.meta_work("ssd", b * flops(q, problem),
                        build.nbytes(log_a, dtx, Bm, C, h0, y, h_last, ws,
                                     decay))
        return y, h_last, ws
    rc = _lib()(log_a.data_ptr(), dtx.data_ptr(), Bm.data_ptr(), C.data_ptr(),
                h0.data_ptr(), y.data_ptr(), h_last.data_ptr(),
                None if ws is None else ws.data_ptr(),
                None if decay is None else decay.data_ptr(), None, None, None,
                b, h, s, p, n, q, 0, build.dtype_code(dtx.dtype),
                build.stream_ptr(dtx.device))
    build.check(rc, "ssd")
    return y, h_last, ws


def _ssd_rev_cuda(log_a, dy, C, Bm, dh_last, y, dtx, chunk):
    """The adjoint scan (uncounted): ``repro_ssd`` reversed, read in place,
    on (log_a, dtx' = dy, B' = C, C' = Bm, h0' = dh_last), with d log_a's dot
    products -> (d dtx [B, S, H, P], the adjoint state at step 0 [B, H, N,
    P], the adjoint scan's chunk states [B, H, nc, N, P] float32 or None
    with one chunk, <dy_t, y_t> - <dtx_t, d dtx_t> over P as float32
    [B, H, S]). :func:`ssd_scan_rev_ref` is its plain version."""
    b, s, h, p = dy.shape
    n = Bm.shape[-1]
    build.check_cuda_operands("ssd_bwd", log_a, dy, C, Bm, dh_last, y, dtx)
    q = launch_chunk(chunk, dict(s=s, h=h, p=p, n=n), dy.dtype)
    if any(t.data_ptr() % 16 for t in (dy, C, Bm, dh_last, y, dtx)):
        raise ValueError("ssd's reversed scan needs dy, C, B, dh_last, y and "
                         "dtx to start on 16 bytes")
    d_dtx = torch.empty_like(dy)
    g0 = torch.empty_like(dh_last)
    parts = 1 if s == 1 else cdiv(p, _layout()["TP"])
    dots = torch.empty((parts, b, h, s), dtype=torch.float32, device=dy.device)
    ws = decay = None
    nc = cdiv(s, q)
    if nc > 1:
        ws = torch.empty((b, h, nc, n, p), dtype=torch.float32,
                         device=dy.device)
        decay = torch.empty(nc * b * h, dtype=torch.float32, device=dy.device)
    if build.is_meta(log_a, dy, C, Bm, dh_last, y, dtx):
        # The forward kernels' operations on the reversed problem, and d
        # log_a's two dot products a step, head and column.
        build.meta_work("ssd_bwd", b * flops(q, dict(s=s, h=h, p=p, n=n))
                        + 4.0 * b * s * h * p,
                        build.nbytes(log_a, dy, C, Bm, dh_last, y, dtx,
                                     d_dtx, g0, dots, ws, decay))
    elif dy.numel():
        rc = _lib()(log_a.data_ptr(), dy.data_ptr(), C.data_ptr(),
                    Bm.data_ptr(), dh_last.data_ptr(), d_dtx.data_ptr(),
                    g0.data_ptr(), None if ws is None else ws.data_ptr(),
                    None if decay is None else decay.data_ptr(), y.data_ptr(),
                    dtx.data_ptr(), dots.data_ptr(), b, h, s, p, n, q, 1,
                    build.dtype_code(dy.dtype), build.stream_ptr(dy.device))
        build.check(rc, "ssd_bwd")
    else:
        dots.zero_()
    return d_dtx, g0, ws, dots[0] if parts == 1 else dots.sum(0)


def _bwd_lib():
    fn = build.load("ssd").repro_ssd_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _bwd_smem_lib():
    fn = build.load("ssd").repro_ssd_bwd_smem
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 4
        fn.restype = ctypes.c_longlong
    return fn


def bwd_heads_per_block(b: int, s: int, q: int, h: int, n: int, p: int,
                        dtype) -> int:
    """Heads a ``repro_ssd_bwd`` block walks: the heads are split into
    ceil(H / this) groups, whose float32 partials are summed after. A block
    takes a whole SM, and its time grows with its heads plus about one (its
    cumsums, B tiles and partial), so the split taken is the one with the
    fewest waves of blocks over the SMs times (heads a block + 1), among
    those whose block keeps two pipeline stages (any that fits if none
    does); the fewer groups on a tie. At mamba2-2.7b's width both shapes of
    the train step and S = 4096 give one group: 128 blocks, one wave."""
    tq, tn = _layout()["TQ"], _layout()["TN"]
    # Live blocks of one group (row tiles past a ragged chunk's end return).
    blocks = ((s // q) * cdiv(q, tq) + cdiv(s % q, tq)) * cdiv(n, tn) * 2 * b
    sizes = sorted({cdiv(h, g) for g in range(1, h + 1)}, reverse=True)
    for want in (2, 1):
        fits = [hpb for hpb in sizes if bwd_stages(p, q, hpb, dtype) >= want]
        if fits:
            return min(fits, key=lambda hpb: cdiv(
                blocks * cdiv(h, hpb), H100_SXM.num_sm) * (hpb + 1))
    raise ValueError(f"ssd's backward at P = {p}, chunk {q} needs "
                     f"{smem_bwd_bytes(p, q, 1, dtype)} B of shared memory; "
                     f"a block may use {H100_SXM.vmem_bytes}")


def _ssd_bwd_cuda(log_a, dtx, Bm, C, dy, h0, dh_last, h_in, r_h_in, chunk):
    """One launch of ``repro_ssd_bwd`` (uncounted) -> (dB, dC) [B, S, N] in
    dy's dtype: :func:`ssd_scan_bwd_ref` of the forward scan against dy
    (dC) and of the reversed scan against dtx (dB), with ``h_in`` and
    ``r_h_in`` the two scans' chunk states (None: one chunk, h0 and
    dh_last). :func:`ssd_db_dc_ref` is its plain version."""
    b, s, h, p = dtx.shape
    n = Bm.shape[-1]
    build.check_cuda_operands("ssd_bwd", log_a, dtx, Bm, C, dy, h0, dh_last)
    q = launch_chunk(chunk, dict(s=s, h=h, p=p, n=n), dtx.dtype)
    nc = cdiv(s, q)
    for states in (h_in, r_h_in):
        if nc > 1 and (states is None or states.shape != (b, h, nc, n, p)
                       or states.dtype != torch.float32
                       or not states.is_contiguous()):
            raise ValueError("ssd's backward needs the chunk states as a "
                             "contiguous float32 [B, H, nc, N, P]")
    if any(t.data_ptr() % 16 for t in (dtx, Bm, C, dy, h0, dh_last)):
        raise ValueError("ssd's backward needs dtx, B, C, dy, h0 and dh_last "
                         "to start on 16 bytes")
    hpb = bwd_heads_per_block(b, s, q, h, n, p, dtx.dtype)
    groups = cdiv(h, hpb)
    part = torch.empty((groups, 2, b, s, n), dtype=torch.float32,
                       device=dy.device)
    if build.is_meta(log_a, dtx, Bm, C, dy, h0, dh_last, h_in, r_h_in):
        # bwd_flops less the reversed forward's: dC's and dB's products.
        problem = dict(s=s, h=h, p=p, n=n)
        build.meta_work("ssd_bwd", b * (bwd_flops(q, problem)
                                        - flops(q, problem)),
                        build.nbytes(log_a, dtx, Bm, C, dy, h0, dh_last,
                                     h_in, r_h_in, part))
    elif part.numel():
        rc = _bwd_lib()(log_a.data_ptr(), dtx.data_ptr(), Bm.data_ptr(),
                        C.data_ptr(), dy.data_ptr(), h0.data_ptr(),
                        dh_last.data_ptr(),
                        None if nc == 1 else h_in.data_ptr(),
                        None if nc == 1 else r_h_in.data_ptr(),
                        part.data_ptr(), b, h, s, p, n, q, hpb,
                        build.dtype_code(dtx.dtype), build.stream_ptr(dy.device))
        build.check(rc, "ssd_bwd")
    total = part[0] if groups == 1 else part.sum(0)
    return total[1].to(dy.dtype), total[0].to(dy.dtype)


def ssd_scan_backward(log_a, dtx, Bm, C, h0, y, h_last, h_in, dy, dh_last,
                      chunk, scan_rev, db_dc):
    """The scan's gradients (d log_a, d dtx, dB, dC, dh0) from dy [B, S, H, P]
    and dh_last [B, H, N, P] (None: zero), given the forward's y, h_last and
    chunk states ``h_in`` (None with one chunk).

    The adjoint state g_t = dL/dh_t obeys g_t = a_{t+1} g_{t+1} + C_t dy_t^T
    from g_{S-1} = C dy^T + dh_last: the scan itself run backward in time
    with log_a' = [0, log_a reversed without its first step], dtx' = dy,
    B' = C and C' = B, h0' = dh_last, each read reversed.
    ``scan_rev(log_a, dy, C, Bm, dh_last, y, dtx, chunk) -> (d dtx, g_0,
    its chunk states, dcum)`` runs it (:func:`_ssd_rev_cuda`,
    :func:`ssd_scan_rev_ref`): d dtx_t = B_t . g_t is its output at forward
    steps, and dcum [B, H, S] float32 is <dy_t, y_t> - <dtx_t, d dtx_t>
    over P. So

    - dh0 = a_0 g_0 = exp(log_a_0) g_0;
    - ``db_dc(log_a, dtx, Bm, C, dy, h0, dh_last, h_in, r_h_in, chunk) ->
      (dB, dC)`` (:func:`_ssd_bwd_cuda`, :func:`ssd_db_dc_ref`): dC of the
      forward scan against dy, dB of the reversed one against dtx;
    - d log_a is the reverse cumulative sum over t of dcum, with <dh_last,
      h_last> added at t = S - 1.

    CPU tests run it with the plain versions in the kernels' place.
    """
    if dh_last is None:
        dh_last = torch.zeros_like(h0)
    dy = dy.contiguous()
    dh_last = dh_last.contiguous()
    d_dtx, g0, r_h_in, dcum = scan_rev(log_a, dy, C, Bm, dh_last, y, dtx, chunk)
    dB, dC = db_dc(log_a, dtx, Bm, C, dy, h0, dh_last, h_in, r_h_in, chunk)
    d_log_a, dh0 = ssd_bwd_tail(log_a, h_last, dh_last, g0, dcum)
    return d_log_a, d_dtx, dB, dC, dh0


def ssd_bwd_tail(log_a, h_last, dh_last, g0, dcum):
    """The backward's last PyTorch ops -> (d log_a, dh0): <dh_last, h_last>
    added to ``dcum`` (in place) at the last step, its reverse cumulative
    sum over [B, H, S], and dh0 = exp(log_a_0) g0, in g0's place when it is
    float32 (no temporary of the state's size)."""
    b, h, s = dcum.shape
    a0 = torch.exp(log_a[:, :, 0].float())[..., None, None]
    dh0 = (g0.mul_(a0) if g0.dtype == torch.float32
           else (g0.float() * a0).to(g0.dtype))
    # <dh_last, h_last> a (b, h) as a batched product: no [B, H, N, P]
    # float32 temporary.
    m = h_last[0, 0].numel()
    dcum[:, :, s - 1] += torch.bmm(
        dh_last.reshape(b * h, 1, m).float(),
        h_last.reshape(b * h, m, 1).float()).reshape(b, h)
    # The reverse cumulative sum as the total less the sum before each step:
    # no flipped copy.
    d_log_a = dcum.sum(2, keepdim=True) - dcum.cumsum(2) + dcum
    return d_log_a.to(log_a.dtype), dh0


class _SsdScanFn(torch.autograd.Function):
    """The chunk scan through the kernels, forward and backward. The forward
    is ``repro_ssd`` (counted under ``ssd``) and keeps its chunk states; the
    backward (:func:`ssd_scan_backward`, counted once under ``ssd_bwd``)
    runs ``repro_ssd`` reversed and ``repro_ssd_bwd`` once.
    The reference differentiates its jnp scan through JAX; the gradients are
    the same function's."""

    @staticmethod
    def forward(ctx, log_a, dtx, Bm, C, h0, chunk):
        y, h_last, h_in = _ssd_cuda(log_a, dtx, Bm, C, h0, chunk)
        build.launched("ssd", dtx.is_meta)
        ctx.chunk = chunk
        ctx.save_for_backward(log_a, dtx, Bm, C, h0, y, h_last, h_in)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        log_a, dtx, Bm, C, h0, y, h_last, h_in = ctx.saved_tensors
        grads = ssd_scan_backward(log_a, dtx, Bm, C, h0, y, h_last, h_in, dy,
                                  dh_last, ctx.chunk, _ssd_rev_cuda,
                                  _ssd_bwd_cuda)
        build.launched("ssd_bwd", dtx.is_meta)
        return (*grads, None)


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


def bwd_flops(q: int, problem: Mapping[str, int]) -> float:
    """The backward's operations at chunk ``q`` (one batch row): the
    forward's (:func:`flops`) on the reversed problem, and
    ``repro_ssd_bwd``'s products for each of dC and dB (one launch): per
    chunk of L steps and head,
    L (L + 1) / 2 causal pairs for dy . x and for scores . B, and L N P
    products for dy . h_in; two operations a product."""
    s, h, p, n = problem["s"], problem["h"], problem["p"], problem["n"]
    q = min(q, s)

    def chunk(ln):
        return ln * (ln + 1) * (n + p) + 2.0 * ln * n * p

    return flops(q, problem) + 2 * h * ((s // q) * chunk(q) + chunk(s % q))


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


__all__ = ["SPEC", "bwd_flops", "bwd_stages", "flops",
           "launch_chunk", "smem_bwd_bytes", "smem_bytes", "ssd",
           "ssd_bwd_tail", "ssd_chunk_states_ref", "ssd_chunked_ref",
           "ssd_db_dc_ref", "ssd_ref", "ssd_scan", "ssd_scan_backward",
           "ssd_scan_bwd_ref", "ssd_scan_ref", "ssd_scan_rev_ref",
           "ssd_scan_split_ref", "workspace_floats"]
