"""Flash decode: one query per sequence over a KV cache.

``flash_decode``     — wrapper of the Hopper kernel (``csrc/flash_decode.cu``),
    which replaces the Pallas TPU kernel ``repro/kernels/flash_attention/
    decode.py:flash_decode``. CPU tensors take :func:`flash_decode_ref`;
    CUDA tensors launch the kernel or raise.
``flash_decode_ref`` — the same online softmax in plain PyTorch, looped over
    KV splits of ``bkv`` (GQA grouped contraction, no KV repeat).
``flash_decode_split_ref`` — the kernel's own arithmetic in plain PyTorch:
    the key blocks split into runs as :func:`decode_splits` lays them out,
    one online-softmax partial per run, then the log-sum-exp combine.

Shared semantics: q ``[B, Hq, D]``, caches k/v ``[B, Hkv, S, D]``, ``pos``
the absolute position of the query: the cache's 0-d int32 position tensor,
which the kernel reads from device memory (so one captured launch serves
every decode step), or a Python int. ``kv_pos`` optionally maps cache slot ->
absolute key position (``-1`` marks never-written slots); without it the
cache is linear (slot i holds position i). A key is visible iff
``0 <= kv_pos <= pos`` and, with ``window``, ``kv_pos > pos - window``.
Optional logit ``softcap``.

The paged pool (``serve/pool.py``) keeps a request's rows in pages behind a
page table: ``pages`` ``[n_pages, Hkv, page, D]``, ``page_table`` ``[n_pt]``
int32, the physical page of each logical page. :func:`paged_gather` lays the
table's pages out as the linear view ``[1, Hkv, n_pt*page, D]`` (slot i is
position i, so ``pos`` masks the unwritten tail and the unmapped entries,
which point at page 0), :func:`paged_write` puts rows through the table in
place, and :func:`flash_decode_paged_ref` is the plain decode over the
view. They are plain PyTorch, as the reference's are plain jnp beside its
Pallas kernel; on the card the model gathers the view and launches
:func:`flash_decode` over it.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.core.hardware import H100_SXM
from repro_torch.core.tiling import cdiv
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.flash_attention import HEAD_DIMS
from repro_torch.kernels.flash_attention.ref import NEG_INF, fit_bkv

REP_MAX = 32   # grouped query heads per KV head the kernel keeps resident


def _lib():
    fn = build.load("flash_decode").repro_flash_decode
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


class DecodeSplits(NamedTuple):
    """Which key blocks of ``bkv`` rows the kernel visits, and how its
    ``splits`` share them: blocks ``[ib_lo, ib_lo + n_blk)``, split ``i`` of
    the first ``used = min(splits, n_blk)`` taking ``[ib_lo + i*n_blk //
    used, ib_lo + (i+1)*n_blk // used)``; the surplus splits get none."""

    ib_lo: int
    n_blk: int
    splits: int

    @property
    def used(self) -> int:
        return max(1, min(self.splits, self.n_blk))

    def runs(self):
        """The (first, end) key blocks of each used split, in order."""
        u, lo, n = self.used, self.ib_lo, self.n_blk
        return [(lo + i * n // u, lo + (i + 1) * n // u) for i in range(u)]


def split_count(groups: int, n_blk: int) -> int:
    """KV splits for ``groups`` = B * Hkv blocks of work: enough for one
    wave of blocks over the card's SMs, at least one key block a split, and
    1 once the groups alone fill the card."""
    sms = H100_SXM.num_sm
    if groups >= sms:
        return 1
    return max(1, min(n_blk, sms // max(groups, 1)))


def decode_splits(b: int, hkv: int, s: int, bkv: int, pos: int,
                  linear: bool, window: Optional[int] = None,
                  splits: Optional[int] = None) -> DecodeSplits:
    """The key blocks a decode visits and their split: the rule each block
    of the kernel applies to the position it reads from device memory. A
    linear cache (slot i = position i) visits only the blocks that hold
    visible keys, ``[max(0, pos - window + 1), pos]``; with a ``kv_pos`` map
    every block. The split count is fixed by the cache length alone (the
    grid of a captured launch cannot follow ``pos``); ``splits`` overrides
    it (tests only)."""
    n_all = cdiv(s, bkv)
    lo, hi = 0, n_all
    if linear:
        hi = min(n_all, pos // bkv + 1)
        if window:
            lo = max(0, pos - window + 1) // bkv
    lo = min(lo, hi)
    n_blk = hi - lo
    if splits is None:
        splits = split_count(b * hkv, n_all)
    return DecodeSplits(lo, n_blk, int(splits))


def threads(d: int) -> int:
    """Threads of one decode block: 256, or where ``d`` does not divide 256
    (80) four rows of it, whole warps. ``threads_for`` in the source is the
    rule; a card test holds the two equal."""
    return 256 if 256 % d == 0 else 4 * d


def smem_bytes(n_rep: int, bkv: int, d: int) -> int:
    """Shared memory one block of the kernel uses: float32 grouped queries,
    padded K, V, the [n_rep, bkv] logits, three per-row statistics and the
    int32 position."""
    return 4 * (n_rep * d + bkv * (d + 1) + bkv * d + n_rep * bkv + 3 * n_rep
                + 1)


def launch_bkv(bkv: int, s: int, d: int, n_rep: int) -> int:
    """The KV block the kernel runs for ``bkv``: clamped to the cache length
    ``s``. Raises ValueError for what the kernel cannot launch."""
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_decode head_dim {d} not in {HEAD_DIMS}")
    if n_rep > REP_MAX:
        raise ValueError(f"flash_decode keeps at most {REP_MAX} grouped "
                         f"query heads per KV head, got {n_rep}")
    bkv = min(int(bkv), s)
    if bkv <= 0:
        raise ValueError(f"flash_decode bkv must be positive, got {bkv}")
    if smem_bytes(n_rep, bkv, d) > H100_SXM.vmem_bytes:
        raise ValueError(f"flash_decode bkv={bkv} needs "
                         f"{smem_bytes(n_rep, bkv, d)} B of shared memory; a "
                         f"block may use {H100_SXM.vmem_bytes}")
    return bkv


def flash_decode(
    q, k, v, *, pos, kv_pos=None, window: Optional[int] = None,
    softcap: Optional[float] = None, scale: Optional[float] = None,
    bkv: Optional[int] = None, return_lse: bool = False,
):
    """q [B, Hq, D] x cache k/v [B, Hkv, S, D] -> [B, Hq, D].

    ``bkv`` is the KV block one loop step streams (default: the spec's
    Hopper tile; on the CPU, the reference's split, default 512). On the
    card it is clamped to S and need not divide it, and the key blocks are
    split over the grid as :func:`decode_splits` lays them out. ``pos`` is
    a 0-d int32 tensor on q's device, which the kernel reads, or an int
    (>= 0), which the wrapper puts into one. ``return_lse`` also returns
    each row's log-sum-exp over the keys it saw (float32 ``[B, Hq]``, the
    logits' ``m + log l``), which ranks holding slices of one sequence
    combine by (``models/attention.py``).
    """
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    if k.shape != (b, hkv, s, d) or v.shape != k.shape:
        raise ValueError(f"bad decode shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if hq % hkv:
        raise ValueError(f"GQA requires Hq % Hkv == 0, got {hq}, {hkv}")
    scale = scale if scale is not None else d ** -0.5
    tensors = (q, k, v) + tuple(t for t in (kv_pos, pos)
                                if isinstance(t, torch.Tensor))
    if all(t.device.type == "cpu" for t in tensors):
        return flash_decode_ref(q, k, v, pos=pos, kv_pos=kv_pos, window=window,
                                softcap=softcap, scale=scale,
                                bkv=bkv if bkv is not None else 512,
                                return_lse=return_lse)
    build.refuse_grad("flash_decode", q, k, v,
                      why="decoding is not on the train path")
    build.check_cuda_operands("flash_decode", q, k, v)
    if isinstance(pos, torch.Tensor):
        if (pos.device != q.device or pos.dtype != torch.int32
                or pos.numel() != 1):
            raise ValueError("flash_decode pos must be an int32 scalar "
                             f"tensor on {q.device}")
    else:
        if int(pos) < 0:
            raise ValueError(f"flash_decode pos must be >= 0, got {pos}")
        # A fill, not a host-to-device copy: it can be captured.
        pos = torch.full((), int(pos), dtype=torch.int32, device=q.device)
    if kv_pos is not None:
        if (kv_pos.device != q.device or kv_pos.dtype != torch.int32
                or kv_pos.shape != (s,) or not kv_pos.is_contiguous()):
            raise ValueError("flash_decode kv_pos must be a contiguous int32 "
                             f"[{s}] tensor on {q.device}")
    if bkv is None:
        from repro_torch.kernels.flash_attention.ops import DECODE_SPEC

        bkv = DECODE_SPEC.default_tile(
            dict(b=b, skv=s, d=d, hq=hq, hkv=hkv, window=window or 0),
            str(q.dtype))[0]
    n_rep = hq // hkv
    bkv = launch_bkv(bkv, s, d, n_rep)
    out = torch.empty_like(q)
    lse = (torch.empty((b, hq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if q.numel() == 0:
        return (out, lse) if return_lse else out
    splits = split_count(b * hkv, cdiv(s, bkv))
    ws_acc = ws_ml = None
    if splits > 1:
        ws_acc = torch.empty((b, hkv, splits, n_rep, d),
                             dtype=torch.float32, device=q.device)
        ws_ml = torch.empty((b, hkv, splits, n_rep, 2),
                            dtype=torch.float32, device=q.device)
    meta = build.is_meta(q, k, v, kv_pos, pos)
    if meta:
        # pos is on the device, so a count takes every key as seen.
        build.meta_work("flash_decode", flops(b, hq, d, s),
                        build.nbytes(q, k, v, kv_pos, pos, out, ws_acc,
                                     ws_ml, lse))
    else:
        rc = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    kv_pos.data_ptr() if kv_pos is not None else None,
                    pos.data_ptr(), out.data_ptr(),
                    ws_acc.data_ptr() if ws_acc is not None else None,
                    ws_ml.data_ptr() if ws_ml is not None else None,
                    lse.data_ptr() if lse is not None else None,
                    b, hq, hkv, s, d, build.dtype_code(q.dtype), bkv,
                    float(scale), int(window or 0), float(softcap or 0.0),
                    splits, build.stream_ptr(q.device))
        build.check(rc, "flash_decode")
    build.launched("flash_decode", meta)
    return (out, lse) if return_lse else out


def flops(b: int, hq: int, d: int, seen: int) -> float:
    """One query a (batch, head) over ``seen`` keys: q k^T and p v, two
    operations a multiply-add."""
    return 4.0 * d * b * hq * seen


def flash_decode_ref(
    q, k, v, *, pos, kv_pos=None, window: Optional[int] = None,
    softcap: Optional[float] = None, scale: Optional[float] = None,
    bkv: int = 512, return_lse: bool = False,
):
    """Chunked online-softmax decode over KV splits of ``bkv`` (snapped to
    the largest divisor of the cache length, as the reference does).
    ``return_lse``: also each row's ``m + log l`` (float32 ``[B, Hq]``)."""
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    assert hq % hkv == 0, (hq, hkv)
    n_rep = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    bkv = fit_bkv(bkv, s)
    if kv_pos is None:
        kv_pos = torch.arange(s, dtype=torch.int32, device=q.device)
    kv_pos = kv_pos.to(q.device)
    qg = q.reshape(b, hkv, n_rep, d).float() * scale
    m = torch.full((b, hkv, n_rep), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, n_rep), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, n_rep, d), dtype=torch.float32, device=q.device)
    for i in range(s // bkv):
        sl = slice(i * bkv, (i + 1) * bkv)
        s_blk = torch.einsum("bgrd,bgkd->bgrk", qg, k[:, :, sl].float())
        if softcap is not None:
            s_blk = softcap * torch.tanh(s_blk / softcap)
        kp = kv_pos[sl]
        valid = (kp >= 0) & (kp <= pos)
        if window is not None:
            valid &= kp > pos - window
        s_blk = torch.where(valid[None, None, None], s_blk, NEG_INF)
        m_new = torch.maximum(m, s_blk.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s_blk - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bgrk,bgkd->bgrd", p, v[:, :, sl].float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.reshape(b, hq, d).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l)).reshape(b, hq)
    return out


def flash_decode_split_ref(
    q, k, v, *, pos, kv_pos=None, window: Optional[int] = None,
    softcap: Optional[float] = None, scale: Optional[float] = None,
    bkv: int = 64, splits: Optional[int] = None,
):
    """The split kernel's arithmetic in plain PyTorch: each used split runs
    the online softmax over its share of the visible key blocks (the last
    block cut at the cache end) into an unnormalised partial with its
    (m, l); the partials are rescaled by exp(m_i - M) and summed in split
    order. ``splits`` defaults to the kernel's count, fixed by S
    (:func:`decode_splits`)."""
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    assert hq % hkv == 0, (hq, hkv)
    n_rep = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    bkv = min(int(bkv), s)
    sp = decode_splits(b, hkv, s, bkv, int(pos), kv_pos is None, window,
                       splits)
    kp_all = (torch.arange(s, dtype=torch.int32, device=q.device)
              if kv_pos is None else kv_pos.to(q.device))
    qg = q.reshape(b, hkv, n_rep, d).float() * scale
    shape = (b, hkv, n_rep)
    parts = []
    for lo, hi in sp.runs():
        m = torch.full(shape, NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros(shape, dtype=torch.float32, device=q.device)
        acc = torch.zeros(shape + (d,), dtype=torch.float32, device=q.device)
        for ib in range(lo, hi):
            sl = slice(ib * bkv, min(s, (ib + 1) * bkv))
            x = torch.einsum("bgrd,bgkd->bgrk", qg, k[:, :, sl].float())
            if softcap is not None:
                x = softcap * torch.tanh(x / softcap)
            kp = kp_all[sl]
            valid = (kp >= 0) & (kp <= pos)
            if window is not None:
                valid &= kp > pos - window
            x = torch.where(valid[None, None, None], x, NEG_INF)
            m_new = torch.maximum(m, x.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(x - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bgrk,bgkd->bgrd", p, v[:, :, sl].float())
            m = m_new
        parts.append((m, l, acc))
    m_all = torch.stack([m for m, _, _ in parts])
    top = m_all.amax(dim=0)
    num = torch.zeros((b, hkv, n_rep, d), dtype=torch.float32, device=q.device)
    den = torch.zeros(shape, dtype=torch.float32, device=q.device)
    for m, l, acc in parts:
        w = torch.exp(m - top)
        den = den + w * l
        num = num + w[..., None] * acc
    out = num / torch.clamp(den, min=1e-30)[..., None]
    return out.reshape(b, hq, d).to(q.dtype)


def paged_gather(pages, page_table):
    """The linear view ``[1, Hkv, n_pt*page, D]`` of one request's pages,
    in one copy (an ``index_select`` over the page axis of the head-major
    view). Rows past the request's written length hold whatever their page
    holds; callers mask them by position."""
    n_pt = page_table.shape[0]
    _, hkv, page, d = pages.shape
    view = pages.transpose(0, 1).index_select(1, page_table)
    return view.reshape(1, hkv, n_pt * page, d)


def paged_write(pages, page_table, x, start):
    """Write ``x`` ``[1, Hkv, c, D]`` into ``pages`` in place at positions
    ``start .. start+c-1``: row i lands in page ``page_table[(start+i) //
    page]`` at offset ``(start+i) % page``. ``start`` is an int or a 0-d
    tensor on the pages' device (a decode's ``pos``, which the page and
    offset are then computed from on the device, so the write can be
    captured). Returns ``pages``."""
    c, page = x.shape[2], pages.shape[2]
    idx = start + torch.arange(c, device=pages.device)
    phys = page_table.index_select(0, idx // page).long()
    pages[phys, :, idx % page] = x[0].transpose(0, 1).to(pages.dtype)
    return pages


def flash_decode_paged_ref(
    q, k_pages, v_pages, page_table, *, pos,
    window: Optional[int] = None, softcap: Optional[float] = None,
    scale: Optional[float] = None, bkv: int = 512,
):
    """:func:`flash_decode_ref` over a paged cache: the table's linear view,
    masked by ``pos`` as a linear cache is."""
    k = paged_gather(k_pages, page_table)
    v = paged_gather(v_pages, page_table)
    return flash_decode_ref(q, k, v, pos=pos, window=window, softcap=softcap,
                            scale=scale, bkv=bkv)


__all__ = ["DecodeSplits", "NEG_INF", "decode_splits", "fit_bkv",
           "flash_decode", "flash_decode_paged_ref", "flash_decode_ref",
           "flash_decode_split_ref", "flops", "launch_bkv", "paged_gather",
           "paged_write", "smem_bytes", "split_count", "threads"]
