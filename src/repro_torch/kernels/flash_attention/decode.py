"""Flash decode: one query per sequence over a KV cache.

``flash_decode``     — wrapper of the Hopper kernel (``csrc/flash_decode.cu``),
    which replaces the Pallas TPU kernel ``repro/kernels/flash_attention/
    decode.py:flash_decode``. CPU tensors take :func:`flash_decode_ref`;
    CUDA tensors launch the kernel or raise.
``flash_decode_ref`` — the same online softmax in plain PyTorch, looped over
    KV splits of ``bkv`` (GQA grouped contraction, no KV repeat).

Shared semantics: q ``[B, Hq, D]``, caches k/v ``[B, Hkv, S, D]``, ``pos``
the absolute position of the query (a Python int: the port's caches keep
their write position on the host). ``kv_pos`` optionally maps cache slot ->
absolute key position (``-1`` marks never-written slots); without it the
cache is linear (slot i holds position i). A key is visible iff
``0 <= kv_pos <= pos`` and, with ``window``, ``kv_pos > pos - window``.
Optional logit ``softcap``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.hardware import H100_SXM
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.flash_attention import HEAD_DIMS
from repro_torch.kernels.flash_attention.ref import NEG_INF, fit_bkv

REP_MAX = 32   # grouped query heads per KV head the kernel keeps resident


def _lib():
    fn = build.load("flash_decode").repro_flash_decode
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def smem_bytes(n_rep: int, bkv: int, d: int) -> int:
    """Shared memory one block of the kernel uses: float32 grouped queries,
    padded K, V, the [n_rep, bkv] logits and three per-row statistics."""
    return 4 * (n_rep * d + bkv * (d + 1) + bkv * d + n_rep * bkv + 3 * n_rep)


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
    bkv: Optional[int] = None,
):
    """q [B, Hq, D] x cache k/v [B, Hkv, S, D] -> [B, Hq, D].

    ``bkv`` is the KV block one loop step streams (default: the spec's
    Hopper tile; on the CPU, the reference's split, default 512). On the
    card it is clamped to S and need not divide it.
    """
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    if k.shape != (b, hkv, s, d) or v.shape != k.shape:
        raise ValueError(f"bad decode shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if hq % hkv:
        raise ValueError(f"GQA requires Hq % Hkv == 0, got {hq}, {hkv}")
    pos = int(pos)
    scale = scale if scale is not None else d ** -0.5
    tensors = (q, k, v) + ((kv_pos,) if kv_pos is not None else ())
    if all(t.device.type == "cpu" for t in tensors):
        return flash_decode_ref(q, k, v, pos=pos, kv_pos=kv_pos, window=window,
                                softcap=softcap, scale=scale,
                                bkv=bkv if bkv is not None else 512)
    build.check_cuda_operands("flash_decode", q, k, v)
    if not 0 <= pos:
        raise ValueError(f"flash_decode pos must be >= 0, got {pos}")
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
    bkv = launch_bkv(bkv, s, d, hq // hkv)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    rc = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                kv_pos.data_ptr() if kv_pos is not None else None,
                out.data_ptr(), b, hq, hkv, s, d, build.dtype_code(q.dtype), bkv, pos,
                float(scale), int(window or 0), float(softcap or 0.0),
                build.stream_ptr(q.device))
    build.check(rc, "flash_decode")
    build.LAUNCHES["flash_decode"] += 1
    return out


def flash_decode_ref(
    q, k, v, *, pos, kv_pos=None, window: Optional[int] = None,
    softcap: Optional[float] = None, scale: Optional[float] = None,
    bkv: int = 512,
):
    """Chunked online-softmax decode over KV splits of ``bkv`` (snapped to
    the largest divisor of the cache length, as the reference does)."""
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
    return out.reshape(b, hq, d).to(q.dtype)


__all__ = ["NEG_INF", "fit_bkv", "flash_decode", "flash_decode_ref",
           "launch_bkv", "smem_bytes"]
