"""Plain PyTorch attention of a prompt chunk over positioned keys — the
port's ``repro/kernels/flash_attention/chunked.py``.

A chunk of a multi-step prefill is a *continuation*: its queries sit at
absolute positions ``start .. start+c-1`` and attend causally over the keys
the earlier chunks wrote plus its own. :func:`flash_prefill_chunk_ref`
takes ``q_pos`` / ``kv_pos`` tensors for an arbitrary slot -> position map
(a ring cache's ``slot_pos``), and :func:`flash_prefill_packed_ref` adds
segment tags, so one call serves the chunks of several requests with no
attention across them. They are the plain versions the reference runs on
every backend. On the card the port launches the whole-prompt Hopper
``flash_attention`` kernel instead, at a ``q_offset``, over keys put in
position order (``models.attention._chunk_keys``): a linear cache's
written prefix, or a ring's survivors rotated past its wrap, one launch a
segment in a pack. These functions stay the reference the tests and the
card's checks hold that route against.

Over the paged pool (``serve/pool.py``), :func:`paged_prefix` gathers a
chunk's prefix pages into a positioned linear view and
:func:`flash_prefill_chunk_paged_ref` runs the chunk over it: the CPU path
of a paged chunk, and the card's plain version of it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.decode import paged_gather
from repro_torch.kernels.flash_attention.ref import NEG_INF, fit_bkv


def _as_index(t, device) -> torch.Tensor:
    return torch.as_tensor(t, device=device).to(torch.int64)


def flash_prefill_chunk_ref(
    q, k, v, *, q_pos, kv_pos=None, window: Optional[int] = None,
    softcap: Optional[float] = None, scale: Optional[float] = None,
    bkv: int = 512,
):
    """Online-softmax attention of a prompt chunk over positioned keys.

    q ``[B, Hq, Sq, D]`` at absolute positions ``q_pos`` [Sq]; k/v
    ``[B, Hkv, Skv, D]`` the keys visible to the chunk (the cache history
    and the chunk's own keys), ``kv_pos`` [Skv] each key's absolute
    position (``-1``: never written; default ``arange``). A key is visible
    iff ``0 <= kv_pos <= q_pos`` and, with ``window``, ``kv_pos > q_pos -
    window``. It is :func:`flash_prefill_packed_ref` with one segment.
    """
    sq, skv = q.shape[2], k.shape[2]
    if kv_pos is None:
        kv_pos = torch.arange(skv, device=q.device)
    zeros = torch.zeros
    return flash_prefill_packed_ref(
        q, k, v, q_pos=q_pos, q_seg=zeros(sq, dtype=torch.int64,
                                          device=q.device),
        kv_pos=kv_pos, kv_seg=zeros(skv, dtype=torch.int64, device=q.device),
        window=window, softcap=softcap, scale=scale, bkv=bkv)


def flash_prefill_packed_ref(
    q, k, v, *, q_pos, q_seg, kv_pos, kv_seg,
    window: Optional[int] = None, softcap: Optional[float] = None,
    scale: Optional[float] = None, bkv: int = 512,
):
    """Segment-packed online-softmax attention: N requests, one call.

    q ``[B, Hq, Sq, D]`` concatenates the chunks of N requests along the
    sequence; ``q_pos`` [Sq] is each token's position within its own
    request and ``q_seg`` [Sq] its segment. k/v ``[B, Hkv, Skv, D]``
    concatenate each segment's visible keys, with ``kv_pos`` / ``kv_seg``
    the matching maps. A key is visible iff it is of the query's segment
    and the causal (and window) rule of :func:`flash_prefill_chunk_ref`
    holds. GQA is a grouped contraction (no repeated K/V); the loop streams
    KV in ``bkv`` splits, a non-dividing ``bkv`` snapped to the largest
    divisor of Skv (``fit_bkv``), as the reference does.
    """
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    assert hq % hkv == 0, (hq, hkv)
    n_rep = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    bkv = fit_bkv(bkv, skv)
    dev = q.device
    qp, qs = _as_index(q_pos, dev), _as_index(q_seg, dev)
    kp, ks = _as_index(kv_pos, dev), _as_index(kv_seg, dev)

    qg = q.reshape(b, hkv, n_rep, sq, d).float() * scale
    m = torch.full((b, hkv, n_rep, sq), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, hkv, n_rep, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, n_rep, sq, d), dtype=torch.float32,
                      device=dev)
    for j in range(skv // bkv):
        blk = slice(j * bkv, (j + 1) * bkv)
        s = torch.einsum("bgrqd,bgkd->bgrqk", qg, k[:, :, blk].float())
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        p_blk, s_blk = kp[blk], ks[blk]
        valid = (p_blk[None, :] >= 0) & (p_blk[None, :] <= qp[:, None])
        valid &= s_blk[None, :] == qs[:, None]
        if window is not None:
            valid &= p_blk[None, :] > qp[:, None] - window
        s = torch.where(valid[None, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bgrqk,bgkd->bgrqd", p, v[:, :, blk].float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, hq, sq, d).to(q.dtype)


def paged_prefix(k_pages, v_pages, page_table, n_prefix_pages: int, start):
    """The cache prefix a chunk at ``start`` sees, from the paged pool:
    ``(k, v, kv_pos)``, k/v the first ``n_prefix_pages`` table entries'
    linear view ``[1, Hkv, n_prefix_pages*page, D]`` and ``kv_pos`` each
    row's position, ``-1`` from ``start`` on. The mask hides the unwritten
    tail of a partial last page and, in a page shared by prefix reuse, the
    donor's own rows past the shared length."""
    table = page_table[:n_prefix_pages]
    k = paged_gather(k_pages, table)
    v = paged_gather(v_pages, table)
    pos = torch.arange(k.shape[2], device=k.device)
    return k, v, torch.where(pos < start, pos, -1)


def flash_prefill_chunk_paged_ref(
    q, k_chunk, v_chunk, k_pages, v_pages, page_table, *,
    q_pos, start, n_prefix_pages: int,
    window: Optional[int] = None, softcap: Optional[float] = None,
    scale: Optional[float] = None, bkv: int = 512,
):
    """:func:`flash_prefill_chunk_ref` over a paged prefix: the prefix
    pages (:func:`paged_prefix`), then the chunk's own keys at ``q_pos``."""
    q_pos = _as_index(q_pos, q.device)
    if n_prefix_pages:
        kp, vp, pp = paged_prefix(k_pages, v_pages, page_table,
                                  n_prefix_pages, start)
        k_all = torch.cat([kp, k_chunk.to(kp.dtype)], dim=2)
        v_all = torch.cat([vp, v_chunk.to(vp.dtype)], dim=2)
        kv_pos = torch.cat([pp, q_pos])
    else:
        k_all, v_all, kv_pos = k_chunk, v_chunk, q_pos
    return flash_prefill_chunk_ref(q, k_all, v_all, q_pos=q_pos, kv_pos=kv_pos,
                                   window=window, softcap=softcap, scale=scale,
                                   bkv=bkv)


__all__ = ["flash_prefill_chunk_paged_ref", "flash_prefill_chunk_ref",
           "flash_prefill_packed_ref", "paged_prefix"]
