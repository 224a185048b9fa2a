"""Plain PyTorch attention: the versions the CUDA kernels are held against.

``attention_dense_ref`` — O(S^2) materialised oracle, small shapes only.
``flash_attention_ref`` — online softmax chunked over KV blocks, the same
    math as the flash-attention kernel; the lowering the model takes on the
    CPU (``repro/kernels/flash_attention/ref.py``).

Shared semantics: q [B, Hq, Sq, D], k/v [B, Hkv, Skv, D] with Hq % Hkv == 0
(GQA: query head h reads KV head h // n_rep), optional causal mask with
``q_offset`` (queries start at absolute position ``q_offset``), optional
sliding ``window`` (keys with q_pos - window < k_pos <= q_pos) and optional
logit ``softcap`` (s = cap * tanh(s / cap)). Masked logits are NEG_INF =
-2e30, not -inf, and the denominator is clamped at 1e-30, as in the
reference.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import flags

NEG_INF = -2.0e30


def fit_bkv(bkv: int, s: int) -> int:
    """Clamp then snap a KV chunk to the largest divisor of ``s`` <= it."""
    bkv = min(int(bkv), s)
    if s % bkv:
        bkv = next(c for c in range(bkv, 0, -1) if s % c == 0)
    return bkv


def _logits_mask(q_pos, k_pos, causal: bool, window: Optional[int]):
    """[Sq, Skv] boolean mask of *visible* positions."""
    mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    return mask


def attention_dense_ref(
    q, k, v, *, causal: bool = True, window: Optional[int] = None,
    softcap: Optional[float] = None, scale: Optional[float] = None,
    q_offset: int = 0,
):
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    assert hq % hkv == 0
    k = k.repeat_interleave(hq // hkv, dim=1)
    v = v.repeat_interleave(hq // hkv, dim=1)
    scale = scale if scale is not None else d ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    k_pos = torch.arange(skv, device=q.device)
    mask = _logits_mask(q_pos, k_pos, causal, window)
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(),
                        v.float()).to(q.dtype)


def flash_attention_ref(
    q, k, v, *, causal: bool = True, window: Optional[int] = None,
    softcap: Optional[float] = None, scale: Optional[float] = None,
    q_offset: int = 0, chunk: int = 512,
):
    """Online-softmax attention, looped over KV chunks of ``chunk`` keys
    (snapped to the largest divisor of Skv, as the reference does)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    assert hq % hkv == 0, (hq, hkv)
    n_rep = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    chunk = fit_bkv(chunk, skv)
    if n_rep > 1:
        k = k.repeat_interleave(n_rep, dim=1)
        v = v.repeat_interleave(n_rep, dim=1)
    # flags.ATTN_COMPUTE_BF16: the products' operands in the inputs' dtype
    # (the scaled queries and the probabilities rounded to it), their sums
    # and the softmax statistics in float32, as the reference computes.
    cdt = q.dtype if flags.ATTN_COMPUTE_BF16 else torch.float32
    if cdt == torch.float32:
        qf = q.float() * scale
    else:
        qf = (q.to(cdt) * scale).float()
    q_pos = q_offset + torch.arange(sq, device=q.device)
    m = torch.full((b, hq, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hq, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hq, sq, d), dtype=torch.float32, device=q.device)
    for i in range(skv // chunk):
        k_blk = k[:, :, i * chunk:(i + 1) * chunk].float()
        v_blk = v[:, :, i * chunk:(i + 1) * chunk].float()
        k_pos = i * chunk + torch.arange(chunk, device=q.device)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, k_blk)
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        s = torch.where(_logits_mask(q_pos, k_pos, causal, window)[None, None],
                        s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        if cdt != torch.float32:
            p = p.to(cdt).float()
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, v_blk)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)
