"""Attention block: GQA with RoPE, QKV bias, optional q/k norms, padded heads,
and linear or ring KV caches — the port's ``repro/models/attention.py``.

Dispatch mirrors the reference's ``impl="auto"`` with "is the tensor on
CUDA" in place of ``pallas_enabled()``: on the card the prefill runs the
Hopper flash-attention kernel and decode the Hopper flash-decode kernel,
with the resolved tile or else the spec's Hopper default; on the CPU the
prefill runs the chunked flash reference (``bkv`` from the tile, else 512)
and decode the dense masked attend — or, with a tile, the chunked
flash-decode reference. ``impl="reference"`` forces the plain versions on
either device (the card's parity check holds the kernels against them).

A cache holds its write position ``pos`` as a 0-d int32 tensor on the
cache's device, as the reference traces it. Unlike the reference, which
returns new caches functionally, the port updates a cache in place: prefill
writes K/V (``_linear_write``, ``_ring_write``) and sets ``pos``; decode
writes one K/V row at ``pos`` (linear) or ``pos % W`` (ring), and adds one
to ``pos``, with no read of the position on the host. So one decode step is
a fixed sequence of launches over fixed tensors, which the serving engine
captures into a CUDA graph and replays; calling ``attn_decode`` twice on one
cache decodes two consecutive positions.

Chunked and packed prefill, paged and sequence-sharded decode come in later
slices.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention.decode import flash_decode, flash_decode_ref
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention, launch_tile,
)
from repro_torch.kernels.flash_attention.ref import (
    NEG_INF, fit_bkv, flash_attention_ref,
)
from repro_torch.models.layers import ParamDef, apply_rope, rms_norm

# ---------------------------------------------------------------------------
# Tile-dispatch events: one per call that received a plan tile, saying
# whether the tile legally applied or the lowering degraded to another block.
# ---------------------------------------------------------------------------

_tile_event_sink: Optional[Callable[[Dict[str, Any]], None]] = None


@contextlib.contextmanager
def capture_tile_events(sink: Callable[[Dict[str, Any]], None]):
    """Route tile-dispatch events emitted under this context to ``sink``.

    Events are dicts: ``kernel`` (flash_attention | flash_decode), ``phase``
    (prefill | decode), ``impl`` (the lowering actually used), ``tile`` (the
    requested dims), ``effective`` (what the lowering really used) and
    ``fallback`` (True when the tile did not apply as requested).
    """
    global _tile_event_sink
    prev = _tile_event_sink
    _tile_event_sink = sink
    try:
        yield
    finally:
        _tile_event_sink = prev


def _emit_tile_event(**event) -> None:
    if _tile_event_sink is not None:
        _tile_event_sink(dict(event))


def attn_defs(cfg: ArchConfig) -> Dict[str, ParamDef]:
    d, hd = cfg.d_model, cfg.head_dim_
    h, hkv = cfg.padded_heads, cfg.padded_kv_heads
    defs = {
        "wq": ParamDef((d, h, hd), ("d_model", "heads", None)),
        "wk": ParamDef((d, hkv, hd), ("d_model", "kv_heads", None)),
        "wv": ParamDef((d, hkv, hd), ("d_model", "kv_heads", None)),
        "wo": ParamDef((h, hd, d), ("heads", None, "d_model"), scale=1.0),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((h, hd), ("heads", None), init="zeros")
        defs["bk"] = ParamDef((hkv, hd), ("kv_heads", None), init="zeros")
        defs["bv"] = ParamDef((hkv, hd), ("kv_heads", None), init="zeros")
    if cfg.use_qk_norm:
        defs["q_norm"] = ParamDef((hd,), (None,), init="zeros")
        defs["k_norm"] = ParamDef((hd,), (None,), init="zeros")
    return defs


def make_kv_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
                  ring: bool = False, device=None) -> Dict[str, Any]:
    """k/v [B, Hkv, max_len, hd] and the write position ``pos`` (0-d int32);
    a ring cache adds ``slot_pos`` [max_len] int32, the absolute position
    each slot holds (-1 while unwritten)."""
    hkv, hd = cfg.padded_kv_heads, cfg.head_dim_
    cache = {
        "k": torch.zeros((batch, hkv, max_len, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, hkv, max_len, hd), dtype=dtype, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }
    if ring:
        cache["slot_pos"] = torch.full((max_len,), -1, dtype=torch.int32,
                                       device=device)
    return cache


def reset_kv_cache(cache: Dict[str, Any]) -> Dict[str, Any]:
    """Empty a cache in place for a new sequence: position 0 and, in a ring,
    every slot unwritten. Stale K/V rows stay; the masks hide them."""
    cache["pos"].zero_()
    if "slot_pos" in cache:
        cache["slot_pos"].fill_(-1)
    return cache


def _ring_write(cache, k, v, positions_1d, end_pos):
    """Write a chunk's K/V tail into a ring cache, in place: the last
    ``min(chunk, W)`` positions land at ``pos % W`` with their absolute
    positions recorded in ``slot_pos``. ONE implementation for every
    prefill path, as the reference keeps it."""
    max_len = cache["k"].shape[2]
    keep = min(k.shape[2], max_len)
    pos_tail = positions_1d[-keep:].to(device=cache["k"].device,
                                       dtype=torch.long)
    slots = pos_tail % max_len
    cache["k"].index_copy_(2, slots, k[:, :, -keep:].to(cache["k"].dtype))
    cache["v"].index_copy_(2, slots, v[:, :, -keep:].to(cache["v"].dtype))
    cache["slot_pos"].index_copy_(0, slots, pos_tail.to(torch.int32))
    cache["pos"].fill_(int(end_pos))
    return cache


def _linear_write(cache, k, v, start: int, end_pos: int):
    """Write a chunk's K/V into a linear cache at its static offset ``start``
    — in place, where the reference returns updated arrays
    (``dynamic_update_slice``)."""
    c = k.shape[2]
    cache["k"][:, :, start:start + c] = k.to(cache["k"].dtype)
    cache["v"][:, :, start:start + c] = v.to(cache["v"].dtype)
    cache["pos"].fill_(int(end_pos))
    return cache


def _project_qkv(p, cfg: ArchConfig, x, positions):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if cfg.use_qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    # [B, H, S, hd], contiguous for the kernels.
    return tuple(t.transpose(1, 2).contiguous() for t in (q, k, v))


def _out_proj(p, cfg: ArchConfig, attn_out, x_dtype):
    # Mask padded query heads so they are numerically inert.
    h = cfg.padded_heads
    if h != cfg.n_heads:
        mask = (torch.arange(h, device=attn_out.device) < cfg.n_heads).to(
            attn_out.dtype)
        attn_out = attn_out * mask[None, :, None, None]
    return torch.einsum("bhsk,hkd->bsd", attn_out, p["wo"].to(x_dtype))


def attn_forward(
    p, cfg: ArchConfig, x, positions, *,
    window: Optional[int] = None,
    cache: Optional[Dict[str, Any]] = None,
    impl: str = "auto",
    tile=None,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Whole-sequence attention (prefill). Fills ``cache`` if given.

    ``tile`` is the resolved (bq, bkv) flash-attention tile. ``impl``:
    "auto" runs the kernel on CUDA tensors and the chunked reference on CPU
    tensors; "kernel" / "reference" force one.
    """
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions)
    scale = cfg.query_scale or cfg.head_dim_ ** -0.5
    kwargs = dict(causal=True, window=window,
                  softcap=cfg.attn_softcap or None, scale=scale)
    if impl == "auto":
        impl = "kernel" if x.is_cuda else "reference"
    if impl == "kernel":
        out = flash_attention(q, k, v, tile=tile, **kwargs)
        if tile is not None:
            _emit_tile_event(
                kernel="flash_attention", phase="prefill", impl="kernel",
                tile=tuple(tile), fallback=False,
                effective=launch_tile(tile, q.shape[-1], q.dtype))
    elif impl == "reference":
        chunk = min(int(tile[1]), s) if tile is not None else 512
        if tile is not None:
            # The reference snaps a non-dividing chunk to the largest
            # divisor; count that instead of hiding it.
            effective = fit_bkv(chunk, s)
            _emit_tile_event(kernel="flash_attention", phase="prefill",
                             impl="reference", tile=tuple(tile),
                             effective=effective, fallback=effective != chunk)
        out = flash_attention_ref(q, k, v, chunk=min(chunk, s), **kwargs)
    else:
        raise ValueError(f"unknown attention impl {impl!r}")
    y = _out_proj(p, cfg, out, x.dtype)
    new_cache = None
    if cache is not None:
        if "slot_pos" in cache:
            new_cache = _ring_write(cache, k, v, positions[0], s)
        else:
            new_cache = _linear_write(cache, k, v, 0, s)
    return y, new_cache


def attn_decode(
    p, cfg: ArchConfig, x, *, cache: Dict[str, Any],
    window: Optional[int] = None, tile=None, impl: str = "auto",
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Single-token decode: x [B, 1, D] attends over the cache, which it
    updates in place (the new K/V row, then ``pos`` + 1).

    ``tile`` is the resolved decode tile (last dim ``bkv``). ``impl``: "auto"
    runs the flash-decode kernel on CUDA tensors (tile or Hopper default);
    on CPU tensors the chunked flash-decode reference when a tile is present
    and the dense masked attend otherwise. "kernel", "flash_ref", "dense"
    force a path; "reference" picks the CPU rule on any device. The position
    stays on the device: nothing here reads it on the host.
    """
    b = x.shape[0]
    pos = cache["pos"]                                   # 0-d int32
    positions = pos.to(torch.long).expand(b, 1)
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)  # [B, H(kv), 1, hd]
    scale = cfg.query_scale or cfg.head_dim_ ** -0.5
    ck, cv = cache["k"], cache["v"]
    max_len = ck.shape[2]
    # The cache length bounds a linear cache's position (the engine's
    # admission guarantees it); a ring's slot is pos % W.
    slot = (pos % max_len).to(torch.long).view(1)
    ck.index_copy_(2, slot, k_new.to(ck.dtype))
    cv.index_copy_(2, slot, v_new.to(cv.dtype))
    slot_pos = cache.get("slot_pos")
    if slot_pos is not None:
        slot_pos.index_copy_(0, slot, pos.view(1))

    bkv = int(tile[-1]) if tile is not None else None
    clamped = min(bkv, max_len) if bkv is not None else None
    if impl == "auto":
        impl = "kernel" if x.is_cuda else ("flash_ref" if bkv else "dense")
    elif impl == "reference":
        impl = "flash_ref" if bkv else "dense"
    if tile is not None:
        effective = clamped if impl == "kernel" else fit_bkv(clamped, max_len)
        _emit_tile_event(
            kernel="flash_decode", phase="decode", impl=impl,
            tile=tuple(tile), effective=effective,
            fallback=impl == "dense" or effective != clamped)

    softcap = cfg.attn_softcap or None
    q0 = q[:, :, 0].contiguous()
    if impl == "kernel":
        out = flash_decode(q0, ck, cv, pos=pos, kv_pos=slot_pos, window=window,
                           softcap=softcap, scale=scale, bkv=clamped)
    elif impl == "flash_ref":
        out = flash_decode_ref(q0, ck, cv, pos=pos, kv_pos=slot_pos,
                               window=window, softcap=softcap, scale=scale,
                               bkv=clamped or 512)
    elif impl == "dense":
        if slot_pos is not None:
            k_pos = slot_pos                              # [W] absolute
            valid = k_pos >= 0
        else:
            k_pos = torch.arange(max_len, device=x.device)
            valid = k_pos <= pos
        mask = valid & (k_pos <= pos)
        if window is not None:
            mask &= k_pos > pos - window
        n_rep = cfg.padded_heads // cfg.padded_kv_heads
        ke = ck.repeat_interleave(n_rep, dim=1) if n_rep > 1 else ck
        ve = cv.repeat_interleave(n_rep, dim=1) if n_rep > 1 else cv
        s = torch.einsum("bhk,bhsk->bhs", q0.to(ke.dtype).float(),
                         ke.float()) * scale
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        s = torch.where(mask[None, None], s, NEG_INF)
        pattn = torch.softmax(s, dim=-1).to(ve.dtype)
        out = torch.einsum("bhs,bhsk->bhk", pattn.float(), ve.float())
    else:
        raise ValueError(f"unknown decode impl {impl!r}")
    y = _out_proj(p, cfg, out[:, :, None].to(x.dtype), x.dtype)
    pos.add_(1)
    return y, cache
