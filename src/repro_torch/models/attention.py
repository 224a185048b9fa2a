"""Attention block: GQA with RoPE, QKV bias, optional q/k norms, padded heads,
and a linear KV cache — the port's ``repro/models/attention.py``.

Dispatch mirrors the reference's ``impl="auto"`` with "is the tensor on
CUDA" in place of ``pallas_enabled()``: on the card the prefill runs the
Hopper flash-attention kernel and decode the Hopper flash-decode kernel,
with the resolved tile or else the spec's Hopper default; on the CPU the
prefill runs the chunked flash reference (``bkv`` from the tile, else 512)
and decode the dense masked attend — or, with a tile, the chunked
flash-decode reference. ``impl="reference"`` forces the plain versions on
either device (the card's parity check holds the kernels against them).

Unlike the reference, which returns new caches functionally, the port writes
K/V into the cache tensors in place (``_linear_write`` and the decode write);
the write position ``pos`` is a Python int returned in a new cache dict, so
calling twice on one cache dict rewrites the same slots.

Ring-buffer caches, chunked and packed prefill, paged and sequence-sharded
decode come in later slices.
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
    """A linear cache: k/v [B, Hkv, max_len, hd] and the write position."""
    if ring:
        raise NotImplementedError("ring-buffer KV caches are not ported yet")
    hkv, hd = cfg.padded_kv_heads, cfg.head_dim_
    return {
        "k": torch.zeros((batch, hkv, max_len, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, hkv, max_len, hd), dtype=dtype, device=device),
        "pos": 0,
    }


def _linear_write(cache, k, v, start: int, end_pos: int):
    """Write a chunk's K/V into a linear cache at ``start`` — in place, where
    the reference returns updated arrays (``dynamic_update_slice``)."""
    c = k.shape[2]
    cache["k"][:, :, start:start + c] = k.to(cache["k"].dtype)
    cache["v"][:, :, start:start + c] = v.to(cache["v"].dtype)
    return {"k": cache["k"], "v": cache["v"], "pos": int(end_pos)}


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
    new_cache = _linear_write(cache, k, v, 0, s) if cache is not None else None
    return y, new_cache


def attn_decode(
    p, cfg: ArchConfig, x, *, cache: Dict[str, Any],
    window: Optional[int] = None, tile=None, impl: str = "auto",
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Single-token decode: x [B, 1, D] attends over the linear cache.

    ``tile`` is the resolved decode tile (last dim ``bkv``). ``impl``: "auto"
    runs the flash-decode kernel on CUDA tensors (tile or Hopper default);
    on CPU tensors the chunked flash-decode reference when a tile is present
    and the dense masked attend otherwise. "kernel", "flash_ref", "dense"
    force a path; "reference" picks the CPU rule on any device.
    """
    b = x.shape[0]
    pos = int(cache["pos"])
    positions = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)  # [B, H(kv), 1, hd]
    scale = cfg.query_scale or cfg.head_dim_ ** -0.5
    ck, cv = cache["k"], cache["v"]
    max_len = ck.shape[2]
    if pos >= max_len:
        raise ValueError(f"decode position {pos} is past the cache ({max_len})")
    ck[:, :, pos] = k_new[:, :, 0].to(ck.dtype)
    cv[:, :, pos] = v_new[:, :, 0].to(cv.dtype)

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
        out = flash_decode(q0, ck, cv, pos=pos, window=window,
                           softcap=softcap, scale=scale, bkv=clamped)
    elif impl == "flash_ref":
        out = flash_decode_ref(q0, ck, cv, pos=pos, window=window,
                               softcap=softcap, scale=scale,
                               bkv=clamped or 512)
    elif impl == "dense":
        k_pos = torch.arange(max_len, device=x.device)
        mask = k_pos <= pos
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
    return y, {"k": ck, "v": cv, "pos": pos + 1}
