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

Chunked prefill (:func:`attn_prefill_chunk`) continues a prompt over the
cache its earlier chunks wrote. On the card it always launches the
flash-attention kernel over the chunk's visible keys in position order and
the chunk, at the chunk's ``q_offset`` (the reference gates its Pallas
kernel on the tile dividing the chunk; the port's kernel masks ragged
blocks, so it needs no gate). A linear cache's written prefix is positions
0 .. start-1; a ring's slots hold the same until it wraps, and after it,
positions start-W .. start-1 at slot ``p % W``, in order once rotated by
``start % W`` (:func:`_chunk_keys`). On the CPU a chunk runs the plain
versions the reference runs there: ``flash_attention_ref`` on a linear
cache, the positioned ``flash_prefill_chunk_ref`` on a ring
(``kernels/flash_attention/chunked.py``). Packed prefill
(:func:`attn_prefill_packed`) projects several requests' chunks once; on
the card each segment launches the kernel over its own keys and chunk (one
launch a segment, the math of a chunk), and the CPU runs the reference's
one segment-masked plain call.

A paged cache (``serve/pool.py``) is a layer's dict with the pool's page
tensors ``k_pages`` / ``v_pages`` ``[n_pages, Hkv, page, D]``, the
request's ``table`` ``[n_pt]`` int32 and its ``pos`` (the model merges
them, ``transformer.forward``). Decode writes its row through the table
(``paged_write``, page and offset computed on the device from ``pos``),
gathers the table's linear view (``paged_gather``: slot i is position i)
and attends over it as over a linear cache, ``pos`` masking the unwritten
tail and the unmapped entries. A chunk at ``start`` gathers its
``cdiv(start, page)`` prefix pages; on the card it cuts them to the first
``start`` rows, appends its own K/V and launches ``flash_attention`` at
``q_offset = start`` (:func:`_paged_chunk_keys`), on the CPU it runs the
reference's positioned plain version (``flash_prefill_chunk_paged_ref``).
The engine makes every written page the request's own before the call
(``PagedKVPool.prepare_span``).

Tensor parallelism (``ctx`` with more than one model rank,
``models/context.py``): a rank holds its block of ``wq``, ``bq`` and ``wo``
(its query heads, :func:`local_heads`) and computes attention on those
heads and the KV heads they read, a contiguous range with one local ratio.
Where the model ranks split the KV heads it holds their block of ``wk``,
``wv``, ``bk`` and ``bv``; where they do not (fewer KV heads than ranks),
every rank holds them whole and cuts its range after
``collectives.copy_to_group``, so that a KV head's gradient is the sum
over the ranks that read it. The layer's input and its replicated leaves
(``q_norm``, ``k_norm``) enter through ``copy_to_group`` too, and the
output projection leaves through ``sum_from_group``. Padded query heads are
masked by their global index. A rank's KV cache holds only its KV heads,
except the sequence-sharded decode's, which holds every KV head.

On a mesh with ``flags.DECODE_ATTN_SHARDED`` on, a
linear unpaged cache whose padded KV heads are fewer than the model axis's
ranks, and whose length that axis divides, decodes sequence-sharded (the
reference's ``_decode_attn_sharded``): each rank keeps the ``S / n`` slice
of its model coordinate (``serve_state_shardings``' sequence entry,
:func:`shard_kv_cache`, marked by its ``kv_pos`` map of absolute
positions), only the owner of ``pos`` writes the new K/V (at ``pos %
s_loc``, on the device: no rank branches), each rank runs ``flash_decode``
over its slice with ``kv_pos`` (the kernel on the card, its plain version
on the CPU) and returns its log-sum-exp, and the ranks combine by a max and
a sum over the model group. That body needs every query head (the
reference's takes ``q`` unsplit): the rank's query heads are gathered over
the model group before it, and the rank keeps its own heads of its output
before ``wo``.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.tiling import cdiv
from repro_torch.distributed import collectives
from repro_torch.kernels.flash_attention.chunked import (
    flash_prefill_chunk_paged_ref, flash_prefill_chunk_ref,
    flash_prefill_packed_ref, paged_prefix,
)
from repro_torch.kernels.flash_attention.decode import (
    flash_decode, flash_decode_ref, paged_gather, paged_write,
)
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention, launch_tile,
)
from repro_torch.kernels.flash_attention.ops import chunk_launch_tile
from repro_torch.kernels.flash_attention.ref import (
    NEG_INF, fit_bkv, flash_attention_ref,
)
from repro_torch.models import flags
from repro_torch.models.context import (
    DistContext, has_mesh, local_range, tensor_parallel,
)
from repro_torch.models.layers import (
    ParamDef, apply_rope, rms_norm, runs_kernels,
)

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


HeadRange = Tuple[int, int]


def local_heads(cfg: ArchConfig, ctx: Optional[DistContext]
                ) -> Tuple[HeadRange, HeadRange]:
    """``((q0, q1), (k0, k1))``: the padded query heads this rank computes
    and the KV heads they read (``h // (Hq / Hkv)``), all of them without
    tensor parallelism. The query heads are the rank's block
    (``context.local_range``); the KV heads are its block where the ranks
    split them, else the range its query heads read. Raises where
    a rank's query heads would not map onto whole KV heads with one ratio
    (neither the ranks nor the KV heads divide the other)."""
    hq, hkv = cfg.padded_heads, cfg.padded_kv_heads
    if not tensor_parallel(ctx):
        return (0, hq), (0, hkv)
    q0, q1 = local_range(ctx, "heads", hq) or (0, hq)
    k_block = local_range(ctx, "kv_heads", hkv)
    rep = hq // hkv
    n = q1 - q0
    k0, k1 = q0 // rep, (q1 - 1) // rep + 1
    whole_groups = n >= rep and q0 % rep == 0 and n % rep == 0
    one_group = n < rep and rep % n == 0 and k1 - k0 == 1
    if (q0, q1) == (0, hq) or not (whole_groups or one_group) or (
            k_block not in (None, (k0, k1))):
        raise ValueError(
            f"{cfg.name}: {hq} query heads and {hkv} KV heads do not split "
            f"over {ctx.model_size} model ranks (rank {ctx.model_index}: "
            f"query heads {q0}..{q1 - 1}, KV block {k_block})")
    return (q0, q1), (k0, k1)


def _shards_sequence(cfg: ArchConfig, ctx: Optional[DistContext],
                     length: int) -> bool:
    """Whether a linear cache of ``length`` positions (the whole
    sequence's) decodes sequence-sharded: the switch on, a mesh, fewer
    padded KV heads than model ranks, and a length they divide. Such a
    cache holds every KV head, and its first decode keeps this rank's
    sequence slice."""
    return (flags.DECODE_ATTN_SHARDED and has_mesh(ctx)
            and cfg.padded_kv_heads < ctx.model_size
            and length % ctx.model_size == 0)


def _cache_heads(cfg: ArchConfig, ctx: Optional[DistContext],
                 cache: Optional[Dict[str, Any]]) -> HeadRange:
    """The KV heads a layer projects: those ``cache`` holds (every one for
    the sequence-sharded decode's cache), else the rank's."""
    _, local = local_heads(cfg, ctx)
    if cache is not None and "k" in cache and \
            cache["k"].shape[1] == cfg.padded_kv_heads:
        return 0, cfg.padded_kv_heads
    return local


def _local_kv(cfg: ArchConfig, ctx, kv: HeadRange, *ts):
    """The rank's KV heads of tensors ``[B, H, ...]`` that hold heads
    ``kv`` (views; the tensors themselves when they are the rank's)."""
    _, (k0, k1) = local_heads(cfg, ctx)
    if kv == (k0, k1):
        return ts
    return tuple(t[:, k0 - kv[0]:k1 - kv[0]] for t in ts)


def make_kv_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
                  ring: bool = False, device=None,
                  ctx: Optional[DistContext] = None) -> Dict[str, Any]:
    """k/v [B, Hkv, max_len, hd] and the write position ``pos`` (0-d int32);
    a ring cache adds ``slot_pos`` [max_len] int32, the absolute position
    each slot holds (-1 while unwritten). Under tensor parallelism Hkv is
    the rank's KV heads (:func:`local_heads`), or every KV head for the
    sequence-sharded decode's cache."""
    hd = cfg.head_dim_
    _, (k0, k1) = local_heads(cfg, ctx)
    hkv = (cfg.padded_kv_heads
           if not ring and _shards_sequence(cfg, ctx, max_len) else k1 - k0)
    cache = {
        "k": torch.zeros((batch, hkv, max_len, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, hkv, max_len, hd), dtype=dtype, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }
    if ring:
        cache["slot_pos"] = torch.full((max_len,), -1, dtype=torch.int32,
                                       device=device)
    return cache


def make_paged_kv_pages(cfg: ArchConfig, n_pages: int, page: int, dtype,
                        device=None) -> Dict[str, Any]:
    """One attention layer's share of the paged pool: ``k_pages`` /
    ``v_pages`` ``[n_pages, Hkv, page, hd]``. Requests reach them through
    their page tables; a request's own state keeps only ``pos``
    (``transformer.make_caches(paged=True)``)."""
    hkv, hd = cfg.padded_kv_heads, cfg.head_dim_
    shape = (n_pages, hkv, page, hd)
    return {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
            "v_pages": torch.zeros(shape, dtype=dtype, device=device)}


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


def _project_qkv(p, cfg: ArchConfig, x, positions, ctx=None, kv=None):
    """q on the rank's query heads, k and v on KV heads ``kv`` (default:
    the rank's), each [B, H, S, hd]. Under tensor parallelism ``x`` and the
    leaves every rank holds whole enter through ``copy_to_group`` (whole
    KV leaves are cut to ``kv`` after it)."""
    w = {name: p[name] for name in ("wq", "wk", "wv", "bq", "bk", "bv",
                                    "q_norm", "k_norm") if name in p}
    if tensor_parallel(ctx):
        group = ctx.model_group
        x = collectives.copy_to_group(x, group)
        for name in ("q_norm", "k_norm"):
            if name in w:
                w[name] = collectives.copy_to_group(w[name], group)
        if local_range(ctx, "kv_heads", cfg.padded_kv_heads) is None:
            lo, hi = kv or local_heads(cfg, ctx)[1]
            for name, dim in (("wk", 1), ("wv", 1), ("bk", 0), ("bv", 0)):
                if name in w:
                    w[name] = collectives.copy_to_group(
                        w[name], group).narrow(dim, lo, hi - lo)
        elif kv is not None and kv != local_heads(cfg, ctx)[1]:
            raise ValueError(f"KV heads {kv} are not this rank's block")
    q = torch.einsum("bsd,dhk->bshk", x, w["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, w["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, w["wv"].to(x.dtype))
    if cfg.qkv_bias:
        q = q + w["bq"].to(x.dtype)
        k = k + w["bk"].to(x.dtype)
        v = v + w["bv"].to(x.dtype)
    if cfg.use_qk_norm:
        q = rms_norm(q, w["q_norm"], cfg.norm_eps)
        k = rms_norm(k, w["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    # [B, H, S, hd], contiguous for the kernels.
    return tuple(t.transpose(1, 2).contiguous() for t in (q, k, v))


def _out_proj(p, cfg: ArchConfig, attn_out, x_dtype, ctx=None):
    """``wo`` over the rank's query heads (padded ones masked by their
    global index, so they are numerically inert), summed over the model
    group under tensor parallelism (a rank holding only padded heads adds
    zeros, and still makes the sum)."""
    (q0, q1), _ = local_heads(cfg, ctx)
    if cfg.padded_heads != cfg.n_heads:
        mask = (torch.arange(q0, q1, device=attn_out.device)
                < cfg.n_heads).to(attn_out.dtype)
        attn_out = attn_out * mask[None, :, None, None]
    y = torch.einsum("bhsk,hkd->bsd", attn_out, p["wo"].to(x_dtype))
    if tensor_parallel(ctx):
        y = collectives.sum_from_group(y, ctx.model_group)
    return y


def attn_forward(
    p, cfg: ArchConfig, x, positions, *,
    window: Optional[int] = None,
    cache: Optional[Dict[str, Any]] = None,
    impl: str = "auto",
    tile=None,
    ctx: Optional[DistContext] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Whole-sequence attention (prefill). Fills ``cache`` if given.

    ``tile`` is the resolved (bq, bkv) flash-attention tile. ``impl``:
    "auto" runs the kernel on CUDA tensors and the chunked reference on CPU
    tensors; "kernel" / "reference" force one. ``ctx``: under tensor
    parallelism the rank's heads, the output summed over the model group.
    """
    b, s, _ = x.shape
    kv = _cache_heads(cfg, ctx, cache)
    q, k_all, v_all = _project_qkv(p, cfg, x, positions, ctx, kv)
    k, v = (t.contiguous() for t in _local_kv(cfg, ctx, kv, k_all, v_all))
    scale = cfg.query_scale or cfg.head_dim_ ** -0.5
    kwargs = dict(causal=True, window=window,
                  softcap=cfg.attn_softcap or None, scale=scale)
    if impl == "auto":
        impl = "kernel" if runs_kernels(x) else "reference"
    if impl == "kernel":
        out = flash_attention(q, k, v, tile=tile, **kwargs)
        if tile is not None:
            _emit_tile_event(
                kernel="flash_attention", phase="prefill", impl="kernel",
                tile=tuple(tile), fallback=False,
                effective=launch_tile(tile, q.shape[-1], q.dtype))
    elif impl == "reference":
        chunk = (min(int(tile[1]), s) if tile is not None
                 else 2048 if flags.ANALYSIS_UNROLL else 512)
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
    y = _out_proj(p, cfg, out, x.dtype, ctx)
    new_cache = None
    if cache is not None:
        if "slot_pos" in cache:
            new_cache = _ring_write(cache, k_all, v_all, positions[0], s)
        else:
            new_cache = _linear_write(cache, k_all, v_all, 0, s)
    return y, new_cache


def _ref_bkv(kernel: str, tile, skv: int) -> int:
    """The plain version's KV split: the tile's bkv (clamped to Skv), or
    512; a tile whose split snaps to another divisor of Skv is a
    ``fallback`` event, as in the reference."""
    if tile is None:
        return 512
    requested = min(int(tile[-1]), skv)
    effective = fit_bkv(requested, skv)
    _emit_tile_event(kernel=kernel, phase="prefill", impl="reference",
                     tile=tuple(tile), effective=effective,
                     fallback=effective != requested)
    return requested


def _kernel_tile(kernel: str, tile, cfg: ArchConfig, rows: int, d: int,
                 dtype):
    """The flash-attention tile a ``chunked_prefill`` / ``packed_prefill``
    tile launches for ``rows`` queries (``chunk_launch_tile``), or None
    (the kernel's default) without a tile; a bkv the regime does not
    compile snaps, a ``fallback`` event."""
    if tile is None:
        return None
    launch = chunk_launch_tile(tile, rows, max(cfg.n_heads, 1), d, dtype)
    _emit_tile_event(kernel=kernel, phase="prefill", impl="kernel",
                     tile=tuple(tile), effective=launch,
                     fallback=launch[1] != int(tile[-1]))
    return launch


def _chunk_keys(cache, k, v, start: int):
    """``(k_all, v_all, q_offset)``: the keys a chunk at ``start`` sees, in
    position order, then its own, contiguous as the kernel takes them.
    A linear cache, and a ring before it wraps (``start <= W``), hold
    positions 0 .. start-1 at slots 0 .. start-1. A wrapped ring holds
    positions start-W .. start-1 at slot ``p % W``: rotated by ``start %
    W`` they are in order, and the chunk's queries sit W keys in."""
    w = cache["k"].shape[2]
    if not start:
        return k.contiguous(), v.contiguous(), 0
    if "slot_pos" not in cache or start <= w:
        parts, q_offset = (slice(0, start),), start
    else:
        cut = start % w
        parts, q_offset = (slice(cut, w), slice(0, cut)), w
    k_all = torch.cat([cache["k"][:, :, sl].to(k.dtype) for sl in parts]
                      + [k], dim=2)
    v_all = torch.cat([cache["v"][:, :, sl].to(v.dtype) for sl in parts]
                      + [v], dim=2)
    return k_all, v_all, q_offset


def _paged_chunk_keys(cache, k, v, start: int):
    """:func:`_chunk_keys` of a paged cache: the ``cdiv(start, page)``
    prefix pages gathered, cut to their first ``start`` rows (what the
    plain version masks with ``kv_pos = -1``: a partial page's unwritten
    tail, and a prefix donor's rows past the shared length), then the
    chunk's own K/V, at ``q_offset = start``."""
    if not start:
        return k.contiguous(), v.contiguous(), 0
    n_pp = cdiv(start, cache["k_pages"].shape[2])
    table = cache["table"][:n_pp]
    k_all, v_all = (
        torch.cat([paged_gather(cache[name], table)[:, :, :start].to(t.dtype),
                   t], dim=2)
        for name, t in (("k_pages", k), ("v_pages", v)))
    return k_all, v_all, start


def _paged_write(cache, k, v, start: int, end_pos: int):
    """Write a chunk's K/V through the cache's page table, in place."""
    paged_write(cache["k_pages"], cache["table"], k, start)
    paged_write(cache["v_pages"], cache["table"], v, start)
    cache["pos"].fill_(int(end_pos))
    return cache


def attn_prefill_chunk(
    p, cfg: ArchConfig, x, positions, *,
    cache: Dict[str, Any],
    start: int,
    window: Optional[int] = None,
    impl: str = "auto",
    tile=None,
    ctx: Optional[DistContext] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Continuation prefill of one prompt chunk over the live KV cache.

    ``x`` [B, c, D] holds the chunk's tokens at absolute positions
    ``start .. start+c-1`` (``positions``). The chunk attends causally over
    the K/V that chunks 0..N-1 wrote plus its own — the whole-prompt
    :func:`attn_forward` restricted to these query rows — and writes its
    K/V into the cache in place.

    ``tile`` is the resolved ``chunked_prefill`` tile ``(chunk, bkv)``.
    ``impl`` "auto" launches ``flash_attention`` on CUDA tensors over
    :func:`_chunk_keys` (``bkv`` from the tile, ``bq`` by
    :func:`~repro_torch.kernels.flash_attention.ops.chunk_launch_tile`)
    and runs the reference's plain version on CPU tensors: a linear cache
    ``flash_attention_ref``, a ring ``flash_prefill_chunk_ref`` over its
    slots and the chunk with ``slot_pos`` as ``kv_pos``. A paged cache
    takes :func:`_paged_chunk_keys` on CUDA tensors and
    ``flash_prefill_chunk_paged_ref`` on CPU tensors, and writes through
    its table. "kernel" / "reference" force one (on CPU tensors "kernel"
    runs the wrapper's plain version over the same keys). ``ctx``: under
    tensor parallelism the rank's heads (a cache of every KV head is read
    through the rank's view and written whole).
    """
    c = x.shape[1]
    kv = _cache_heads(cfg, ctx, cache)
    q, k_proj, v_proj = _project_qkv(p, cfg, x, positions, ctx, kv)
    k, v = _local_kv(cfg, ctx, kv, k_proj, v_proj)
    full_cache = cache
    if kv != local_heads(cfg, ctx)[1]:
        cache = dict(cache, **dict(zip(
            ("k", "v"), _local_kv(cfg, ctx, kv, cache["k"], cache["v"]))))
    scale = cfg.query_scale or cfg.head_dim_ ** -0.5
    softcap = cfg.attn_softcap or None
    ring = "slot_pos" in cache
    paged = "k_pages" in cache

    if impl == "auto":
        impl = "kernel" if runs_kernels(x) else "reference"
    if paged and impl == "reference":
        n_pp = cdiv(start, cache["k_pages"].shape[2])
        bkv = _ref_bkv("chunked_prefill", tile,
                       n_pp * cache["k_pages"].shape[2] + c)
        out = flash_prefill_chunk_paged_ref(
            q, k, v, cache["k_pages"], cache["v_pages"], cache["table"],
            q_pos=positions[0], start=start, n_prefix_pages=n_pp,
            window=window, softcap=softcap, scale=scale, bkv=bkv)
    elif impl == "kernel":
        chunk_keys = _paged_chunk_keys if paged else _chunk_keys
        k_all, v_all, q_offset = chunk_keys(cache, k, v, start)
        launch = _kernel_tile("chunked_prefill", tile, cfg, c, q.shape[-1],
                              q.dtype)
        out = flash_attention(q, k_all, v_all, causal=True, window=window,
                              softcap=softcap, scale=scale,
                              q_offset=q_offset, tile=launch)
    elif impl == "reference" and ring:
        k_all = torch.cat([cache["k"].to(k.dtype), k], dim=2)
        v_all = torch.cat([cache["v"].to(v.dtype), v], dim=2)
        kv_pos = torch.cat([cache["slot_pos"].to(positions.dtype),
                            positions[0]])
        bkv = _ref_bkv("chunked_prefill", tile, k_all.shape[2])
        out = flash_prefill_chunk_ref(
            q, k_all, v_all, q_pos=positions[0], kv_pos=kv_pos,
            window=window, softcap=softcap, scale=scale, bkv=bkv)
    elif impl == "reference":
        k_all, v_all, _ = _chunk_keys(cache, k, v, start)
        bkv = _ref_bkv("chunked_prefill", tile, start + c)
        out = flash_attention_ref(q, k_all, v_all, causal=True, window=window,
                                  softcap=softcap, scale=scale,
                                  q_offset=start, chunk=bkv)
    else:
        raise ValueError(f"unknown attention impl {impl!r}")
    cache = full_cache
    if paged:
        _paged_write(cache, k_proj, v_proj, start, start + c)
    elif ring:
        _ring_write(cache, k_proj, v_proj, positions[0], start + c)
    else:
        _linear_write(cache, k_proj, v_proj, start, start + c)
    return _out_proj(p, cfg, out, x.dtype, ctx), cache


def attn_prefill_packed(
    p, cfg: ArchConfig, x, positions, *,
    caches,
    layout,
    window: Optional[int] = None,
    impl: str = "auto",
    tile=None,
):
    """Packed continuation prefill: N requests' chunks, one projection.

    ``x`` [1, S_packed, D] concatenates the chunks of N requests;
    ``layout`` the per-segment ``(start, len)`` pairs and ``positions``
    [1, S_packed] each token's position within its own request; ``caches``
    the matching per-request layer caches (batch 1). Each segment attends
    over its own cache's keys and chunk, never another segment's, so per
    request the math is :func:`attn_prefill_chunk`'s.

    ``tile`` is the resolved ``packed_prefill`` tile ``(pack, bkv)``. On
    CUDA tensors ("auto" or "kernel") each segment launches
    ``flash_attention`` over :func:`_chunk_keys` (linear and ring caches)
    or :func:`_paged_chunk_keys` (paged: one gather from the segment's own
    table); CPU tensors and "reference" run the reference's one
    segment-masked plain call (``flash_prefill_packed_ref``, a paged
    prefix positioned by ``paged_prefix``). Every segment attends before
    any writes, so each reads its prefix as the step found it. Returns
    ``(y [1, S_packed, D], caches)``, each cache written in place.
    """
    b, s_packed, _ = x.shape
    assert b == 1, "packed prefill packs segments, not batch rows"
    assert len(caches) == len(layout) and layout, (len(caches), len(layout))
    q, k, v = _project_qkv(p, cfg, x, positions)
    scale = cfg.query_scale or cfg.head_dim_ ** -0.5
    softcap = cfg.attn_softcap or None
    ring = "slot_pos" in caches[0]
    paged = "k_pages" in caches[0]
    offs = [0]
    for _, ln in layout:
        offs.append(offs[-1] + ln)
    assert offs[-1] == s_packed, (offs, s_packed)
    segs = [slice(offs[i], offs[i + 1]) for i in range(len(layout))]

    if impl == "auto":
        impl = "kernel" if runs_kernels(x) else "reference"
    if impl == "kernel":
        outs = []
        chunk_keys = _paged_chunk_keys if paged else _chunk_keys
        for (start, ln), cache, sl in zip(layout, caches, segs):
            k_all, v_all, q_offset = chunk_keys(cache, k[:, :, sl],
                                                v[:, :, sl], start)
            launch = _kernel_tile("packed_prefill", tile, cfg, ln,
                                  q.shape[-1], q.dtype)
            outs.append(flash_attention(
                q[:, :, sl].contiguous(), k_all, v_all, causal=True,
                window=window, softcap=softcap, scale=scale,
                q_offset=q_offset, tile=launch))
        out = torch.cat(outs, dim=2)
    elif impl == "reference":
        k_parts, v_parts, kvp_parts, kvs_parts = [], [], [], []
        for i, ((start, ln), cache, sl) in enumerate(zip(layout, caches,
                                                         segs)):
            seg_pos = positions[0, sl]
            if paged:
                page = cache["k_pages"].shape[2]
                n_pp = cdiv(start, page)
                if n_pp:
                    kp, vp, pp = paged_prefix(cache["k_pages"],
                                              cache["v_pages"],
                                              cache["table"], n_pp, start)
                    k_parts += [kp.to(k.dtype), k[:, :, sl]]
                    v_parts += [vp.to(v.dtype), v[:, :, sl]]
                    kvp_parts += [pp, seg_pos]
                else:
                    k_parts.append(k[:, :, sl])
                    v_parts.append(v[:, :, sl])
                    kvp_parts.append(seg_pos)
                prefix = n_pp * page
            elif ring:
                k_parts += [cache["k"].to(k.dtype), k[:, :, sl]]
                v_parts += [cache["v"].to(v.dtype), v[:, :, sl]]
                kvp_parts += [cache["slot_pos"].to(seg_pos.dtype), seg_pos]
                prefix = cache["k"].shape[2]
            else:
                k_parts += [cache["k"][:, :, :start].to(k.dtype),
                            k[:, :, sl]]
                v_parts += [cache["v"][:, :, :start].to(v.dtype),
                            v[:, :, sl]]
                kvp_parts += [torch.arange(start, device=x.device), seg_pos]
                prefix = start
            kvs_parts.append(torch.full((prefix + ln,), i, dtype=torch.long,
                                        device=x.device))
        k_all = torch.cat(k_parts, dim=2)
        v_all = torch.cat(v_parts, dim=2)
        q_seg = torch.cat([torch.full((ln,), i, dtype=torch.long,
                                      device=x.device)
                           for i, (_, ln) in enumerate(layout)])
        bkv = _ref_bkv("packed_prefill", tile, k_all.shape[2])
        out = flash_prefill_packed_ref(
            q, k_all, v_all, q_pos=positions[0], q_seg=q_seg,
            kv_pos=torch.cat(kvp_parts), kv_seg=torch.cat(kvs_parts),
            window=window, softcap=softcap, scale=scale, bkv=bkv)
    else:
        raise ValueError(f"unknown attention impl {impl!r}")

    for (start, ln), cache, sl in zip(layout, caches, segs):
        if paged:
            _paged_write(cache, k[:, :, sl], v[:, :, sl], start, start + ln)
        elif ring:
            _ring_write(cache, k[:, :, sl], v[:, :, sl], positions[0, sl],
                        start + ln)
        else:
            _linear_write(cache, k[:, :, sl], v[:, :, sl], start, start + ln)
    return _out_proj(p, cfg, out, x.dtype), tuple(caches)


def sharded_decode_gate(cfg: ArchConfig, ctx: Optional[DistContext],
                        cache: Dict[str, Any]) -> bool:
    """Whether a decode over ``cache`` runs sequence-sharded (the
    reference's gate in ``attn_decode``): the switch on, a mesh, a linear
    unpaged cache, fewer padded KV heads than model ranks, and a cache
    length (the whole sequence's, for a slice) that the model ranks
    divide."""
    if "k_pages" in cache or "slot_pos" in cache or "k" not in cache:
        return False
    n = ctx.model_size if has_mesh(ctx) else 1
    length = cache["k"].shape[2] * (n if "kv_pos" in cache else 1)
    return _shards_sequence(cfg, ctx, length)


def shard_kv_cache(cache: Dict[str, Any], ctx: DistContext
                   ) -> Dict[str, Any]:
    """Keep this rank's sequence slice of a whole linear cache, in place:
    positions ``[i * s_loc, (i + 1) * s_loc)`` of model coordinate ``i``
    (``sharding_rules.serve_state_shardings`` puts the sequence on the
    model axis when the heads do not divide), and ``kv_pos``, the slice's
    absolute positions (int32), which marks the cache as a slice."""
    n, i = ctx.model_size, ctx.model_index
    s_loc = cache["k"].shape[2] // n
    rows = slice(i * s_loc, (i + 1) * s_loc)
    cache["k"] = cache["k"][:, :, rows].contiguous()
    cache["v"] = cache["v"][:, :, rows].contiguous()
    cache["kv_pos"] = i * s_loc + torch.arange(
        s_loc, dtype=torch.int32, device=cache["k"].device)
    return cache


def _decode_attn_sharded(ctx: DistContext, q0, k_new, v_new, cache,
                         window: Optional[int], softcap, scale: float,
                         impl: str):
    """Flash-decoding over the sequence-sharded cache: the owner of
    ``pos`` writes the new row, each rank attends over its slice and the
    partial results combine by their log-sum-exp over the model group
    (a max, then one sum of the weighted outputs and weights: a few KB a
    layer, not the cache). Returns [B, Hq, D] float32."""
    ck, cv, pos = cache["k"], cache["v"], cache["pos"]
    s_loc = ck.shape[2]
    slot = (pos % s_loc).to(torch.long).view(1)
    owner = (pos // s_loc) == ctx.model_index    # on the device: no branch
    for c, new in ((ck, k_new), (cv, v_new)):
        row = torch.where(owner, new.to(c.dtype), c.index_select(2, slot))
        c.index_copy_(2, slot, row)
    kw = dict(pos=pos, kv_pos=cache["kv_pos"], window=window,
              softcap=softcap, scale=scale, return_lse=True)
    if impl in ("auto", "kernel"):
        out, lse = flash_decode(q0, ck, cv, **kw)
    elif impl == "reference":
        out, lse = flash_decode_ref(q0, ck, cv, **kw)
    else:
        raise ValueError(f"the sharded decode runs flash_decode; impl "
                         f"{impl!r} has no sharded form")
    group = ctx.model_group
    top = collectives.all_reduce(lse, "max", group)
    w = torch.exp(lse - top)[..., None]                       # [B, Hq, 1]
    tot = collectives.all_reduce(
        torch.cat([out.float() * w, w], dim=-1), "sum", group)
    d = out.shape[-1]
    return tot[..., :d] / torch.clamp(tot[..., d:], min=1e-30)


def attn_decode(
    p, cfg: ArchConfig, x, *, cache: Dict[str, Any],
    window: Optional[int] = None, tile=None, impl: str = "auto",
    ctx: Optional[DistContext] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Single-token decode: x [B, 1, D] attends over the cache, which it
    updates in place (the new K/V row, then ``pos`` + 1).

    ``tile`` is the resolved decode tile (last dim ``bkv``). ``impl``: "auto"
    runs the flash-decode kernel on CUDA tensors (tile or Hopper default);
    on CPU tensors the chunked flash-decode reference when a tile is present
    and the dense masked attend otherwise. "kernel", "flash_ref", "dense"
    force a path; "reference" picks the CPU rule on any device. The position
    stays on the device: nothing here reads it on the host. A paged cache
    attends over its table's gathered view (``n_pt * page`` rows, the
    length the tile is clamped to) through the same paths.

    With ``ctx`` and :func:`sharded_decode_gate`, the decode runs
    sequence-sharded (a whole cache keeps only this rank's slice from then
    on, :func:`shard_kv_cache`); like the reference's, that path keeps its
    own split (the model axis) and ignores ``tile``. It runs eagerly: its
    collectives (gloo's host-staged ones among them) are not captured in a
    CUDA graph. The cache becomes a slice here, on its first sharded
    decode, whatever made it; ``transformer._mixer`` refuses a slice on any
    other path. Under tensor parallelism the rank decodes its heads; the
    sharded body takes every query head (gathered over the model group)
    and the rank keeps its own heads of the result.
    """
    b = x.shape[0]
    pos = cache["pos"]                                   # 0-d int32
    positions = pos.to(torch.long).expand(b, 1)
    kv = _cache_heads(cfg, ctx, cache)
    # [B, H(kv), 1, hd]
    q, k_new, v_new = _project_qkv(p, cfg, x, positions, ctx, kv)
    scale = cfg.query_scale or cfg.head_dim_ ** -0.5
    if sharded_decode_gate(cfg, ctx, cache):
        if kv != (0, cfg.padded_kv_heads):
            raise ValueError(
                "a sequence-sharded decode needs a cache of every KV head "
                "(make_kv_cache(ctx=) with flags.DECODE_ATTN_SHARDED on)")
        if "kv_pos" not in cache:
            shard_kv_cache(cache, ctx)
        q0 = q[:, :, 0].contiguous()
        (h0, h1), _ = local_heads(cfg, ctx)
        if tensor_parallel(ctx):
            q0 = collectives.all_gather(q0, 1, ctx.model_group)
        out = _decode_attn_sharded(
            ctx, q0, k_new, v_new, cache, window,
            cfg.attn_softcap or None, scale, impl)
        out = out[:, h0:h1]
        y = _out_proj(p, cfg, out[:, :, None].to(x.dtype), x.dtype, ctx)
        pos.add_(1)
        return y, cache
    if kv != local_heads(cfg, ctx)[1]:
        raise ValueError("a cache of every KV head decodes only through the "
                         "sequence-sharded path")
    slot_pos = cache.get("slot_pos")
    if "k_pages" in cache:
        # Batch 1: the row through the table, then the table's linear
        # view, which ``pos`` masks as it masks a linear cache.
        table = cache["table"]
        paged_write(cache["k_pages"], table, k_new, pos)
        paged_write(cache["v_pages"], table, v_new, pos)
        ck = paged_gather(cache["k_pages"], table)
        cv = paged_gather(cache["v_pages"], table)
        max_len = ck.shape[2]
    else:
        ck, cv = cache["k"], cache["v"]
        max_len = ck.shape[2]
        # The cache length bounds a linear cache's position (the engine's
        # admission guarantees it); a ring's slot is pos % W.
        slot = (pos % max_len).to(torch.long).view(1)
        ck.index_copy_(2, slot, k_new.to(ck.dtype))
        cv.index_copy_(2, slot, v_new.to(cv.dtype))
        if slot_pos is not None:
            slot_pos.index_copy_(0, slot, pos.view(1))

    bkv = int(tile[-1]) if tile is not None else None
    clamped = min(bkv, max_len) if bkv is not None else None
    if impl == "auto":
        impl = "kernel" if runs_kernels(x) else ("flash_ref" if bkv else "dense")
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
        n_rep = q0.shape[1] // ck.shape[1]
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
    y = _out_proj(p, cfg, out[:, :, None].to(x.dtype), x.dtype, ctx)
    pos.add_(1)
    return y, cache
