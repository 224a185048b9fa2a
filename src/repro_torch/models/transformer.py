"""Decoder stack, dense path — the port's ``repro/models/transformer.py``.

The reference groups identical layers into segments and runs each with
``jax.lax.scan``; eager PyTorch has no use for that, so the port keeps one
parameter dict per layer (``params["layers"]``, in layer order) and runs the
stack as a Python loop. :func:`decompose` is kept because the JAX parameter
tree is laid out by it (``models/convert.py`` unstacks it).

The mixers are attention (global and local), RG-LRU (``models/rglru.py``)
and SSD (``models/ssm.py``), with the dense feed-forward, the MoE block
(``models/moe.py``) or none; a layer returns its MoE aux loss, which the
stack sums into ``StackOutputs.aux_loss`` as the reference does (serving
ignores it). A vision model (internvl2) projects its patch embeddings with
``vit_proj`` and prepends them to the tokens (``forward(patch_embeds=)``);
the encoder-decoder backbone is ``models/encdec.py``. Each layer keeps its
own cache: a KV cache on an attention layer, the carried conv tails and
recurrent state on an RG-LRU or SSD layer.

``forward(chunked=True)`` runs one chunk of a multi-step prefill from
``start_pos``: attention continues over the cache (``attn_prefill_chunk``)
and the recurrent layers from their carried state, which is what they do
anyway. :func:`forward_packed` runs the chunks of several requests as one
sequence through the embedding, norms and FF, each attention and recurrent
layer per request's state. An MoE layer routes the tokens it is given
together: a chunk's capacity counts the chunk's tokens, a pack's the
pack's, as in the reference.

Training: ``forward(remat=True)`` runs each layer under
``torch.utils.checkpoint`` (the reference checkpoints its scanned layers),
so the backward recomputes one layer at a time, kernels included;
:func:`fused_lm_loss` is the head and cross-entropy over sequence chunks,
each chunk checkpointed, and :func:`lm_loss` the plain cross-entropy over
given logits.

Tensor parallelism (``ctx`` with more than one model rank,
``models/context.py``): each rank holds its block of the embedding (rows of
its vocabulary range), the head (its columns), each layer's attention heads
(``models/attention.py``), FF columns, experts (``models/moe.py``), RG-LRU
features (``models/rglru.py``) and SSD heads (``models/ssm.py``). The
embedding lookup is vocab-parallel (a token outside the rank's range looks
up zeros, then a sum over the model group); the dense FF is column-parallel
``w1`` / ``w3`` and row-parallel ``w2`` with one sum; the head is
column-parallel, and serving's logits are gathered whole over the
vocabulary (outside autograd); the losses are vocab-parallel cross-entropy
on the rank's logits block (:func:`_nll`). Padded vocabulary columns are
masked by their global index.

FSDP (``ctx`` with ``context.data_sharded``): each leaf is also the rank's
block over the data axis (``context.data_dim``). :func:`forward` gathers a
layer's blocks over the data group inside the function it checkpoints
(:func:`_gathered_layer`), so the whole layer lives only while it runs and
the backward's recompute gathers it again; ``embed``, the final norm,
``lm_head`` and ``vit_proj`` are gathered where they are used. The gather's
backward reduce-scatters the gradients (``collectives.gather_from_group``).

Paged serving (``serve/pool.py``): :func:`make_paged_pool` makes the
engine's page tensors, one ``k_pages`` / ``v_pages`` pair per attention
layer, and ``make_caches(paged=True)`` a request's state, in which an
attention layer keeps only ``pos`` (windowed layers too: the linear paged
view, the window a mask, as the reference has it) and a recurrent layer its
usual state. ``forward(pool=, page_table=)`` and ``forward_packed(pool=,
page_tables=)`` hand each attention layer its pages and the request's table
merged into its state dict; pages and positions are written in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.distributed import collectives
from repro_torch.kernels.matmul.ops import mm
from repro_torch.kernels.matmul.ref import matmul_ref
from repro_torch.models import attention as attn_mod
from repro_torch.models import flags
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.context import (
    data_dim, data_sharded, local_range, tensor_parallel,
)
from repro_torch.models.layers import (
    ParamDef, act_fn, axes_tree, init_tree, layer_norm, maybe_checkpoint,
    rms_norm, softcap,
)


# ---------------------------------------------------------------------------
# Param definitions
# ---------------------------------------------------------------------------

def dense_ff_defs(cfg: ArchConfig) -> Dict[str, ParamDef]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w1": ParamDef((d, f), ("d_model", "ff")),
        "w3": ParamDef((d, f), ("d_model", "ff")),
        "w2": ParamDef((f, d), ("ff", "d_model")),
    }


def _norm_defs(cfg: ArchConfig, name: str) -> Dict[str, ParamDef]:
    if cfg.norm_kind == "layernorm":
        return {
            f"{name}_w": ParamDef((cfg.d_model,), (None,), init="ones"),
            f"{name}_b": ParamDef((cfg.d_model,), (None,), init="zeros"),
        }
    return {f"{name}_w": ParamDef((cfg.d_model,), (None,), init="zeros")}


def _apply_norm(p, cfg: ArchConfig, x, name: str):
    if cfg.norm_kind == "layernorm":
        return layer_norm(x, p[f"{name}_w"], p[f"{name}_b"], cfg.norm_eps)
    return rms_norm(x, p[f"{name}_w"], cfg.norm_eps)


def layer_defs(cfg: ArchConfig, spec: LayerSpec) -> Dict[str, Any]:
    defs: Dict[str, Any] = {}
    defs.update(_norm_defs(cfg, "norm1"))
    if spec.mixer in ("attn", "local_attn"):
        defs["attn"] = attn_mod.attn_defs(cfg)
    elif spec.mixer == "rglru":
        defs["rglru"] = rglru_mod.rglru_defs(cfg)
    elif spec.mixer == "ssd":
        defs["ssm"] = ssm_mod.ssm_defs(cfg)
    else:
        raise ValueError(f"unknown mixer {spec.mixer}")
    if cfg.post_norms:
        defs.update(_norm_defs(cfg, "post1"))
    if spec.ff is not None:
        if not cfg.parallel_block:
            defs.update(_norm_defs(cfg, "norm2"))
        if spec.ff == "dense":
            defs["ff"] = dense_ff_defs(cfg)
        elif spec.ff == "moe":
            defs["moe"] = moe_mod.moe_defs(cfg)
        else:
            raise ValueError(f"unknown ff {spec.ff}")
        if cfg.post_norms:
            defs.update(_norm_defs(cfg, "post2"))
    return defs


def decompose(cfg: ArchConfig) -> List[Tuple]:
    """The reference's split of the layer pattern into scan-able segments:
    ("seq", (specs...)) and ("scan", unit_specs, reps). The port runs every
    layer in a loop; this only says how a JAX parameter tree is stacked."""
    pattern = cfg.layers()
    n = len(pattern)
    best = None  # (scanned_layers, -unit_len, start, p, reps)
    for start in range(0, min(4, n)):
        for p in range(1, 9):
            if start + 2 * p > n:
                break
            reps = (n - start) // p
            if reps < 2:
                continue
            if all(pattern[start + i] == pattern[start + (i % p)]
                   for i in range(reps * p)):
                cand = (reps * p, -p, start, p, reps)
                if best is None or cand > best:
                    best = cand
    if best is None:
        return [("seq", tuple(pattern))] if pattern else []
    _, _, start, p, reps = best
    segments: List[Tuple] = []
    if start:
        segments.append(("seq", tuple(pattern[:start])))
    segments.append(("scan", tuple(pattern[start:start + p]), reps))
    rest = pattern[start + reps * p:]
    if rest:
        segments.append(("seq", tuple(rest)))
    return segments


def model_defs(cfg: ArchConfig) -> Dict[str, Any]:
    d, v = cfg.d_model, cfg.padded_vocab
    defs: Dict[str, Any] = {
        "embed": ParamDef((v, d), ("vocab", "d_model"), init="normal", scale=0.02),
    }
    defs.update(_norm_defs(cfg, "final_norm"))
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, v), ("d_model", "vocab"), init="normal",
                                   scale=0.02)
    defs["layers"] = [layer_defs(cfg, spec) for spec in cfg.layers()]
    if cfg.encoder is not None and cfg.encoder.kind == "vision":
        defs["vit_proj"] = {
            "w": ParamDef((1024, d), (None, "d_model")),
            "b": ParamDef((d,), (None,), init="zeros"),
        }
    return defs


def _gather_blocks(p, defs, ctx):
    """``p`` with every leaf that FSDP splits over the data axis gathered
    whole over the data group, paired with its ``ParamDef`` in ``defs`` by
    key (``collectives.gather_from_group``: under grad, its backward
    reduce-scatters the leaf's gradient). Called under FSDP only
    (:func:`data_sharded`), so that the one-device path builds no defs."""
    group = ctx.group("data")

    def walk(d, x):
        if isinstance(d, ParamDef):
            i = data_dim(ctx, d.axes, d.shape, d.units)
            return x if i is None else collectives.gather_from_group(
                x, i, group)
        if isinstance(d, dict):
            return {k: walk(d[k], x[k]) for k in d}
        return [walk(a, b) for a, b in zip(d, x)]

    return walk(defs, p)


def _top(params, cfg: ArchConfig, names, ctx):
    """The top-level entries ``names`` of ``params`` that it holds, gathered
    over the data group under FSDP (:func:`_gather_blocks`)."""
    if not data_sharded(ctx):
        return {k: params[k] for k in names if k in params}
    defs = model_defs(cfg)
    return {k: _gather_blocks(params[k], defs[k], ctx)
            for k in names if k in params}


def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype=torch.float32, device=None, cut=None):
    return init_tree(model_defs(cfg), generator, dtype, device, cut)


def param_logical_axes(cfg: ArchConfig):
    return axes_tree(model_defs(cfg))


# ---------------------------------------------------------------------------
# Layer forward
# ---------------------------------------------------------------------------

def _dense_ff(p, cfg: ArchConfig, x, tile=None, impl: str = "auto",
              ctx=None):
    """SwiGLU FF. The three GEMMs go through the Hopper matmul kernel on CUDA
    tensors (``tile`` or the spec's default; any shape — the kernel masks
    ragged edges, so the reference's divisibility gate is not needed) and
    through :func:`matmul_ref` on CPU tensors or with ``impl="reference"``.
    Under tensor parallelism ``w1`` / ``w3`` are the rank's columns and
    ``w2`` its rows: ``x`` enters through ``copy_to_group`` and the output
    leaves through ``sum_from_group``."""
    act = act_fn(cfg.act)
    b, s, d = x.shape
    if impl == "reference":
        gemm = matmul_ref
    else:
        def gemm(a, w):
            return mm(a, w, tile=tile)
    split = local_range(ctx, "ff", cfg.d_ff) is not None
    if split:
        x = collectives.copy_to_group(x, ctx.model_group)
    xf = x.reshape(b * s, d)
    h = act(gemm(xf, p["w1"].to(x.dtype))) * gemm(xf, p["w3"].to(x.dtype))
    y = gemm(h, p["w2"].to(x.dtype))
    if split:
        y = collectives.sum_from_group(y, ctx.model_group)
    return y.reshape(b, s, -1)


def _mixer(p, cfg: ArchConfig, spec: LayerSpec, x, positions, cache,
           decode: bool, tiles, impl: str, chunk_start=None,
           pack_layout=None, ctx=None):
    """The layer's sequence mixer (the reference's ``_mixer``): attention
    with its KV cache, or an RG-LRU or SSD block with its carried state.
    The recurrent blocks run prefill, a chunk's continuation and decode
    alike (decode is S = 1). ``chunk_start`` makes an attention layer's
    prefill a chunk's continuation; ``pack_layout`` runs a packed step
    (``cache`` is then one cache per segment). ``ctx``: attention on the
    rank's heads, and a decode may run sequence-sharded
    (``attention.attn_decode``); an RG-LRU block on the rank's features,
    an SSD block on its heads."""
    if pack_layout is not None:
        return _mixer_packed(p, cfg, spec, x, positions, cache, tiles,
                             pack_layout, impl)
    if spec.mixer == "rglru":
        return rglru_mod.rglru_forward(p["rglru"], cfg, x, state=cache,
                                       tile=tiles.get("rglru"), impl=impl,
                                       ctx=ctx)
    if spec.mixer == "ssd":
        ssd_tile = tiles.get("ssd")
        return ssm_mod.ssm_forward(p["ssm"], cfg, x, state=cache,
                                   chunk=ssd_tile[0] if ssd_tile else 0,
                                   impl=impl, ctx=ctx)
    window = cfg.attn_window if spec.mixer == "local_attn" else None
    if cache is not None and "kv_pos" in cache and not (
            decode and attn_mod.sharded_decode_gate(cfg, ctx, cache)):
        raise ValueError("a sequence-sharded cache decodes only through the "
                         "sharded path (flags.set_perf(decode_sharded=True) "
                         "and its mesh)")
    if decode:
        return attn_mod.attn_decode(
            p["attn"], cfg, x, cache=cache, window=window,
            tile=tiles.get("flash_decode"), impl=impl, ctx=ctx)
    if chunk_start is not None:
        return attn_mod.attn_prefill_chunk(
            p["attn"], cfg, x, positions, cache=cache, start=chunk_start,
            window=window, tile=tiles.get("chunked_prefill"), impl=impl,
            ctx=ctx)
    return attn_mod.attn_forward(
        p["attn"], cfg, x, positions, window=window, cache=cache,
        tile=tiles.get("flash_attention"), impl=impl, ctx=ctx)


def _mixer_packed(p, cfg: ArchConfig, spec: LayerSpec, x, positions, caches,
                  tiles, layout, impl: str):
    """One mixer over a packed step (the reference's ``_mixer_packed``):
    attention through ``attn_prefill_packed``; a recurrent layer per
    segment, each continuing its own request's state (a packed sequence
    would carry state across requests)."""
    if spec.mixer in ("attn", "local_attn"):
        window = cfg.attn_window if spec.mixer == "local_attn" else None
        return attn_mod.attn_prefill_packed(
            p["attn"], cfg, x, positions, caches=caches, layout=layout,
            window=window, tile=tiles.get("packed_prefill"), impl=impl)
    outs, off = [], 0
    for (_, ln), cache in zip(layout, caches):
        y, _ = _mixer(p, cfg, spec, x[:, off:off + ln], None, cache, False,
                      tiles, impl)
        outs.append(y)
        off += ln
    return torch.cat(outs, dim=1), tuple(caches)


def layer_forward(p, cfg: ArchConfig, spec: LayerSpec, x, positions, cache,
                  decode: bool = False, tiles=None, impl: str = "auto",
                  chunk_start=None, pack_layout=None, ctx=None):
    """Returns (x_out, new_cache, aux): aux is an MoE layer's load-balance
    loss, float32, and None on a layer without one (the reference's zero,
    left out so that a dense step launches nothing for it). With
    ``pack_layout`` ``cache`` is one cache per segment, and so is
    new_cache. ``ctx`` (a ``DistContext``): attention, the dense FF and the
    recurrent mixers on the rank's blocks, the MoE block expert-parallel,
    and a decode may run sequence-sharded over its mesh; norms are
    computed whole for the rank's rows."""
    tiles = tiles or {}
    aux = None
    h = _apply_norm(p, cfg, x, "norm1")
    mix, new_cache = _mixer(p, cfg, spec, h, positions, cache, decode, tiles,
                            impl, chunk_start=chunk_start,
                            pack_layout=pack_layout, ctx=ctx)
    if cfg.post_norms:
        mix = _apply_norm(p, cfg, mix, "post1")
    ff_tile = tiles.get("matmul")
    if cfg.parallel_block and spec.ff is not None:
        x = x + mix + _dense_ff(p["ff"], cfg, h, tile=ff_tile, impl=impl,
                                ctx=ctx)
    else:
        x = x + mix
        if spec.ff is not None:
            h2 = _apply_norm(p, cfg, x, "norm2")
            if spec.ff == "dense":
                ff = _dense_ff(p["ff"], cfg, h2, tile=ff_tile, impl=impl,
                               ctx=ctx)
            else:
                ff, aux = moe_mod.moe_forward(p["moe"], cfg, h2, impl=impl,
                                              ctx=ctx)
            if cfg.post_norms:
                ff = _apply_norm(p, cfg, ff, "post2")
            x = x + ff
    if ctx is not None:
        x = ctx.constrain(x, "batch", None, None)
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# Stack forward
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StackOutputs:
    logits: Optional[torch.Tensor]
    aux_loss: Optional[torch.Tensor] = None
    caches: Optional[List[Any]] = None
    hidden: Optional[torch.Tensor] = None


def _cache_for(cfg: ArchConfig, spec: LayerSpec, batch: int, max_len: int,
               dtype, ring_local: bool, device, paged: bool = False,
               ctx=None):
    if spec.mixer == "rglru":
        return rglru_mod.make_rglru_state(cfg, batch, dtype, device=device,
                                          ctx=ctx)
    if spec.mixer == "ssd":
        return ssm_mod.make_ssm_state(cfg, batch, dtype, device=device,
                                      ctx=ctx)
    if paged:
        return {"pos": torch.zeros((), dtype=torch.int32, device=device)}
    ring = ring_local and spec.mixer == "local_attn"
    length = min(max_len, cfg.attn_window) if ring else max_len
    return attn_mod.make_kv_cache(cfg, batch, length, dtype, ring=ring,
                                  device=device, ctx=ctx)


def make_caches(cfg: ArchConfig, batch: int, max_len: int, dtype,
                ring_local: bool = False, device=None,
                paged: bool = False, ctx=None) -> List[Any]:
    """One cache per layer, in layer order (the reference's ``_cache_for``):
    on an attention layer a KV cache, linear at ``max_len`` or with
    ``ring_local`` a ring of ``min(max_len, attn_window)`` slots on each
    ``local_attn`` layer; on an RG-LRU or SSD layer its state, zeroed.
    ``paged=True``: an attention layer keeps only its position ``pos``
    (its K/V live in the pool, :func:`make_paged_pool`). ``ctx``: a KV
    cache holds the rank's KV heads (``attention.make_kv_cache``), a
    recurrent state the rank's features or SSD heads."""
    return [_cache_for(cfg, spec, batch, max_len, dtype, ring_local, device,
                       paged=paged, ctx=ctx)
            for spec in cfg.layers()]


def make_paged_pool(cfg: ArchConfig, n_pages: int, page: int, dtype,
                    device=None) -> List[Any]:
    """The engine's paged pool, one entry per layer in layer order: an
    attention layer's ``k_pages`` / ``v_pages`` ``[n_pages, Hkv, page,
    hd]``, None on a recurrent layer (its state stays per request)."""
    out: List[Any] = []
    for spec in cfg.layers():
        out.append(attn_mod.make_paged_kv_pages(cfg, n_pages, page, dtype,
                                                device=device)
                   if spec.mixer in ("attn", "local_attn") else None)
    return out


def _with_pool(cache, pool_leaf, table):
    """A layer's state with its pool pages and the request's page table
    merged in (the attention paths dispatch on ``k_pages``), or the state
    itself off the pool. The tensors are shared, so writes land in place."""
    if pool_leaf is None:
        return cache
    return {**cache, **pool_leaf, "table": table}


def is_kv_cache(cache: Dict[str, Any]) -> bool:
    return "k" in cache


def reset_caches(caches: List[Any]) -> None:
    """Empty every layer's cache in place for a new sequence, keeping its
    tensors: a KV cache's position and slot map (``reset_kv_cache``), and a
    recurrent state's conv tails and ``h`` (or a paged layer's ``pos``)
    zeroed, as a fresh :func:`make_caches` holds them."""
    for cache in caches:
        if is_kv_cache(cache):
            attn_mod.reset_kv_cache(cache)
        else:
            for t in cache.values():
                t.zero_()


def forward(
    params, cfg: ArchConfig, tokens: torch.Tensor,
    caches: Optional[List[Any]] = None,
    decode: bool = False,
    start_pos: int = 0,
    logits_mode: str = "full",   # full | last | hidden
    tiles=None,
    impl: str = "auto",
    chunked: bool = False,
    pool: Optional[List[Any]] = None,
    page_table: Optional[torch.Tensor] = None,
    patch_embeds: Optional[torch.Tensor] = None,
    remat: bool = False,
    ctx=None,
) -> StackOutputs:
    """tokens [B, S] -> logits [B, S(+P), Vpad].

    ``decode=True``: S must be 1 and ``caches`` supplied (positions come from
    the caches). ``chunked=True``: the tokens are one chunk of a prefill at
    positions ``start_pos ..``, continuing ``caches`` (required).
    ``logits_mode``: "last" applies the head to the final position only,
    "hidden" skips it. ``tiles`` (kernel name -> TileShape) parameterise the
    kernel call sites; ``impl`` is passed to them ("auto" | "kernel" |
    "reference"). ``pool`` (:func:`make_paged_pool`) and ``page_table``
    (the request's ``[n_pt]`` int32 table) run the attention layers over
    the paged pool: ``caches`` then come from ``make_caches(paged=True)``
    (batch 1), and only the decode and chunk paths take them.
    ``patch_embeds`` [B, P, 1024] (a vision model's frontend stub) are
    projected by ``vit_proj`` and prepended to the token embeddings, so the
    sequence is P + S long. ``aux_loss`` sums the layers' MoE aux losses.
    ``remat`` checkpoints each layer when grad mode is on (training; it
    takes no caches). ``ctx`` (``models/context.py``): ``tokens`` are the
    rank's rows of the batch and ``params`` the rank's blocks; under FSDP
    each layer is gathered over the data group as it runs; the layers
    run tensor-parallel, the MoE layers expert-parallel, the decode may run
    sequence-sharded over the mesh's model axis, and the logits come back
    whole (gathered over the vocabulary, outside autograd).
    """
    if pool is not None and not (decode or chunked):
        raise ValueError("a paged request prefills through chunks "
                         "(chunked=True) and decodes (decode=True)")
    if chunked and caches is None:
        raise ValueError("chunked prefill requires caches (serve state)")
    chunk_start = start_pos if chunked else None
    b, s = tokens.shape
    x = _embed(params, cfg, tokens, ctx)
    if patch_embeds is not None:
        vp = _top(params, cfg, ("vit_proj",), ctx)["vit_proj"]
        pdt = patch_embeds.dtype
        pe = torch.matmul(patch_embeds, vp["w"].to(pdt)) + vp["b"].to(pdt)
        x = torch.cat([pe.to(x.dtype), x], dim=1)
        s = x.shape[1]
    positions = (start_pos + torch.arange(s, device=tokens.device))[None, :]
    positions = positions.expand(b, s)
    if ctx is not None:
        x = ctx.constrain(x, "batch", None, None)

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches: Optional[List[Any]] = [] if caches is not None else None
    for li, spec in enumerate(cfg.layers()):
        lc = caches[li] if caches is not None else None
        if pool is not None:
            lc = _with_pool(lc, pool[li], page_table)
        x, nc, aux = maybe_checkpoint(
            remat and lc is None, _gathered_layer, params["layers"][li],
            cfg, spec, x, positions, lc, decode, tiles=tiles, impl=impl,
            chunk_start=chunk_start, ctx=ctx)
        if aux is not None:
            aux_total = aux_total + aux
        if new_caches is not None:
            new_caches.append(caches[li] if pool is not None else nc)

    x = _apply_norm(_top(params, cfg, _FINAL_NORM, ctx), cfg, x,
                    "final_norm")
    if logits_mode == "hidden":
        return StackOutputs(logits=None, aux_loss=aux_total,
                            caches=new_caches, hidden=x)
    if logits_mode == "last":
        x = x[:, -1:]
    logits = _head(params, cfg, x, ctx)
    if ctx is not None:
        logits = ctx.constrain(logits, "batch", None, "vocab")
    return StackOutputs(logits=logits, aux_loss=aux_total, caches=new_caches,
                        hidden=x)


_FINAL_NORM = ("final_norm_w", "final_norm_b")


def _gathered_layer(p, cfg: ArchConfig, spec: LayerSpec, *args, ctx=None,
                    **kwargs):
    """:func:`layer_forward` on the layer's blocks gathered over the data
    group (:func:`_gather_blocks`): :func:`forward` checkpoints this whole
    function, so the gathered layer is dropped after the forward and
    gathered again by the recompute."""
    if data_sharded(ctx):
        p = _gather_blocks(p, layer_defs(cfg, spec), ctx)
    return layer_forward(p, cfg, spec, *args, ctx=ctx, **kwargs)


def vocab_lookup(table, tokens, cfg: ArchConfig, ctx=None):
    """``table[tokens]``, vocab-parallel under tensor parallelism: the
    rank's rows of the table look up its range's tokens, every other token
    looks up zeros, and the ranks sum."""
    vocab = local_range(ctx, "vocab", cfg.padded_vocab)
    if vocab is None:
        return table[tokens]
    local = tokens - vocab[0]
    ok = (local >= 0) & (local < vocab[1] - vocab[0])
    x = table[torch.where(ok, local, 0)] * ok[..., None].to(table.dtype)
    return collectives.sum_from_group(x, ctx.model_group)


def _embed(params, cfg: ArchConfig, tokens, ctx=None):
    """The token embeddings (scaled where the config says), vocab-parallel
    under tensor parallelism (:func:`vocab_lookup`). Under FSDP the table
    is gathered over the data group first."""
    x = vocab_lookup(_top(params, cfg, ("embed",), ctx)["embed"], tokens,
                     cfg, ctx)
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def head_weight(params, cfg: ArchConfig, ctx=None):
    """The head ``[D, V]`` (the rank's columns under tensor parallelism):
    the embedding matrix transposed when tied, else ``lm_head``; gathered
    over the data group under FSDP."""
    name = "embed" if cfg.tie_embeddings else "lm_head"
    w = _top(params, cfg, (name,), ctx)[name]
    return w.t() if cfg.tie_embeddings else w


def _head(params, cfg: ArchConfig, x, ctx=None):
    return head_logits(x, head_weight(params, cfg, ctx), cfg, ctx)


def head_logits(x, head, cfg: ArchConfig, ctx=None):
    """Logits of ``x`` through ``head`` ``[D, V]`` (a tied head: the
    embedding matrix, transposed). A plain product, as the reference leaves
    it to XLA; column-parallel under tensor parallelism (``head`` the
    rank's columns), each rank's columns gathered into whole logits."""
    vocab = local_range(ctx, "vocab", cfg.padded_vocab)
    if vocab is not None:
        x = collectives.copy_to_group(x, ctx.model_group)
    logits = torch.matmul(x, head.to(x.dtype))
    if cfg.final_softcap:
        logits = softcap(logits, cfg.final_softcap)
    if vocab is not None:
        logits = collectives.all_gather(logits, logits.dim() - 1,
                                        ctx.model_group)
    return logits


def forward_packed(params, cfg: ArchConfig, tokens: torch.Tensor, states,
                   layout, tiles=None, impl: str = "auto", pool=None,
                   page_tables=None, ctx=None):
    """One packed step of several requests' prefill chunks (the reference's
    ``forward_packed``); with ``pool``, over the paged pool, each segment
    through its own table in ``page_tables``. ``ctx``: FSDP blocks,
    gathered as :func:`forward` gathers them; a pack runs on whole heads,
    so a tensor-parallel ``ctx`` raises.

    ``tokens`` [1, S_packed] concatenates one chunk per request; ``layout``
    the per-segment ``(start, len)`` pairs, ``states`` the matching
    per-request serve states (from :func:`make_caches` or the previous
    chunk), each updated in place. Embedding, norms and FF run once over
    the pack; each request's state advances as if its chunk had gone
    through ``forward(chunked=True)`` alone. Returns ``(logits [N, Vpad],
    states)``: each segment's last-position logits.
    """
    b, s = tokens.shape
    if b != 1:
        raise ValueError("packed prefill packs segments, not batch rows")
    if not layout or len(states) != len(layout):
        raise ValueError(f"layout/state mismatch: {len(layout)} segments, "
                         f"{len(states)} states")
    if sum(ln for _, ln in layout) != s:
        raise ValueError(f"layout {layout} does not cover {s} tokens")
    if tensor_parallel(ctx):
        raise NotImplementedError("packed prefill runs on one model rank")
    x = _embed(params, cfg, tokens, ctx)
    positions = torch.cat([start + torch.arange(ln, device=tokens.device)
                           for start, ln in layout])[None]
    for li, spec in enumerate(cfg.layers()):
        lc = tuple(st[li] for st in states)
        if pool is not None:
            lc = tuple(_with_pool(c, pool[li], tbl)
                       for c, tbl in zip(lc, page_tables))
        x, _, _ = _gathered_layer(params["layers"][li], cfg, spec, x,
                                  positions, lc, tiles=tiles, impl=impl,
                                  pack_layout=layout, ctx=ctx)
    x = _apply_norm(_top(params, cfg, _FINAL_NORM, ctx), cfg, x,
                    "final_norm")
    ends = torch.tensor([sum(ln for _, ln in layout[:i + 1]) - 1
                         for i in range(len(layout))], device=x.device)
    return _head(params, cfg, x[0, ends], ctx), tuple(states)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    # A float32 divisor on the tensor's device: PyTorch on CUDA divides by a
    # Python scalar as a multiply by its reciprocal, JAX divides.
    return torch.tensor(float(x), dtype=torch.float32, device=like.device)


def _nll(logits: torch.Tensor, targets: torch.Tensor,
         cfg: ArchConfig, ctx=None) -> torch.Tensor:
    """Per-position negative log-likelihood over the real (unpadded)
    vocabulary: the padded columns' logits are -1e30.

    Under tensor parallelism ``logits`` is the rank's vocabulary block
    (padded columns found by their global index) and the cross-entropy is
    vocab-parallel: the max is all-reduced (detached: the log-sum-exp's
    gradient does not depend on it), the sum of exponentials and the
    target's logit are summed over the model group (``sum_from_group``),
    so every rank holds the whole NLL and its logits' gradient is the
    softmax minus the one-hot on its columns."""
    vocab = local_range(ctx, "vocab", cfg.padded_vocab)
    lo, hi = vocab or (0, logits.shape[-1])
    vocab_ok = torch.arange(lo, hi, device=logits.device) < cfg.vocab_size
    logits = torch.where(vocab_ok, logits.float(), -1e30)
    if vocab is None:
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.take_along_dim(logp, targets.long()[..., None],
                                     dim=-1)[..., 0]
    group = ctx.model_group
    top = collectives.all_reduce(logits.detach().amax(dim=-1), "max", group)
    sumexp = collectives.sum_from_group(
        torch.exp(logits - top[..., None]).sum(dim=-1), group)
    local = targets.long() - lo
    ok = (local >= 0) & (local < hi - lo)
    picked = torch.take_along_dim(
        logits, torch.clamp(local, 0, hi - lo - 1)[..., None], dim=-1)[..., 0]
    target = collectives.sum_from_group(
        torch.where(ok, picked, torch.zeros_like(picked)), group)
    return torch.log(sumexp) + top - target


def lm_loss(logits: torch.Tensor, targets: torch.Tensor, cfg: ArchConfig,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cross-entropy over the real (unpadded) vocab, the reference's
    ``lm_loss``: the mean over positions, or over ``mask``'s."""
    nll = _nll(logits, targets, cfg)
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def _chunk_nll_sum(h, t, head, cfg: ArchConfig, ctx=None):
    if local_range(ctx, "vocab", cfg.padded_vocab) is not None:
        h = collectives.copy_to_group(h, ctx.model_group)
    logits = torch.matmul(h.float(), head.float())
    if cfg.final_softcap:
        logits = softcap(logits, cfg.final_softcap)
    return torch.sum(_nll(logits, t, cfg, ctx))


def fused_lm_loss(head: torch.Tensor, hidden: torch.Tensor,
                  targets: torch.Tensor, cfg: ArchConfig,
                  chunk: int = 1024, ctx=None) -> torch.Tensor:
    """Head product + cross-entropy over sequence chunks (the reference's
    ``fused_lm_loss``): ``[B, S, Vpad]`` logits are never held whole, each
    chunk's only inside a checkpointed call, recomputed in the backward.
    ``chunk`` is ``min(chunk, S)``, or S where it does not divide. The head
    product is ``torch.matmul`` in float32, as the reference leaves it to
    XLA. Returns the mean over the B * S positions. ``ctx``: under tensor
    parallelism ``head`` is the rank's columns and the cross-entropy is
    vocab-parallel (:func:`_nll`)."""
    b, s, _ = hidden.shape
    if flags.ANALYSIS_UNROLL:
        chunk = 4096                 # the reference's chunk under analysis
    chunk = min(chunk, s)
    if s % chunk:
        chunk = s  # unchunked for odd lengths
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, s, chunk):
        total = total + maybe_checkpoint(True, _chunk_nll_sum,
                                   hidden[:, i:i + chunk],
                                   targets[:, i:i + chunk], head, cfg, ctx)
    return total / _scalar(b * s, total)
