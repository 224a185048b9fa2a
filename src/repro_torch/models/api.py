"""Model API of the port (``repro/models/api.py``) across the families:
decoder-only LMs (dense, MoE, hybrid, SSM), the vision LM and the
encoder-decoder.

Batch conventions, the reference's:
    LM:    ``{"tokens": [B, S]}``, and ``"targets"`` [B, S] for
           :func:`train_loss`
    VLM:   ``+ {"patch_embeds": [B, P, 1024]}`` (the frontend stub); the
           tokens are the text tail, the sequence is P + S long
    audio: ``{"frames": [B, S_enc, D]}`` + the decoder's ``tokens``

Serve state is the per-layer cache list from :func:`make_serve_state`
(an encoder-decoder's: ``models/encdec.py``'s dict, made from the encoder
output), consumed by :func:`prefill` / :func:`prefill_chunk` /
:func:`prefill_packed` / :func:`decode_step`; a request served from the
paged pool has the state of :func:`make_paged_state` and goes through
:func:`prefill_chunk_paged` / :func:`prefill_packed_paged` /
:func:`decode_step_paged`, beside the pool of :func:`make_paged_pool` and its
page table. The chunked, packed and paged entry points refuse an audio
encoder-decoder model, as the reference's do; a vision model goes through
them as text. Functions that create tensors take ``device`` and run on
``cuda`` unless given ``device="cpu"``; the others run where the parameters
live.

``ctx`` (a ``models/context.py`` ``DistContext``, as the reference threads
it): on a mesh the batch given is this rank's rows
(``sharding_rules.local_batch``). With more than one model rank, or with
FSDP over more than one data rank, the parameters are the rank's blocks
(:func:`init_params` and ``convert.params_from_jax`` take ``ctx`` and cut
them to :func:`rank_shardings`); the model gathers each layer's data
blocks before using it, the attention, FF, RG-LRU and SSD blocks,
embedding and head run tensor-parallel (an encoder-decoder's encoder and
decoder layers alike) and the MoE layers expert-parallel, and a serve
state holds the rank's KV heads, recurrent features and SSD heads (an
encoder-decoder's self and cross heads; :func:`make_serve_state`); with
``flags.DECODE_ATTN_SHARDED`` :func:`decode_step` decodes every cache that
``attention.sharded_decode_gate`` passes sequence-sharded (its first decode
keeps this rank's slice of a cache of every KV head). ``ctx=None`` is every
path as before.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.tiling import TileShape
from repro_torch.distributed.sharding_rules import (
    NamedSharding, P, shard_tree,
)
from repro_torch.models import encdec as E
from repro_torch.models import transformer as T
from repro_torch.models.context import (
    DistContext, data_dim, holds_blocks, local_range,
)
from repro_torch.models.layers import map_defs

# Resolved kernel tiles (kernel name -> TileShape), threaded from the
# ServeEngine through forward() into the kernel call sites.
Tiles = Optional[Mapping[str, TileShape]]


def is_encdec(cfg: ArchConfig) -> bool:
    return cfg.encoder is not None and cfg.encoder.kind == "audio"


def is_vlm(cfg: ArchConfig) -> bool:
    return cfg.encoder is not None and cfg.encoder.kind == "vision"


def _refuse_encdec(cfg: ArchConfig, what: str) -> None:
    if is_encdec(cfg):
        raise NotImplementedError(
            f"{what} is not supported for encoder-decoder models")


def init_params(cfg: ArchConfig, seed: Union[int, torch.Generator] = 0,
                dtype=torch.float32, device=None,
                ctx: Optional[DistContext] = None):
    """Random parameters from a seeded ``torch.Generator`` on ``device``,
    with the reference's distributions. On ``device="meta"``: empty
    tensors of the same shapes and dtypes, nothing drawn (the dry run's
    abstract parameters, ``launch/specs.py:abstract_params``). With a
    ``ctx`` whose ranks hold blocks (tensor parallelism, FSDP): the rank's
    blocks (:func:`rank_shardings`) of the whole tree the same seed
    draws, each leaf cut as it is drawn, so every mesh starts from the
    one-device parameters and a rank never holds more than its blocks and
    one whole leaf."""
    dev = resolve_device(device)
    if dev.type == "meta" or isinstance(seed, torch.Generator):
        gen = seed
    else:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
    cut = None
    if holds_blocks(ctx):
        def cut(d, x):
            sh = _leaf_sharding(d, ctx)
            return sh.local_block(x) if sh.spec else x
    return (E if is_encdec(cfg) else T).init_params(cfg, gen, dtype, dev, cut)


def param_defs(cfg: ArchConfig):
    """The parameters' ``ParamDef`` tree (shapes, logical axes, inits)."""
    if is_encdec(cfg):
        return E.model_defs(cfg)
    return T.model_defs(cfg)


def _leaf_sharding(d, ctx: DistContext) -> NamedSharding:
    # The model axis on each dim whose logical axis the ranks split, the
    # data axis on the dim FSDP picks.
    entries = [ctx.model_axis if local_range(ctx, ax, n, d.units) else None
               for ax, n in zip(d.axes, d.shape)]
    i = data_dim(ctx, d.axes, d.shape, d.units)
    if i is not None:
        entries[i] = "data"
    return NamedSharding(ctx.mesh, P(*entries) if any(entries) else P())


def rank_shardings(cfg: ArchConfig, ctx: DistContext):
    """The tree of ``NamedSharding`` a rank holds its parameters in on
    ``ctx``'s mesh: the model axis on each dim whose logical axis the
    model ranks split (``context.local_range``, the reference's
    ``param_spec(..., fsdp=False)``, but an SSD block's ``d_inner`` leaves
    split only where the ranks divide its heads, ``ParamDef.units``) and,
    with FSDP, the data axis on the dim
    ``context.data_dim`` picks (``param_spec(..., fsdp=True)``'s on those
    leaves). An encoder-decoder's leaves take the same rule, on a layer's
    own dims (the port keeps one dict a layer where the reference stacks
    them)."""
    return map_defs(lambda d: _leaf_sharding(d, ctx), param_defs(cfg))


def shard_params(params, cfg: ArchConfig, ctx: Optional[DistContext]):
    """This rank's blocks (:func:`rank_shardings`) of a whole parameter
    tree, or of an AdamW moment tree of the same structure. Where a rank
    holds the whole tree, ``params`` itself."""
    if not holds_blocks(ctx):
        return params
    return shard_tree(params, rank_shardings(cfg, ctx))


def param_logical_axes(cfg: ArchConfig):
    """The parameters' logical axes, a tree of the parameters' structure
    (the port's: one dict a layer where the reference stacks them)."""
    if is_encdec(cfg):
        return E.param_logical_axes(cfg)
    return T.param_logical_axes(cfg)


def train_loss(params, cfg: ArchConfig, batch: Dict[str, Any],
               remat: bool = True, tiles: Tiles = None, impl: str = "auto",
               ctx: Optional[DistContext] = None):
    """Scalar loss and metrics ``{"loss", "ce", "aux"}``, differentiable
    (the reference's ``train_loss``): the cross-entropy of
    ``transformer.fused_lm_loss`` over the hidden states, plus an MoE
    model's aux loss. A vision model's loss covers the text positions only
    (after the ``patch_embeds`` prefix); an encoder-decoder encodes
    ``frames`` and runs ``encdec.decode_train``, with the tied embedding as
    the head. ``batch`` holds numpy arrays or tensors (tokens and targets
    int32 or int64), moved to the parameters' device. ``remat``
    checkpoints each layer; ``tiles`` and ``impl`` reach the kernel call
    sites as in serving. On CUDA tensors the FF GEMMs and the attention
    launch the matmul and flash-attention kernels forward and backward.
    Under tensor parallelism the head is the rank's vocabulary block and
    the cross-entropy vocab-parallel (an encoder-decoder's tied head too);
    under FSDP the head is gathered over the data group first."""
    tokens = _tokens(params, batch["tokens"])
    targets = _tokens(params, batch["targets"])
    if is_encdec(cfg):
        enc = E.encode(params, cfg, _embeds(params, batch["frames"]),
                       impl=impl, remat=remat, ctx=ctx)
        hidden = E.decode_train(params, cfg, tokens, enc, return_hidden=True,
                                impl=impl, remat=remat, ctx=ctx)
        head = E.head_weight(params, cfg, ctx)
        aux = torch.zeros((), dtype=torch.float32, device=hidden.device)
    else:
        patch = batch.get("patch_embeds")
        out = T.forward(params, cfg, tokens, logits_mode="hidden",
                        tiles=tiles, impl=impl, remat=remat,
                        patch_embeds=None if patch is None
                        else _embeds(params, patch), ctx=ctx)
        hidden, aux = out.hidden, out.aux_loss
        if patch is not None:
            hidden = hidden[:, patch.shape[1]:]
        head = T.head_weight(params, cfg, ctx)
    ce = T.fused_lm_loss(head, hidden, targets, cfg, ctx=ctx)
    loss = ce + aux
    return loss, {"loss": loss, "ce": ce, "aux": aux}


def make_serve_state(cfg: ArchConfig, batch: int, max_len: int, dtype,
                     device=None, ring_local: bool = False,
                     enc_out: Optional[torch.Tensor] = None, params=None,
                     ctx: Optional[DistContext] = None):
    """An empty serve state; an encoder-decoder's needs the encoder output
    ``enc_out`` and the ``params`` that project its cross K/V (it lives on
    ``enc_out``'s device). ``ctx``: each KV cache holds the rank's KV heads
    (``attention.make_kv_cache``; an encoder-decoder's self and cross
    caches its heads, ``encdec.make_decode_caches``), each RG-LRU state its
    features and each SSD state its heads (``conv_B`` / ``conv_C`` whole:
    every rank computes B and C whole); the tensors are made at the
    block's shape, never as views of a whole state (the ssd kernel needs
    16-byte starts)."""
    if is_encdec(cfg):
        if enc_out is None or params is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder serve state "
                             "needs enc_out and params")
        return E.make_decode_caches(params, cfg, enc_out, batch, max_len,
                                    dtype, ctx)
    return T.make_caches(cfg, batch, max_len, dtype, ring_local=ring_local,
                         device=resolve_device(device), ctx=ctx)


def _tokens(params, tokens) -> torch.Tensor:
    dev = params["embed"].device
    if isinstance(tokens, torch.Tensor):
        return tokens.to(device=dev, dtype=torch.long)
    return torch.tensor(np.asarray(tokens), dtype=torch.long, device=dev)


def _embeds(params, x) -> torch.Tensor:
    dev, dtype = params["embed"].device, params["embed"].dtype
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype)
    return torch.tensor(np.asarray(x), dtype=dtype, device=dev)


def prefill(params, cfg: ArchConfig, batch: Dict[str, Any], max_len: int,
            dtype=torch.float32, ring_local: bool = False, tiles: Tiles = None,
            impl: str = "auto", caches: Optional[List[Any]] = None,
            ctx: Optional[DistContext] = None):
    """Returns (last-token logits [B, Vpad], serve_state).

    ``caches`` (from :func:`make_serve_state`) are emptied (KV positions
    reset, recurrent states zeroed) and written in place, so that a serving
    slot keeps the same tensors from one request to the next; without them
    the prefill makes its own. The head runs on the last position only: the
    reference computes every position's logits and keeps the last, the same
    numbers. A vision model's ``patch_embeds`` are prepended to the tokens
    (``max_len`` covers P + S); an encoder-decoder encodes ``frames`` and
    prefills its decoder over the tokens into a new state
    (``encdec.prefill``; ``caches`` is not taken).
    """
    tokens = _tokens(params, batch["tokens"])
    if is_encdec(cfg):
        enc = E.encode(params, cfg, _embeds(params, batch["frames"]),
                       impl=impl, ctx=ctx)
        logits, state = E.prefill(params, cfg, tokens, enc, max_len, dtype,
                                  impl=impl, ctx=ctx)
        return logits[:, -1], state
    patch = batch.get("patch_embeds")
    if caches is None:
        caches = T.make_caches(cfg, tokens.shape[0], max_len, dtype,
                               ring_local=ring_local, device=tokens.device,
                               ctx=ctx)
    else:
        T.reset_caches(caches)
    out = T.forward(params, cfg, tokens, caches=caches, logits_mode="last",
                    tiles=tiles, impl=impl,
                    patch_embeds=None if patch is None
                    else _embeds(params, patch), ctx=ctx)
    return out.logits[:, -1], out.caches


def decode_step(params, cfg: ArchConfig, token, state, tiles: Tiles = None,
                impl: str = "auto", ctx: Optional[DistContext] = None):
    """token [B, 1] -> (logits [B, Vpad], state), the state updated in place.

    A token tensor already on the parameters' device is used as it is, and
    the step reads nothing back to the host: on the card it is a fixed
    sequence of launches that a CUDA graph can capture. An
    encoder-decoder's state is ``encdec``'s dict, updated the same way.
    """
    if is_encdec(cfg):
        logits, state = E.decode_step(params, cfg, _tokens(params, token),
                                      state, impl=impl, ctx=ctx)
        return logits[:, 0], state
    out = T.forward(params, cfg, _tokens(params, token), caches=state,
                    decode=True, tiles=tiles, impl=impl, ctx=ctx)
    return out.logits[:, 0], out.caches


def prefill_chunk(params, cfg: ArchConfig, tokens, state, start: int,
                  tiles: Tiles = None, impl: str = "auto",
                  ctx: Optional[DistContext] = None):
    """One chunk of a multi-step (chunked) prefill.

    ``tokens`` [B, c] sit at absolute positions ``start .. start+c-1``;
    ``state`` is the serve state the earlier chunks wrote, continued in
    place. Unlike :func:`prefill` nothing is reset: the caller empties the
    state before a request's first chunk (``transformer.reset_caches``).
    Running every chunk through this entry reproduces :func:`prefill`
    position by position. Returns (last-position logits [B, Vpad], state).
    """
    _refuse_encdec(cfg, "chunked prefill")
    out = T.forward(params, cfg, _tokens(params, tokens), caches=state,
                    start_pos=start, chunked=True, logits_mode="last",
                    tiles=tiles, impl=impl, ctx=ctx)
    return out.logits[:, -1], out.caches


def prefill_packed(params, cfg: ArchConfig, tokens, states, layout,
                   tiles: Tiles = None, impl: str = "auto",
                   ctx: Optional[DistContext] = None):
    """One packed step of several requests' chunked prefills.

    ``tokens`` [1, S_packed] concatenates one chunk per request, ``layout``
    the per-segment ``(start, len)`` pairs, ``states`` the matching serve
    states (continued in place). Each state advances as it would through
    :func:`prefill_chunk` alone. Returns (per-segment last-position logits
    [N, Vpad], states). ``ctx``: FSDP blocks, gathered layer by layer
    (``transformer.forward_packed``).
    """
    _refuse_encdec(cfg, "packed prefill")
    return T.forward_packed(params, cfg, _tokens(params, tokens), states,
                            tuple(layout), tiles=tiles, impl=impl, ctx=ctx)


# -- the paged pool ----------------------------------------------------------
# Each entry mirrors its counterpart above with the pool and the request's
# page table (``serve.pool.PagedKVPool``) beside the state; pages, state and
# positions are written in place, and the pool comes back as the last output
# (the same tensors), as the reference returns its updated pool.

def make_paged_pool(cfg: ArchConfig, n_pages: int, page: int, dtype,
                    device=None):
    """The engine's page tensors (``transformer.make_paged_pool``)."""
    _refuse_encdec(cfg, "paged KV pool")
    return T.make_paged_pool(cfg, n_pages, page, dtype,
                             device=resolve_device(device))


def make_paged_state(cfg: ArchConfig, dtype, device=None):
    """A paged request's state: ``pos`` on each attention layer, the usual
    batch-1 state on a recurrent one."""
    _refuse_encdec(cfg, "paged KV pool")
    return T.make_caches(cfg, 1, 1, dtype, device=resolve_device(device),
                         paged=True)


def decode_step_paged(params, cfg: ArchConfig, token, state, pool, page_table,
                      tiles: Tiles = None, impl: str = "auto"):
    """token [1, 1] -> (logits [1, Vpad], state, pool). Nothing is read back
    to the host, so a CUDA graph can capture it with the table tensor."""
    _refuse_encdec(cfg, "paged decode")
    out = T.forward(params, cfg, _tokens(params, token), caches=state,
                    decode=True, tiles=tiles, impl=impl, pool=pool,
                    page_table=page_table)
    return out.logits[:, 0], out.caches, pool


def prefill_chunk_paged(params, cfg: ArchConfig, tokens, state, start: int,
                        pool, page_table, tiles: Tiles = None,
                        impl: str = "auto"):
    """:func:`prefill_chunk` over the paged pool. A request whose prompt
    prefix was found in the pool starts at ``start`` = the shared length:
    the mapped pages stand in for the chunks it never ran."""
    _refuse_encdec(cfg, "chunked prefill")
    out = T.forward(params, cfg, _tokens(params, tokens), caches=state,
                    start_pos=start, chunked=True, logits_mode="last",
                    tiles=tiles, impl=impl, pool=pool, page_table=page_table)
    return out.logits[:, -1], out.caches, pool


def prefill_packed_paged(params, cfg: ArchConfig, tokens, states, layout,
                         pool, page_tables, tiles: Tiles = None,
                         impl: str = "auto"):
    """:func:`prefill_packed` over the paged pool, one page table per
    segment. Returns (logits [N, Vpad], states, pool)."""
    _refuse_encdec(cfg, "packed prefill")
    logits, states = T.forward_packed(
        params, cfg, _tokens(params, tokens), states, tuple(layout),
        tiles=tiles, impl=impl, pool=pool, page_tables=tuple(page_tables))
    return logits, states, pool
