"""Model API of the port (``repro/models/api.py``): decoder-only LMs.

Serve state is the per-layer cache list from :func:`make_serve_state`,
consumed by :func:`prefill` / :func:`prefill_chunk` / :func:`prefill_packed`
/ :func:`decode_step`; a request served from the paged pool has the state
of :func:`make_paged_state` and goes through :func:`prefill_chunk_paged` /
:func:`prefill_packed_paged` / :func:`decode_step_paged`, beside the pool
of :func:`make_paged_pool` and its page table. Functions that create
tensors take ``device`` and run on ``cuda`` unless given ``device="cpu"``;
the others run where the parameters live.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.tiling import TileShape
from repro_torch.models import transformer as T

# Resolved kernel tiles (kernel name -> TileShape), threaded from the
# ServeEngine through forward() into the kernel call sites.
Tiles = Optional[Mapping[str, TileShape]]


def _check_family(cfg: ArchConfig) -> None:
    if cfg.encoder is not None:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder and vision models are not ported yet")


def init_params(cfg: ArchConfig, seed: Union[int, torch.Generator] = 0,
                dtype=torch.float32, device=None):
    """Random parameters from a seeded ``torch.Generator`` on ``device``,
    with the reference's distributions."""
    _check_family(cfg)
    dev = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator(device=dev).manual_seed(int(seed))
    return T.init_params(cfg, gen, dtype, dev)


def make_serve_state(cfg: ArchConfig, batch: int, max_len: int, dtype,
                     device=None, ring_local: bool = False):
    _check_family(cfg)
    return T.make_caches(cfg, batch, max_len, dtype, ring_local=ring_local,
                         device=resolve_device(device))


def _tokens(params, tokens) -> torch.Tensor:
    dev = params["embed"].device
    if isinstance(tokens, torch.Tensor):
        return tokens.to(device=dev, dtype=torch.long)
    return torch.tensor(np.asarray(tokens), dtype=torch.long, device=dev)


def prefill(params, cfg: ArchConfig, batch: Dict[str, Any], max_len: int,
            dtype=torch.float32, ring_local: bool = False, tiles: Tiles = None,
            impl: str = "auto", caches: Optional[List[Any]] = None):
    """Returns (last-token logits [B, Vpad], serve_state).

    ``caches`` (from :func:`make_serve_state`) are emptied (KV positions
    reset, recurrent states zeroed) and written in place, so that a serving
    slot keeps the same tensors from one request to the next; without them
    the prefill makes its own. The head runs on the last position only: the
    reference computes every position's logits and keeps the last, the same
    numbers.
    """
    _check_family(cfg)
    tokens = _tokens(params, batch["tokens"])
    if caches is None:
        caches = T.make_caches(cfg, tokens.shape[0], max_len, dtype,
                               ring_local=ring_local, device=tokens.device)
    else:
        T.reset_caches(caches)
    out = T.forward(params, cfg, tokens, caches=caches, logits_mode="last",
                    tiles=tiles, impl=impl)
    return out.logits[:, -1], out.caches


def decode_step(params, cfg: ArchConfig, token, state, tiles: Tiles = None,
                impl: str = "auto"):
    """token [B, 1] -> (logits [B, Vpad], state), the state updated in place.

    A token tensor already on the parameters' device is used as it is, and
    the step reads nothing back to the host: on the card it is a fixed
    sequence of launches that a CUDA graph can capture.
    """
    _check_family(cfg)
    out = T.forward(params, cfg, _tokens(params, token), caches=state,
                    decode=True, tiles=tiles, impl=impl)
    return out.logits[:, 0], out.caches


def prefill_chunk(params, cfg: ArchConfig, tokens, state, start: int,
                  tiles: Tiles = None, impl: str = "auto"):
    """One chunk of a multi-step (chunked) prefill.

    ``tokens`` [B, c] sit at absolute positions ``start .. start+c-1``;
    ``state`` is the serve state the earlier chunks wrote, continued in
    place. Unlike :func:`prefill` nothing is reset: the caller empties the
    state before a request's first chunk (``transformer.reset_caches``).
    Running every chunk through this entry reproduces :func:`prefill`
    position by position. Returns (last-position logits [B, Vpad], state).
    """
    if cfg.encoder is not None:
        raise NotImplementedError(
            "chunked prefill is not supported for encoder-decoder models")
    out = T.forward(params, cfg, _tokens(params, tokens), caches=state,
                    start_pos=start, chunked=True, logits_mode="last",
                    tiles=tiles, impl=impl)
    return out.logits[:, -1], out.caches


def prefill_packed(params, cfg: ArchConfig, tokens, states, layout,
                   tiles: Tiles = None, impl: str = "auto"):
    """One packed step of several requests' chunked prefills.

    ``tokens`` [1, S_packed] concatenates one chunk per request, ``layout``
    the per-segment ``(start, len)`` pairs, ``states`` the matching serve
    states (continued in place). Each state advances as it would through
    :func:`prefill_chunk` alone. Returns (per-segment last-position logits
    [N, Vpad], states).
    """
    if cfg.encoder is not None:
        raise NotImplementedError(
            "packed prefill is not supported for encoder-decoder models")
    return T.forward_packed(params, cfg, _tokens(params, tokens), states,
                            tuple(layout), tiles=tiles, impl=impl)


# -- the paged pool ----------------------------------------------------------
# Each entry mirrors its counterpart above with the pool and the request's
# page table (``serve.pool.PagedKVPool``) beside the state; pages, state and
# positions are written in place, and the pool comes back as the last output
# (the same tensors), as the reference returns its updated pool.

def make_paged_pool(cfg: ArchConfig, n_pages: int, page: int, dtype,
                    device=None):
    """The engine's page tensors (``transformer.make_paged_pool``)."""
    _check_family(cfg)
    return T.make_paged_pool(cfg, n_pages, page, dtype,
                             device=resolve_device(device))


def make_paged_state(cfg: ArchConfig, dtype, device=None):
    """A paged request's state: ``pos`` on each attention layer, the usual
    batch-1 state on a recurrent one."""
    _check_family(cfg)
    return T.make_caches(cfg, 1, 1, dtype, device=resolve_device(device),
                         paged=True)


def decode_step_paged(params, cfg: ArchConfig, token, state, pool, page_table,
                      tiles: Tiles = None, impl: str = "auto"):
    """token [1, 1] -> (logits [1, Vpad], state, pool). Nothing is read back
    to the host, so a CUDA graph can capture it with the table tensor."""
    _check_family(cfg)
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
    _check_family(cfg)
    out = T.forward(params, cfg, _tokens(params, tokens), caches=state,
                    start_pos=start, chunked=True, logits_mode="last",
                    tiles=tiles, impl=impl, pool=pool, page_table=page_table)
    return out.logits[:, -1], out.caches, pool


def prefill_packed_paged(params, cfg: ArchConfig, tokens, states, layout,
                         pool, page_tables, tiles: Tiles = None,
                         impl: str = "auto"):
    """:func:`prefill_packed` over the paged pool, one page table per
    segment. Returns (logits [N, Vpad], states, pool)."""
    _check_family(cfg)
    logits, states = T.forward_packed(
        params, cfg, _tokens(params, tokens), states, tuple(layout),
        tiles=tiles, impl=impl, pool=pool, page_tables=tuple(page_tables))
    return logits, states, pool
