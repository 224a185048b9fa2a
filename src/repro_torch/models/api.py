"""Model API of the port (``repro/models/api.py``): decoder-only LMs.

Serve state is the per-layer cache list from :func:`make_serve_state`,
consumed by :func:`prefill` / :func:`prefill_chunk` / :func:`prefill_packed`
/ :func:`decode_step`. Functions that create
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
