"""Griffin/RecurrentGemma recurrent block (RG-LRU + temporal conv branch) —
the port's ``repro/models/rglru.py``.

Block structure (arXiv:2402.19427 Fig. 2): two parallel branches from the
input — (a) linear -> causal depthwise conv (width 4) -> RG-LRU, (b) linear
-> GeLU — merged multiplicatively, then a linear output projection.

Decode state: conv tail [B, conv_width - 1, F] + recurrent h [B, F]. The
gate math runs in PyTorch and the scan through the RG-LRU wrapper
(``kernels/rglru/ops.py:rglru``): the Hopper kernel on CUDA tensors, its
plain version on CPU tensors; ``impl="reference"`` takes the plain
``rglru_ref`` on either device. The reference's block calls its plain
``rglru_ref`` everywhere. Unlike the reference, which returns a new state,
the port writes the new state into the given tensors (``copy_``), so a
serving slot's captured decode step keeps reading and writing the same
memory.

Tensor parallelism (``ctx`` with more than one model rank dividing the
width F, ``models/context.py``): a rank holds its block of F features of
every ``lru`` leaf (the reference's ``param_spec(..., fsdp=False)``):
``wx`` / ``wy`` columns (column-parallel, ``x`` entering through
``copy_to_group``), the conv, ``br`` / ``bi`` / ``a_param`` entries, the
rows of ``wr`` / ``wi`` and of ``wo``. The gates mix every feature: a
rank's ``xa`` times its rows of ``wr`` and ``wi`` is a partial sum over
all F gate columns, reduce-scattered (both gates in one call,
``collectives.sum_scatter_from_group``) to the rank's features. The scan
runs at F / m; ``wo`` is row-parallel, its output leaving through
``sum_from_group``. The state is the rank's features.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import collectives
from repro_torch.kernels.rglru.ops import rglru, rglru_ref
from repro_torch.models.context import local_range
from repro_torch.models.layers import ParamDef, act_fn


def rglru_defs(cfg: ArchConfig) -> Dict[str, ParamDef]:
    d = cfg.d_model
    f = cfg.recurrent.lru_width or d
    w = cfg.recurrent.conv_width
    return {
        "wx": ParamDef((d, f), ("d_model", "lru")),
        "wy": ParamDef((d, f), ("d_model", "lru")),
        "conv_w": ParamDef((w, f), (None, "lru"), scale=0.5),
        "conv_b": ParamDef((f,), ("lru",), init="zeros"),
        "wr": ParamDef((f, f), ("lru", None), scale=0.5),
        "br": ParamDef((f,), ("lru",), init="zeros"),
        "wi": ParamDef((f, f), ("lru", None), scale=0.5),
        "bi": ParamDef((f,), ("lru",), init="zeros"),
        "a_param": ParamDef((f,), ("lru",), init="normal", scale=0.5),
        "wo": ParamDef((f, d), ("lru", "d_model")),
    }


def _causal_conv(x, w, b, tail=None):
    """Depthwise causal conv along time. x [B,S,F], w [W,F]; tail [B,W-1,F].
    Returns (out [B,S,F], new_tail [B,W-1,F])."""
    width = w.shape[0]
    if tail is None:
        tail = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([tail, x], dim=1)                          # [B, S+W-1, F]
    out = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
              for i in range(width))
    new_tail = xp[:, -(width - 1):, :]
    return out + b[None, None, :], new_tail


def local_features(cfg: ArchConfig, ctx=None) -> Optional[Tuple[int, int]]:
    """This rank's ``[f0, f1)`` of the RG-LRU width where the model ranks
    split it (``context.local_range``), else None (every feature)."""
    return local_range(ctx, "lru", cfg.recurrent.lru_width or cfg.d_model)


def make_rglru_state(cfg: ArchConfig, batch: int, dtype,
                     device=None, ctx=None) -> Dict[str, Any]:
    """Zeroed conv tail [B, W - 1, F] and ``h`` [B, F]; ``ctx``: the rank's
    features (:func:`local_features`)."""
    f = cfg.recurrent.lru_width or cfg.d_model
    block = local_features(cfg, ctx)
    if block is not None:
        f = block[1] - block[0]
    w = cfg.recurrent.conv_width
    return {
        "conv": torch.zeros((batch, w - 1, f), dtype=dtype, device=device),
        "h": torch.zeros((batch, f), dtype=dtype, device=device),
    }


def rglru_forward(
    p: Dict[str, Any], cfg: ArchConfig, x: torch.Tensor,
    state: Optional[Dict[str, Any]] = None,
    tile=None, impl: str = "auto", ctx=None,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """x [B, S, D] -> (y [B, S, D], state). Works for S == 1 (decode).

    ``state`` (from :func:`make_rglru_state`) is the carried state, updated
    in place. ``tile`` is the resolved (bt, bf) RG-LRU tile; ``impl``
    "auto" (or "kernel") runs the scan through the wrapper, "reference"
    the plain ``rglru_ref``. ``ctx``: tensor-parallel on the rank's
    features (``p`` its blocks, ``state`` its features' state).
    """
    c = cfg.recurrent.c
    split = local_features(cfg, ctx) is not None
    if split:
        group = ctx.model_group
        x = collectives.copy_to_group(x, group)
    xa = torch.einsum("bsd,df->bsf", x, p["wx"].to(x.dtype))
    xb = act_fn("gelu")(torch.einsum("bsd,df->bsf", x, p["wy"].to(x.dtype)))

    tail = state["conv"] if state is not None else None
    xa, new_tail = _causal_conv(xa, p["conv_w"].to(x.dtype),
                                p["conv_b"].to(x.dtype), tail)

    gr = torch.einsum("bsf,fg->bsg", xa, p["wr"].to(x.dtype))
    gi = torch.einsum("bsf,fg->bsg", xa, p["wi"].to(x.dtype))
    if split:
        # Partial sums over the rank's rows, both gates in one call.
        gr, gi = collectives.sum_scatter_from_group(
            torch.stack([gr, gi], dim=-2), -1, group).unbind(-2)
    r = torch.sigmoid(gr + p["br"].to(x.dtype))
    i = torch.sigmoid(gi + p["bi"].to(x.dtype))
    h0 = state["h"] if state is not None else None
    a_param = p["a_param"].float()
    if impl == "reference":
        y, h_last = rglru_ref(xa, r, i, a_param, h0=h0, c=c)
    elif impl in ("auto", "kernel"):
        y, h_last = rglru(xa, r, i, a_param, h0=h0, c=c, tile=tile)
    else:
        raise ValueError(f"unknown rglru impl {impl!r}")

    y = y * xb                                                 # gated merge
    out = torch.einsum("bsf,fd->bsd", y, p["wo"].to(x.dtype))
    if split:
        out = collectives.sum_from_group(out, group)
    if state is not None:
        state["conv"].copy_(new_tail)
        state["h"].copy_(h_last)
    return out, state

