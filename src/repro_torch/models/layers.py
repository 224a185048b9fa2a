"""Model primitives: parameter definitions, norms, RoPE, activations.

The port's counterpart of ``repro/models/layers.py``. Parameters are plain
nested dicts of tensors. Every parameter is declared as a :class:`ParamDef`
with the same shape, logical axes and initialiser as the reference, so a
JAX parameter tree converts one to one (``models/convert.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import flags


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axes, len == len(shape)
    init: str = "fan_in"              # fan_in | normal | zeros | ones
    scale: float = 1.0
    # The whole units the leaf's model-axis dim is made of, which no
    # rank's block may cut (an SSD block's d_inner: its heads); None, the
    # dim's own size (``context.local_range``).
    units: Optional[int] = None

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def init_tree(defs: Dict[str, Any], generator: torch.Generator, dtype,
              device, cut=None) -> Dict[str, Any]:
    """Materialise a nested dict of ParamDefs (deterministic per generator).

    The distributions are the reference's (``layers.py:29-50``): N(0, scale)
    for "normal", N(0, scale / sqrt(fan_in)) for "fan_in" with fan_in the
    leading dim, zeros and ones. The numbers differ from JAX's for the same
    seed; tests that compare the two packages convert JAX's parameters.
    On ``device="meta"`` the tensors are empty (shapes and dtypes, no
    memory) and ``generator`` is not read: the dry run's abstract
    parameters. ``cut(d, x)``, where given, is what is kept of each leaf
    ``x`` drawn whole (a rank's block): the whole leaf is dropped before the
    next is drawn, so the draws are those of the whole tree and at most one
    whole leaf is held at a time.
    """
    def make(d: ParamDef) -> torch.Tensor:
        if device is not None and torch.device(device).type == "meta":
            return torch.empty(d.shape, dtype=dtype, device=device)
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dtype, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dtype, device=device)
        if d.init == "normal":
            std = d.scale
        elif d.init == "fan_in":
            std = d.scale / math.sqrt(max(d.shape[0], 1))
        else:
            raise ValueError(f"unknown init {d.init}")
        x = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (x * std).to(dtype)

    def walk(node):
        if isinstance(node, ParamDef):
            return make(node) if cut is None else cut(node, make(node))
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        return [walk(x) for x in node]

    return walk(defs)


def map_defs(fn, defs):
    """``fn`` of every ParamDef of ``defs``, in ``defs``' structure."""
    if isinstance(defs, ParamDef):
        return fn(defs)
    if isinstance(defs, dict):
        return {k: map_defs(fn, v) for k, v in defs.items()}
    return [map_defs(fn, x) for x in defs]


def axes_tree(defs: Dict[str, Any]) -> Dict[str, Any]:
    """The parallel tree of logical-axes tuples (the reference's
    ``axes_tree``; the port's layers are a list of dicts, not stacked)."""
    return map_defs(lambda d: d.axes, defs)


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------

def rms_norm(x, w, eps: float = 1e-6, offset: float = 1.0):
    """RMSNorm scaled by ``offset + w`` (weights are stored zero-centred)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (offset + w.float())).to(x.dtype)


def layer_norm(x, w, b, eps: float = 1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps) * w + b).to(x.dtype)


def act_fn(name: str):
    """Activation by config name. JAX's ``gelu`` defaults to the tanh
    approximation, so "gelu" and "gelu_tanh" both use it here."""
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "gelu_tanh": lambda x: F.gelu(x, approximate="tanh")}[name]


def softcap(x, cap: float):
    return cap * torch.tanh(x / cap)


def runs_kernels(x: torch.Tensor) -> bool:
    """Whether a model path's ``impl="auto"`` takes the kernels for ``x``:
    on the card, and on ``meta`` (a dry run's count of what the card runs,
    ``roofline/count.py``); a CPU tensor takes the plain versions."""
    return x.is_cuda or x.is_meta


def maybe_checkpoint(enabled: bool, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, under ``torch.utils.checkpoint`` (non-reentrant) when
    ``enabled`` and grad mode is on: its activations are dropped after the
    forward and recomputed in the backward, the reference's
    ``jax.checkpoint``. The recompute runs ``fn``'s kernels a second time;
    under ``flags.REMAT_POLICY == "dots"`` (the reference's
    ``dots_with_no_batch_dims_saveable``) the forward keeps every ``mm``
    output and the recompute reuses it (``kernels/matmul/ops.py``), so only
    the rest is recomputed. Nothing in the models draws random numbers, so
    no RNG state is kept."""
    if enabled and torch.is_grad_enabled():
        extra = {}
        if flags.remat_policy() == "dots":
            from repro_torch.kernels.matmul.ops import kept_product_contexts

            extra["context_fn"] = kept_product_contexts
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **extra, **kwargs)
    return fn(*args, **kwargs)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float = 10000.0):
    """x [..., S, H, D] (or [..., S, D]); positions [..., S] integer."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, device=x.device)             # [D/2]
    ang = positions[..., None].float() * inv                # [..., S, D/2]
    sin, cos = torch.sin(ang), torch.cos(ang)
    if x.dim() == positions.dim() + 2:                      # head axis present
        sin, cos = sin[..., None, :], cos[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
