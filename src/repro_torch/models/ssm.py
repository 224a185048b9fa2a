"""Mamba-2 block (SSD mixer) — the port's ``repro/models/ssm.py``.

Block: per-component projections -> causal depthwise conv over (x, B, C) ->
SSD chunk scan -> gated RMSNorm(z) -> out_proj. Single group (G = 1) for
B/C, broadcast over heads; A parameterised as -exp(A_log). The projections
stay five separate products (z, x, B, C, dt), with the reference's
parameter names, so a JAX tree converts unchanged; that also hands the
scan kernel x, B and C as tensors of their own, each contiguous and on 16
bytes, where slices of one fused product would not be.

Decode state: conv tails per conv'd component + SSD state [B, H, N, P],
written in place (``copy_``) as in ``models/rglru.py``.

The scan goes through the SSD wrapper (``kernels/ssd/ops.py:ssd``): on
CUDA tensors the Hopper kernels, with chunk ``chunk`` (any chunk up to the
kernel's longest; it need not divide S) or the spec's default, and the
one-launch step at S = 1; on CPU tensors the plain chunked scan. The
reference's block calls its plain ``ssd_ref`` / ``ssd_chunked_ref``
everywhere, and the latter refuses a sequence its chunk does not divide.
``impl="reference"`` takes the port's plain versions of the same two:
``ssd_ref`` at S = 1, ``ssd_chunked_ref`` at ``min(chunk or 128, S)`` where
that chunk divides S, and where it does not the literal recurrence
``ssd_ref`` — the numbers the reference gives such a prompt fed through
its decode path.

Tensor parallelism (``ctx`` with more than one model rank,
``models/context.py``): where the model ranks divide the head count h, a
rank holds its block of h / m heads of every ``ssm_heads`` leaf — the
``d_inner`` columns of ``in_z`` / ``in_x`` / the conv / ``norm_w`` and rows
of ``out_proj`` (``ParamDef.units``: a block never cuts a head), and the
per-head ``in_dt`` / ``A_log`` / ``D`` / ``dt_bias`` — and none otherwise
(the reference tests each size alone, so it may cut ``d_inner`` where h
does not split). ``in_z`` / ``in_x`` / ``in_dt`` are column-parallel, ``x``
entering through ``copy_to_group``; ``in_B`` / ``in_C`` and their convs
are whole and computed whole on every rank, their outputs entering the
scan through ``copy_to_group`` (a rank's heads read all of B and C, so
each rank's cotangent of them is partial). The scan runs on the rank's
heads; the gated RMSNorm normalises over the whole ``d_inner``, its mean
of squares summed over the model group (``collectives.sum_partials``);
``out_proj`` is row-parallel, leaving through ``sum_from_group``. The
state holds the rank's heads (``h``) and ``conv_x`` columns; ``conv_B`` /
``conv_C`` are whole, where the reference's ``serve_state_shardings``
names the model axis on them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import collectives
from repro_torch.kernels.ssd.ops import ssd, ssd_chunked_ref, ssd_ref
from repro_torch.models import flags
from repro_torch.models.context import local_range
from repro_torch.models.layers import ParamDef, rms_norm
from repro_torch.models.rglru import _causal_conv

# The reference's chunk when no tile is given (``flags.SSD_CHUNK`` unset;
# 512 under ``flags.ANALYSIS_UNROLL``).
REFERENCE_CHUNK = 128


def ssm_defs(cfg: ArchConfig) -> Dict[str, ParamDef]:
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    h = s.n_heads(d)
    n = s.d_state
    w = s.conv_width
    # The d_inner leaves split by whole heads (``units``).
    return {
        "in_z": ParamDef((d, di), ("d_model", "ssm_heads"), units=h),
        "in_x": ParamDef((d, di), ("d_model", "ssm_heads"), units=h),
        "in_B": ParamDef((d, n), ("d_model", None)),
        "in_C": ParamDef((d, n), ("d_model", None)),
        "in_dt": ParamDef((d, h), ("d_model", "ssm_heads")),
        "conv_x_w": ParamDef((w, di), (None, "ssm_heads"), scale=0.5,
                             units=h),
        "conv_x_b": ParamDef((di,), ("ssm_heads",), init="zeros", units=h),
        "conv_B_w": ParamDef((w, n), (None, None), scale=0.5),
        "conv_B_b": ParamDef((n,), (None,), init="zeros"),
        "conv_C_w": ParamDef((w, n), (None, None), scale=0.5),
        "conv_C_b": ParamDef((n,), (None,), init="zeros"),
        "A_log": ParamDef((h,), ("ssm_heads",), init="normal", scale=0.1),
        "D": ParamDef((h,), ("ssm_heads",), init="ones"),
        "dt_bias": ParamDef((h,), ("ssm_heads",), init="zeros"),
        "norm_w": ParamDef((di,), ("ssm_heads",), init="zeros", units=h),
        "out_proj": ParamDef((di, d), ("ssm_heads", "d_model"), units=h),
    }


def local_heads(cfg: ArchConfig, ctx=None) -> Optional[Tuple[int, int]]:
    """This rank's ``[h0, h1)`` of the SSD heads where the model ranks
    split the block (they divide the head count), else None (every
    head)."""
    return local_range(ctx, "ssm_heads", cfg.ssm.n_heads(cfg.d_model))


def make_ssm_state(cfg: ArchConfig, batch: int, dtype,
                   device=None, ctx=None) -> Dict[str, Any]:
    """Zeroed conv tails [B, W - 1, *] and SSD state ``h`` [B, H, N, P];
    ``ctx``: the rank's heads (:func:`local_heads`) in ``h`` and
    ``conv_x``, ``conv_B`` / ``conv_C`` whole. Each tensor is made at its
    own shape (the ssd kernel needs ``h`` on 16 bytes)."""
    s = cfg.ssm
    h = s.n_heads(cfg.d_model)
    block = local_heads(cfg, ctx)
    if block is not None:
        h = block[1] - block[0]
    di = h * s.head_dim
    w = s.conv_width

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "conv_x": zeros(batch, w - 1, di),
        "conv_B": zeros(batch, w - 1, s.d_state),
        "conv_C": zeros(batch, w - 1, s.d_state),
        "h": zeros(batch, h, s.d_state, s.head_dim),
    }


def _split_rms_norm(x, w, eps: float, width: int, group):
    """``layers.rms_norm`` over ``width`` features of which this rank holds
    ``x``'s (and ``w``'s): the mean of squares summed over ``group``."""
    xf = x.float()
    ss = collectives.sum_partials(torch.sum(xf * xf, dim=-1, keepdim=True),
                                  group)
    normed = xf * torch.rsqrt(ss / width + eps)
    return (normed * (1.0 + w.float())).to(x.dtype)


def _reference_scan(xh, dt, A, Bm, C, D, h0, chunk: int):
    slen = xh.shape[1]
    q = min(chunk or flags.SSD_CHUNK
            or (512 if flags.ANALYSIS_UNROLL else REFERENCE_CHUNK), slen)
    if slen == 1 or slen % q:
        return ssd_ref(xh, dt, A, Bm, C, D, h0=h0)
    return ssd_chunked_ref(xh, dt, A, Bm, C, D, h0=h0, chunk=q)


def ssm_forward(
    p: Dict[str, Any], cfg: ArchConfig, x: torch.Tensor,
    state: Optional[Dict[str, Any]] = None,
    chunk: int = 0, impl: str = "auto", ctx=None,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """x [B, S, D] -> (y [B, S, D], state), ``state`` updated in place.

    ``chunk`` is the resolved SSD tile's chunk (0: the kernel's default, or
    the reference's 128 with ``impl="reference"``). ``impl`` "auto" (or
    "kernel") runs the scan through the wrapper, "reference" the plain
    versions. ``ctx``: tensor-parallel on the rank's heads (``p`` its
    blocks, ``state`` its heads' state).
    """
    s = cfg.ssm
    b, slen, d = x.shape
    h = s.n_heads(d)
    block = local_heads(cfg, ctx)
    split = block is not None
    if split:
        group = ctx.model_group
        h = block[1] - block[0]
    pd = s.head_dim
    di = h * pd
    # B and C are whole on every rank: from x itself, not its copy.
    x_col = collectives.copy_to_group(x, group) if split else x

    def proj(name, v):
        return torch.einsum("bsd,de->bse", v, p[name].to(x.dtype))

    z, xs, Bm, C, dt_raw = (proj(k, v) for k, v in (
        ("in_z", x_col), ("in_x", x_col), ("in_B", x), ("in_C", x),
        ("in_dt", x_col)))

    def conv(v, name):
        tail = state[f"conv_{name}"] if state is not None else None
        return _causal_conv(v, p[f"conv_{name}_w"].to(x.dtype),
                            p[f"conv_{name}_b"].to(x.dtype), tail)

    xs, nt_x = conv(xs, "x")
    Bm, nt_b = conv(Bm, "B")
    C, nt_c = conv(C, "C")
    xs, Bm, C = F.silu(xs), F.silu(Bm), F.silu(C)
    if split:
        # Each rank's heads read all of B and C: its cotangents are partial.
        Bm = collectives.copy_to_group(Bm, group)
        C = collectives.copy_to_group(C, group)

    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())      # [B, S, H]
    A = -torch.exp(p["A_log"].float())                           # [H]
    xh = xs.reshape(b, slen, h, pd)
    D = p["D"].float()

    h0 = state["h"] if state is not None else None
    if impl == "reference":
        y, h_last = _reference_scan(xh, dt, A, Bm, C, D, h0, chunk)
    elif impl in ("auto", "kernel"):
        y, h_last = ssd(xh, dt, A, Bm, C, D, h0=h0,
                        chunk=chunk or flags.SSD_CHUNK or None)
    else:
        raise ValueError(f"unknown ssd impl {impl!r}")
    y = y.reshape(b, slen, di)
    gated = y * F.silu(z.to(y.dtype))
    if split:
        y = _split_rms_norm(gated, p["norm_w"], cfg.norm_eps, s.d_inner(d),
                            group)
    else:
        y = rms_norm(gated, p["norm_w"], cfg.norm_eps)
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"].to(x.dtype))
    if split:
        out = collectives.sum_from_group(out, group)
    if state is not None:
        for key, new in (("conv_x", nt_x), ("conv_B", nt_b),
                         ("conv_C", nt_c), ("h", h_last)):
            state[key].copy_(new)
    return out, state
