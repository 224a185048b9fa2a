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
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ssd.ops import ssd, ssd_chunked_ref, ssd_ref
from repro_torch.models import flags
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
    return {
        "in_z": ParamDef((d, di), ("d_model", "ssm_heads")),
        "in_x": ParamDef((d, di), ("d_model", "ssm_heads")),
        "in_B": ParamDef((d, n), ("d_model", None)),
        "in_C": ParamDef((d, n), ("d_model", None)),
        "in_dt": ParamDef((d, h), ("d_model", "ssm_heads")),
        "conv_x_w": ParamDef((w, di), (None, "ssm_heads"), scale=0.5),
        "conv_x_b": ParamDef((di,), ("ssm_heads",), init="zeros"),
        "conv_B_w": ParamDef((w, n), (None, None), scale=0.5),
        "conv_B_b": ParamDef((n,), (None,), init="zeros"),
        "conv_C_w": ParamDef((w, n), (None, None), scale=0.5),
        "conv_C_b": ParamDef((n,), (None,), init="zeros"),
        "A_log": ParamDef((h,), ("ssm_heads",), init="normal", scale=0.1),
        "D": ParamDef((h,), ("ssm_heads",), init="ones"),
        "dt_bias": ParamDef((h,), ("ssm_heads",), init="zeros"),
        "norm_w": ParamDef((di,), ("ssm_heads",), init="zeros"),
        "out_proj": ParamDef((di, d), ("ssm_heads", "d_model")),
    }


def make_ssm_state(cfg: ArchConfig, batch: int, dtype,
                   device=None) -> Dict[str, Any]:
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    h = s.n_heads(d)
    w = s.conv_width

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "conv_x": zeros(batch, w - 1, di),
        "conv_B": zeros(batch, w - 1, s.d_state),
        "conv_C": zeros(batch, w - 1, s.d_state),
        "h": zeros(batch, h, s.d_state, s.head_dim),
    }


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
    chunk: int = 0, impl: str = "auto",
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """x [B, S, D] -> (y [B, S, D], state), ``state`` updated in place.

    ``chunk`` is the resolved SSD tile's chunk (0: the kernel's default, or
    the reference's 128 with ``impl="reference"``). ``impl`` "auto" (or
    "kernel") runs the scan through the wrapper, "reference" the plain
    versions.
    """
    s = cfg.ssm
    b, slen, d = x.shape
    di = s.d_inner(d)
    h = s.n_heads(d)
    pd = s.head_dim

    def proj(name):
        return torch.einsum("bsd,de->bse", x, p[name].to(x.dtype))

    z, xs, Bm, C, dt_raw = (proj(k) for k in
                            ("in_z", "in_x", "in_B", "in_C", "in_dt"))

    def conv(v, name):
        tail = state[f"conv_{name}"] if state is not None else None
        return _causal_conv(v, p[f"conv_{name}_w"].to(x.dtype),
                            p[f"conv_{name}_b"].to(x.dtype), tail)

    xs, nt_x = conv(xs, "x")
    Bm, nt_b = conv(Bm, "B")
    C, nt_c = conv(C, "C")
    xs, Bm, C = F.silu(xs), F.silu(Bm), F.silu(C)

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
    y = rms_norm(y * F.silu(z.to(y.dtype)), p["norm_w"], cfg.norm_eps)
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"].to(x.dtype))
    if state is not None:
        for key, new in (("conv_x", nt_x), ("conv_B", nt_b),
                         ("conv_C", nt_c), ("h", h_last)):
            state[key].copy_(new)
    return out, state
