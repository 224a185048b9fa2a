"""Plain PyTorch RG-LRU (Real-Gated Linear Recurrent Unit), the versions the
CUDA kernel is held against (``repro/kernels/rglru/ref.py``).

Griffin / RecurrentGemma recurrence (arXiv:2402.19427 eq. 3-4), with the
gates r_t, i_t computed outside:

    log_a_t = -c * softplus(Lambda) * r_t     (c = 8)
    a_t = exp(log_a_t)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

``rglru_scan_ref`` is the scan alone, ``h_t = a_t * h_{t-1} + x_t`` in
float32 (the kernel's job); ``gates`` the elementwise math ahead of it;
``rglru_ref`` the whole unit.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rglru_scan_ref(a, x, h0):
    """a, x [B, S, F]; h0 [B, F] -> (y [B, S, F], h_last [B, F]) in x's
    dtype, the state carried in float32."""
    af, xf = a.float(), x.float()
    h = h0.float()
    ys = []
    for t in range(x.shape[1]):
        h = af[:, t] * h + xf[:, t]
        ys.append(h)
    return torch.stack(ys, dim=1).to(x.dtype), h.to(x.dtype)


def gates(x, r, i, a_param, c: float = 8.0):
    """(a, gated input) of the recurrence: a = exp(-c softplus(Lambda) r),
    input = sqrt(max(1 - a^2, 1e-12)) * (i * x)."""
    log_a = -c * F.softplus(a_param)[None, None, :] * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    return a, beta * (i * x)


def rglru_ref(x, r, i, a_param, h0=None, c: float = 8.0):
    """x, r, i: [B, S, F]; a_param (Lambda): [F]; h0: [B, F] or None.
    Returns (y [B, S, F], h_final [B, F])."""
    b, _, f = x.shape
    a, inp = gates(x, r, i, a_param, c)
    h0 = torch.zeros((b, f), dtype=x.dtype, device=x.device) if h0 is None else h0
    y, h_last = rglru_scan_ref(a.to(x.dtype), inp.to(x.dtype), h0)
    return y, h_last
