"""Plain PyTorch RG-LRU (Real-Gated Linear Recurrent Unit), the versions the
CUDA kernel is held against (``repro/kernels/rglru/ref.py``).

Griffin / RecurrentGemma recurrence (arXiv:2402.19427 eq. 3-4), with the
gates r_t, i_t computed outside:

    log_a_t = -c * softplus(Lambda) * r_t     (c = 8)
    a_t = exp(log_a_t)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

``rglru_scan_ref`` is the scan alone, ``h_t = a_t * h_{t-1} + x_t`` in
float32 (the kernel's job); ``gates`` the elementwise math ahead of it;
``rglru_ref`` the whole unit. ``rglru_scan_chunked_ref`` is the CUDA
kernels' decomposition of the scan in plain PyTorch (chunk summaries, the
carry over the chunks, a rescan of each chunk); only tests use it.
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


def rglru_scan_chunked_ref(a, x, h0, chunk: int = 64):
    """``rglru_scan_ref``'s function in ``csrc/rglru.cu``'s three steps: (a)
    each chunk's decay A_c = prod a_t and scan from zero e_c; (b) the state
    entering each chunk, h <- A_c h + e_c from h0; (c) each chunk rescanned
    from it. The last chunk is padded with steps a = 1, x = 0, which leave
    the state as it is."""
    b, s, f = x.shape
    q = max(1, min(int(chunk), s))
    nc = -(-s // q)
    pad = nc * q - s
    af = F.pad(a.float(), (0, 0, 0, pad), value=1.0).view(b, nc, q, f)
    xf = F.pad(x.float(), (0, 0, 0, pad)).view(b, nc, q, f)
    # (a) summaries, every chunk at once.
    A = torch.ones((b, nc, f), dtype=torch.float32, device=x.device)
    e = torch.zeros_like(A)
    for t in range(q):
        e = af[:, :, t] * e + xf[:, :, t]
        A = A * af[:, :, t]
    # (b) the carry.
    h = h0.float()
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = A[:, c] * h + e[:, c]
    # (c) the rescan, every chunk at once.
    h = torch.stack(h_in, dim=1)
    ys = []
    for t in range(q):
        h = af[:, :, t] * h + xf[:, :, t]
        ys.append(h)
    y = torch.stack(ys, dim=2).reshape(b, nc * q, f)[:, :s]
    return y.to(x.dtype), y[:, -1].to(x.dtype)


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
