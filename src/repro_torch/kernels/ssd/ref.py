"""Plain PyTorch Mamba-2 SSD (state-space dual) layer, the versions the CUDA
kernel is held against (``repro/kernels/ssd/ref.py``).

Selective state-space recurrence (arXiv:2405.21060), per head:

    a_t = exp(dt_t * A)                       A < 0 scalar per head
    h_t = a_t * h_{t-1} + B_t (x) (dt_t x_t)  outer product [N] x [P]
    y_t = C_t @ h_t  (+ D * x_t skip)

``ssd_ref`` runs the literal recurrence (the correctness oracle);
``ssd_scan_ref`` is the chunked dual form over pre-discretised inputs — the
same algorithm and order of operations as the kernel, on the kernel's
inputs; ``ssd_chunked_ref`` is the whole layer through it.

Shapes: x [B, S, H, P]; dt [B, S, H]; A [H]; Bm, C [B, S, N] (single group,
broadcast over heads); D [H] optional. State: [B, H, N, P]. Math in float32.
"""
from __future__ import annotations

import torch


def ssd_ref(x, dt, A, Bm, C, D=None, h0=None):
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    xf = x.float()
    dtf = dt.float()
    a = torch.exp(dtf * A.float()[None, None, :])              # [B, S, H]
    dtx = dtf[..., None] * xf                                    # [B, S, H, P]
    hs = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
          if h0 is None else h0.float())
    bm, cm = Bm.float(), C.float()
    ys = []
    for t in range(s):
        outer = bm[:, t, None, :, None] * dtx[:, t, :, None, :]  # [B, H, N, P]
        hs = a[:, t, :, None, None] * hs + outer
        ys.append(torch.einsum("bn,bhnp->bhp", cm[:, t], hs))
    y = torch.stack(ys, dim=1)                                   # [B, S, H, P]
    if D is not None:
        y = y + D.float()[None, None, :, None] * xf
    return y.to(x.dtype), hs.to(x.dtype)


def ssd_scan_ref(log_a, dtx, Bm, C, h0, chunk: int = 64):
    """The chunk scan over log_a [B, H, S], dtx [B, S, H, P], Bm, C
    [B, S, N] and h0 [B, H, N, P] -> (y [B, S, H, P], h_last [B, H, N, P])
    in dtx's dtype. The last chunk may be shorter than ``chunk``."""
    s = dtx.shape[1]
    q = max(1, min(int(chunk), s))
    la, xf = log_a.float(), dtx.float()
    bm, cm = Bm.float(), C.float()
    hs = h0.float()
    ys = []
    for t0 in range(0, s, q):
        qn = min(q, s - t0)
        cum = torch.cumsum(la[:, :, t0:t0 + qn], dim=-1)         # [B, H, Q]
        x_c = xf[:, t0:t0 + qn].permute(0, 2, 1, 3)              # [B, H, Q, P]
        b_c, c_c = bm[:, t0:t0 + qn], cm[:, t0:t0 + qn]          # [B, Q, N]
        tri = torch.tril(torch.ones((qn, qn), dtype=torch.bool,
                                    device=dtx.device))
        decay = torch.where(tri, torch.exp(cum[..., :, None] - cum[..., None, :]),
                            torch.zeros((), device=dtx.device))
        cb = torch.einsum("bin,bjn->bij", c_c, b_c)              # [B, Q, Q]
        y_intra = torch.matmul(cb[:, None] * decay, x_c)
        y_inter = torch.einsum("bin,bhnp->bhip", c_c, hs) * torch.exp(cum)[..., None]
        total = cum[..., -1]                                     # [B, H]
        w = torch.exp(total[..., None] - cum)                    # [B, H, Q]
        hs = (torch.exp(total)[..., None, None] * hs
              + torch.einsum("bhjn,bhjp->bhnp", b_c[:, None] * w[..., None], x_c))
        ys.append((y_intra + y_inter).permute(0, 2, 1, 3))       # [B, Q, H, P]
    return torch.cat(ys, dim=1).to(dtx.dtype), hs.to(dtx.dtype)


def discretize(x, dt, A):
    """(log_a [B, H, S], dtx [B, S, H, P]) in float32: the SSD op's
    discretisation ahead of the chunk scan."""
    dtf = dt.float()
    log_a = (dtf * A.float()[None, None, :]).transpose(1, 2).contiguous()
    return log_a, dtf[..., None] * x.float()


def ssd_chunked_ref(x, dt, A, Bm, C, D=None, h0=None, chunk: int = 128):
    """Chunked dual form of the whole layer; identical math to ``ssd_ref``."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    log_a, dtx = discretize(x, dt, A)
    h0 = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
          if h0 is None else h0)
    y, h_last = ssd_scan_ref(log_a, dtx, Bm, C, h0, chunk=chunk)
    if D is not None:
        y = y + D.float()[None, None, :, None] * x.float()
    return y.to(x.dtype), h_last.to(x.dtype)
