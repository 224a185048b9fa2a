"""Plain PyTorch Mamba-2 SSD (state-space dual) layer, the versions the CUDA
kernel is held against (``repro/kernels/ssd/ref.py``).

Selective state-space recurrence (arXiv:2405.21060), per head:

    a_t = exp(dt_t * A)                       A < 0 scalar per head
    h_t = a_t * h_{t-1} + B_t (x) (dt_t x_t)  outer product [N] x [P]
    y_t = C_t @ h_t  (+ D * x_t skip)

``ssd_ref`` runs the literal recurrence (the correctness oracle);
``ssd_scan_ref`` is the chunked dual form over pre-discretised inputs, chunk
after chunk with the state carried between them (the JAX kernel's order,
not the CUDA kernels'), the version the kernels are held against;
``ssd_chunked_ref`` is the whole layer through it. ``ssd_chunk_states_ref``
gives the state entering each chunk and ``ssd_scan_bwd_ref`` the gradient
of the scan's input projections. With ``reverse=True`` the three run the
scan backward in time, reading forward-ordered tensors in place (the
adjoint scan of the backward, as ``repro_ssd``'s reversed mode does; step
t is forward step S - 1 - t, its log_a 0 at t = 0 and log_a[S - t] after),
and write forward-ordered outputs. ``ssd_scan_rev_ref`` (the reversed
forward kernels with d log_a's dot products) and ``ssd_db_dc_ref`` (the
backward kernel ``repro_ssd_bwd``: dB and dC) are the plain versions of
the backward's two steps. ``ssd_scan_split_ref``
is the CUDA kernels' decomposition in plain PyTorch (every chunk's own
state, then a pass carrying the state over the chunks, then every chunk's
output), with its products through a ``mm`` the tests can replace by an
emulation of the tensor cores' arithmetic; only tests use it.

Shapes: x [B, S, H, P]; dt [B, S, H]; A [H]; Bm, C [B, S, N] (single group,
broadcast over heads); D [H] optional. State: [B, H, N, P]. Math in float32.
"""
from __future__ import annotations

import torch

from repro_torch.models import flags


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


def _rows(s: int, t0: int, qn: int, reverse: bool, device):
    """The forward steps of the scan's steps t0 .. t0 + qn - 1: a slice, or
    reversed (step t at forward step s - 1 - t) an index, descending."""
    if not reverse:
        return slice(t0, t0 + qn)
    return torch.arange(s - 1 - t0, s - 1 - t0 - qn, -1, device=device)


def _scan_log_a(log_a, reverse: bool):
    """log_a as float32 at forward steps; reversed, the backward scan's
    log_a' at forward step f: log_a[f + 1], 0 at f = S - 1 (its step 0)."""
    la = log_a.float()
    if not reverse:
        return la
    return torch.cat([la[..., 1:], torch.zeros_like(la[..., :1])], dim=-1)


def ssd_scan_ref(log_a, dtx, Bm, C, h0, chunk: int = 64, reverse: bool = False,
                 compute_dtype=None):
    """The chunk scan over log_a [B, H, S], dtx [B, S, H, P], Bm, C
    [B, S, N] and h0 [B, H, N, P] -> (y [B, S, H, P], h_last [B, H, N, P])
    in dtx's dtype. The last chunk may be shorter than ``chunk``; reversed,
    the chunks start at forward step S - 1, so the short one ends at 0.
    ``compute_dtype`` (bf16, the reference's ``SSD_COMPUTE_BF16``): the
    products' operands rounded to it, their sums and the decay statistics
    in float32."""
    s = dtx.shape[1]
    q = max(1, min(int(chunk), s))
    if compute_dtype is not None:
        return _ssd_scan_rounded(log_a, dtx, Bm, C, h0, q, compute_dtype)
    la, xf = _scan_log_a(log_a, reverse), dtx.float()
    bm, cm = Bm.float(), C.float()
    hs = h0.float()
    ys = []
    y_rev = torch.empty_like(xf) if reverse else None
    for t0 in range(0, s, q):
        qn = min(q, s - t0)
        rows = _rows(s, t0, qn, reverse, dtx.device)
        cum = torch.cumsum(la[:, :, rows], dim=-1)               # [B, H, Q]
        x_c = xf[:, rows].permute(0, 2, 1, 3)                    # [B, H, Q, P]
        b_c, c_c = bm[:, rows], cm[:, rows]                      # [B, Q, N]
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
        if reverse:
            y_rev[:, rows] = (y_intra + y_inter).permute(0, 2, 1, 3)
        else:
            ys.append((y_intra + y_inter).permute(0, 2, 1, 3))   # [B, Q, H, P]
    y = y_rev if reverse else torch.cat(ys, dim=1)
    return y.to(dtx.dtype), hs.to(dtx.dtype)


def _ssd_scan_rounded(log_a, dtx, Bm, C, h0, q: int, cdt):
    """:func:`ssd_scan_ref` forward with the reference's ``cdt`` products
    (``repro/kernels/ssd/ref.py:ssd_chunked_ref``): dtx, B and C, the
    masked scores, the state read and w x rounded to ``cdt``; float32
    sums."""
    def r(t):
        return t.to(cdt).float()

    s = dtx.shape[1]
    la = log_a.float()
    xf, bm, cm = r(dtx.float()), r(Bm.float()), r(C.float())
    hs = h0.float()
    ys = []
    for t0 in range(0, s, q):
        qn = min(q, s - t0)
        cum = torch.cumsum(la[:, :, t0:t0 + qn], dim=-1)        # [B, H, Q]
        x_c = xf[:, t0:t0 + qn].permute(0, 2, 1, 3)             # [B, H, Q, P]
        b_c, c_c = bm[:, t0:t0 + qn], cm[:, t0:t0 + qn]          # [B, Q, N]
        tri = torch.tril(torch.ones((qn, qn), dtype=torch.bool,
                                    device=dtx.device))
        decay = torch.where(tri, torch.exp(cum[..., :, None] - cum[..., None, :]),
                            torch.zeros((), device=dtx.device))
        cb = torch.einsum("bin,bjn->bij", c_c, b_c)
        y_intra = torch.matmul(r(cb[:, None] * decay), x_c)
        y_inter = torch.einsum("bin,bhnp->bhip", c_c, r(hs)) \
            * torch.exp(cum)[..., None]
        total = cum[..., -1]
        w = torch.exp(total[..., None] - cum)
        hs = (torch.exp(total)[..., None, None] * hs
              + torch.einsum("bjn,bhjp->bhnp", b_c, r(w[..., None] * x_c)))
        ys.append((y_intra + y_inter).permute(0, 2, 1, 3))
    return torch.cat(ys, dim=1).to(dtx.dtype), hs.to(dtx.dtype)


def ssd_scan_split_ref(log_a, dtx, Bm, C, h0, chunk: int = 64,
                       mm=torch.matmul, round_scores=None):
    """``ssd_scan_ref``'s function in ``csrc/ssd.cu``'s three steps: (a) each
    chunk's state S_c = (B * exp(total - cum))^T x from zero; (b) the state
    entering each chunk, h <- exp(total_c) h + S_c from h0; (c) each chunk's
    y = (C B^T * exp(cum_i - cum_j), j <= i) x + exp(cum) (C h_in). The last
    chunk is padded with zero steps. All four products go through ``mm``;
    ``round_scores``, if given, rounds the scores as the operand of
    scores . x (the bf16 kernel's one rounding of a float32 value)."""
    b, s, h, p = dtx.shape
    n = Bm.shape[-1]
    q = max(1, min(int(chunk), s))
    nc = -(-s // q)
    pad = nc * q - s
    la = torch.nn.functional.pad(log_a.float(), (0, pad))
    xf = torch.nn.functional.pad(dtx.float(), (0, 0, 0, 0, 0, pad))
    bm = torch.nn.functional.pad(Bm.float(), (0, 0, 0, pad))
    cm = torch.nn.functional.pad(C.float(), (0, 0, 0, pad))
    cum = torch.cumsum(la.view(b, h, nc, q), dim=-1)             # [B, H, c, Q]
    total = cum[..., -1]                                         # [B, H, c]
    x_c = xf.view(b, nc, q, h, p).permute(0, 3, 1, 2, 4)         # [B, H, c, Q, P]
    b_c = bm.view(b, 1, nc, q, n)
    c_c = cm.view(b, 1, nc, q, n)
    # (a) the chunks' own states.
    w = torch.exp(total[..., None] - cum)
    states = mm((b_c * w[..., None]).transpose(-1, -2), x_c)     # [B, H, c, N, P]
    # (b) the state entering each chunk.
    hs = h0.float()
    h_in = []
    for c in range(nc):
        h_in.append(hs)
        hs = torch.exp(total[..., c])[..., None, None] * hs + states[:, :, c]
    h_in = torch.stack(h_in, dim=2)                              # [B, H, c, N, P]
    # (c) the chunks' outputs.
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=dtx.device))
    decay = torch.where(tri, torch.exp(cum[..., :, None] - cum[..., None, :]),
                        torch.zeros((), device=dtx.device))
    scores = mm(c_c, b_c.transpose(-1, -2)) * decay              # [B, H, c, Q, Q]
    if round_scores is not None:
        scores = round_scores(scores)
    y = mm(scores, x_c) + torch.exp(cum)[..., None] * mm(c_c, h_in)
    y = y.permute(0, 2, 3, 1, 4).reshape(b, nc * q, h, p)[:, :s]
    return y.to(dtx.dtype), hs.to(dtx.dtype)


def ssd_chunk_states_ref(log_a, dtx, Bm, h0, chunk: int = 64,
                         reverse: bool = False):
    """The state entering each chunk of the scan, [B, H, nc, N, P] float32
    (the forward kernels' workspace after their state pass), in the scan's
    chunk order (reversed: from forward step S - 1)."""
    s = dtx.shape[1]
    q = max(1, min(int(chunk), s))
    la, xf, bm = _scan_log_a(log_a, reverse), dtx.float(), Bm.float()
    hs = h0.float()
    states = []
    for t0 in range(0, s, q):
        states.append(hs)
        rows = _rows(s, t0, min(q, s - t0), reverse, dtx.device)
        cum = torch.cumsum(la[:, :, rows], dim=-1)                 # [B, H, Q]
        total = cum[..., -1]
        w = torch.exp(total[..., None] - cum)
        x_c = xf[:, rows].permute(0, 2, 1, 3)                      # [B, H, Q, P]
        hs = (torch.exp(total)[..., None, None] * hs
              + torch.einsum("bhjn,bhjp->bhnp",
                             bm[:, None, rows] * w[..., None], x_c))
    return torch.stack(states, dim=2)


def ssd_scan_bwd_ref(log_a, dtx, Bm, dy, h0, h_in=None, chunk: int = 64,
                     reverse: bool = False):
    """The gradient, summed over heads, of sum(dy * y) with respect to the C
    of the scan (log_a, dtx, Bm, C, h0): dC_t = sum_h h_t dy_t [B, S, N].

    By the chunked products ``csrc/ssd.cu``'s ``ssd_bwd_kernel`` does: within
    a chunk, dC_t = sum_h [exp(cum_t) h_in dy_t + sum_{s <= t} (dy_t . x_s)
    exp(cum_t - cum_s) B_s], with h_in the state entering the chunk
    ([B, H, nc, N, P]; ``None`` means h0, one chunk). On the scan run
    backward in time (``reverse=True``, see ``ops.ssd_scan_backward``), whose
    states are the adjoint states, the same function gives dB, at forward
    steps. float32 math, dy's dtype out."""
    b, s, h, p = dtx.shape
    q = max(1, min(int(chunk), s))
    la, xf = _scan_log_a(log_a, reverse), dtx.float()
    bm, g = Bm.float(), dy.float()
    states = h0.float()[:, :, None] if h_in is None else h_in.float()
    out = []
    d_rev = torch.empty((b, s, Bm.shape[-1]), device=dtx.device) if reverse else None
    for c, t0 in enumerate(range(0, s, q)):
        qn = min(q, s - t0)
        rows = _rows(s, t0, qn, reverse, dtx.device)
        cum = torch.cumsum(la[:, :, rows], dim=-1)                 # [B, H, Q]
        x_c = xf[:, rows].permute(0, 2, 1, 3)                      # [B, H, Q, P]
        g_c = g[:, rows].permute(0, 2, 1, 3)
        tri = torch.tril(torch.ones((qn, qn), dtype=torch.bool,
                                    device=dtx.device))
        decay = torch.where(tri, torch.exp(cum[..., :, None] - cum[..., None, :]),
                            torch.zeros((), device=dtx.device))
        scores = torch.matmul(g_c, x_c.transpose(-1, -2)) * decay  # [B, H, Q, Q]
        d_c = (torch.exp(cum)[..., None]
               * torch.einsum("bhtp,bhnp->bhtn", g_c, states[:, :, c])
               + torch.matmul(scores, bm[:, None, rows]))
        if reverse:
            d_rev[:, rows] = d_c.sum(dim=1)
        else:
            out.append(d_c.sum(dim=1))                             # [B, Q, N]
    return (d_rev if reverse else torch.cat(out, dim=1)).to(dy.dtype)


def ssd_dlog_a_terms_ref(dy, y, dtx, d_dtx):
    """d log_a's terms before its reverse cumulative sum: <dy_t, y_t> -
    <dtx_t, d dtx_t> over P, float32 [B, H, S] (the reversed output
    launch's dot products)."""
    return ((dy.float() * y.float()).sum(-1)
            - (dtx.float() * d_dtx.float()).sum(-1)).transpose(1, 2)


def ssd_scan_rev_ref(log_a, dy, C, Bm, dh_last, y, dtx, chunk: int = 64):
    """The backward's adjoint scan, plain: the scan reversed (log_a', dtx' =
    dy, B' = C, C' = Bm, h0' = dh_last) -> (d dtx, the adjoint state at
    step 0, its chunk states or None with one chunk, d log_a's terms
    [B, H, S] float32), as ``ops._ssd_rev_cuda`` returns them."""
    s = dy.shape[1]
    d_dtx, g0 = ssd_scan_ref(log_a, dy, C, Bm, dh_last, chunk, reverse=True)
    q = max(1, min(int(chunk), s))
    states = (None if s <= q else
              ssd_chunk_states_ref(log_a, dy, C, dh_last, chunk, reverse=True))
    return d_dtx, g0, states, ssd_dlog_a_terms_ref(dy, y, dtx, d_dtx)


def ssd_db_dc_ref(log_a, dtx, Bm, C, dy, h0, dh_last, h_in, r_h_in,
                  chunk: int = 64):
    """(dB, dC), plain, as ``ops._ssd_bwd_cuda`` returns them: dC of the
    forward scan against dy, dB of the reversed one (x = dy, B = C, its
    states ``r_h_in``, from dh_last) against dtx."""
    dC = ssd_scan_bwd_ref(log_a, dtx, Bm, dy, h0, h_in, chunk)
    dB = ssd_scan_bwd_ref(log_a, dy, C, dtx, dh_last, r_h_in, chunk,
                          reverse=True)
    return dB, dC


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
    y, h_last = ssd_scan_ref(log_a, dtx, Bm, C, h0, chunk=chunk,
                             compute_dtype=compute_dtype())
    if D is not None:
        y = y + D.float()[None, None, :, None] * x.float()
    return y.to(x.dtype), h_last.to(x.dtype)


def compute_dtype():
    """The plain scan's product dtype: bf16 under the reference's
    ``flags.SSD_COMPUTE_BF16``, else None (float32)."""
    return torch.bfloat16 if flags.SSD_COMPUTE_BF16 else None
