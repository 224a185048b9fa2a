"""Plain PyTorch bilinear upscale (the paper's Eq. 1-5), the version the
CUDA kernel is held against (``repro/kernels/bilinear/ref.py``).

For output pixel (xf, yf) the source point is (xf/scale, yf/scale), clamped
to the last row/column; neighbours x1 = floor(xp), x2 = min(x1 + 1, W - 1)
(replicate edge), weights from the fractional offsets. Math in float32,
output in the source dtype.
"""
from __future__ import annotations

import torch


def source_positions(n: int, scale: int, device=None) -> torch.Tensor:
    """float32 source coordinate of each of ``n * scale`` output pixels:
    out / scale correctly rounded, as the kernel's float division gives it.
    (A CUDA tensor divided by a scalar is multiplied by the reciprocal,
    which can miss by an ulp — 6e-5 of a pixel at x = 800 — so the quotient
    is taken in float64 and rounded once.)"""
    out = torch.arange(n * scale, dtype=torch.float64, device=device)
    return torch.clamp(out / scale, max=float(n - 1)).float()


def bilinear_upscale_ref(src: torch.Tensor, scale: int) -> torch.Tensor:
    """Upscale ``src`` [H, W] by integer ``scale`` -> [H*scale, W*scale]."""
    h, w = src.shape
    s = src.float()
    yp = source_positions(h, scale, src.device)
    xp = source_positions(w, scale, src.device)
    y1 = torch.floor(yp).long()
    x1 = torch.floor(xp).long()
    y2 = torch.clamp(y1 + 1, max=h - 1)
    x2 = torch.clamp(x1 + 1, max=w - 1)
    oy = (yp - y1.float())[:, None]
    ox = (xp - x1.float())[None, :]
    r1, r2 = s[y1], s[y2]
    top = (1 - ox) * r1[:, x1] + ox * r1[:, x2]
    bot = (1 - ox) * r2[:, x1] + ox * r2[:, x2]
    return ((1 - oy) * top + oy * bot).to(src.dtype)
