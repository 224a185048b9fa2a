"""Plain PyTorch bilinear upscale (the paper's Eq. 1-5), the version the
CUDA kernel is held against (``repro/kernels/bilinear/ref.py``).

For output pixel (xf, yf) the source point is (xf/scale, yf/scale), clamped
to the last row/column; neighbours x1 = floor(xp), x2 = min(x1 + 1, W - 1)
(replicate edge), weights from the fractional offsets. Math in float32,
output in the source dtype.

``bilinear_upscale_ref`` computes the image at once;
``bilinear_upscale_tiled_ref`` in the order of the CUDA kernel (block,
tables, V-pixel runs, R rows, ragged edges), so that the CPU tests can hold
the kernel's decomposition equal to the plain image.
"""
from __future__ import annotations

import torch


def positions(first: int, count: int, scale: int, n: int,
              device=None) -> torch.Tensor:
    """float32 source coordinate of output pixels ``first .. first + count
    - 1`` along a side of ``n`` source pixels: out / scale correctly rounded,
    as the kernel's float division gives it, clamped to ``n - 1``. (A CUDA
    tensor divided by a scalar is multiplied by the reciprocal, which can
    miss by an ulp — 6e-5 of a pixel at x = 800 — so the quotient is taken
    in float64, whose 53 bits make the second rounding exact.)"""
    out = torch.arange(first, first + count, dtype=torch.float64, device=device)
    return torch.clamp(out / scale, max=float(n - 1)).float()


def source_positions(n: int, scale: int, device=None) -> torch.Tensor:
    """float32 source coordinate of each of ``n * scale`` output pixels."""
    return positions(0, n * scale, scale, n, device)


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


def _hlerp(rows: torch.Tensor, x1: torch.Tensor, dx: torch.Tensor,
           three: bool) -> torch.Tensor:
    """The V-pixel lerps of source rows ``rows`` [n, W] for each thread's run
    (``x1``, ``dx`` [bw, V]) -> [n, bw, V]. With ``three`` (scale >= V) a
    run reads three columns, x1_0 .. x1_0 + 2 (clamped), and each pixel
    takes the pair at x1_0 or at x1_0 + 1, as the kernel does."""
    w = rows.shape[1]
    if three:
        x0 = x1[:, :1]
        a, b, c = (rows[:, torch.clamp(x0 + k, max=w - 1)] for k in range(3))
        nxt = x1 != x0
        left, right = torch.where(nxt, b, a), torch.where(nxt, c, b)
    else:
        left, right = rows[:, x1], rows[:, torch.clamp(x1 + 1, max=w - 1)]
    return (1 - dx) * left + dx * right


def bilinear_upscale_tiled_ref(src: torch.Tensor, scale: int, tile, v: int,
                               r: int) -> torch.Tensor:
    """Upscale ``src`` [H, W] by ``scale`` as the CUDA kernel does, block by
    block and thread by thread: block (bh, bw) = ``tile`` threads covers
    (r * bh) x (v * bw) output pixels; its column and row position tables
    come first; thread (ty, tx) then walks its ``r`` rows, keeping the
    V-pixel lerps of source rows y1 (top) and y2 (bot) and recomputing them
    only when y1 changes (the old bot becoming the new top when y1 moves on
    by one); rows past the image and pixels past a row are not written. The
    threads of a block run side by side here, as tensors [bh, bw, v]."""
    h, w = src.shape
    oh, ow = h * scale, w * scale
    bh, bw = int(tile[0]), int(tile[1])
    fh, fw = r * bh, v * bw
    s = src.float()
    dev = src.device
    out = torch.empty((oh, ow), dtype=src.dtype, device=dev)
    three = scale >= v
    ty = torch.arange(bh, device=dev)
    for r_base in range(0, oh, fh):
        ypos = positions(r_base, fh, scale, h, dev)            # row table
        for c_base in range(0, ow, fw):
            xpos = positions(c_base, fw, scale, w, dev).view(bw, v)
            x1 = torch.floor(xpos).long()
            dx = xpos - x1.float()
            cols = c_base + torch.arange(fw, device=dev).view(bw, v)
            live = cols < ow                                   # ragged row end
            cy = torch.full((bh,), -2, dtype=torch.long, device=dev)
            top = bot = torch.zeros((bh, bw, v), device=dev)
            for i in range(r):
                oy = r_base + r * ty + i
                yp = ypos[r * ty + i]
                y1 = torch.floor(yp).long()
                dy = (yp - y1.float())[:, None, None]
                y2 = torch.clamp(y1 + 1, max=h - 1)
                new = (y1 != cy)[:, None, None]
                shift = (y1 == cy + 1)[:, None, None]
                top = torch.where(new, torch.where(shift, bot, _hlerp(
                    s[y1], x1, dx, three)), top)
                bot = torch.where(new, _hlerp(s[y2], x1, dx, three), bot)
                cy = torch.where(new[:, 0, 0], y1, cy)
                px = ((1 - dy) * top + dy * bot).to(src.dtype)
                rows = oy < oh                                 # ragged image end
                out[oy[rows][:, None], cols[live][None, :]] = px[rows][:, live]
    return out
