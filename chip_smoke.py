#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py                      # every phase; needs one card
    python3 chip_smoke.py --quick              # build with the ptxas report,
                                               # one check per kernel, stop
    python3 chip_smoke.py --out smoke.json     # also write every measurement
    python3 chip_smoke.py --profile            # also trace one request

Phases, each of which fails the run if it fails:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once);
3. hold each kernel against its plain PyTorch version on the card, in
   float32 and bfloat16, at the shapes its path gives it — the full-width
   qwen2-1.5b serving path, recurrentgemma-9b's head_dim-256 attention, the
   paper's 800x800 image at scales 2-10, mamba2-2.7b's SSD and
   recurrentgemma-9b's RG-LRU — and time kernel, plain version and one
   PyTorch library call (where one computes the same function) with CUDA
   events;
4. serve full-width qwen2-1.5b (28 layers, random weights from a seed)
   through the port's ``ServeEngine`` and check that every kernel of the
   path was launched;
5. hold the full-width prefill logits and four decode steps of one request
   through the kernels against the same request through the plain
   versions, with TF32 off;
6. run the port's launcher (``python -m repro_torch.launch.serve``) at its
   smoke config on the card;
7. compile tile plans with wall-clock timing on the card (the port's
   ``compile_plan`` with ``make_measure_fn``) over a bounded job set: the
   paper's bilinear family, the train_4k ssd, rglru and head_dim-256
   attention cells, and qwen2-1.5b's serve cells; check that every cell was
   measured, none skipped, and that the saved artifact resolves each cell
   exactly; then time all 16 tiles of the paper's Fig. 3 at every scale
   beside the paper's two GPUs as the cost model sees them.

Launch counts: matmul, flash_attention and flash_decode are counted over
the serve of phase 4, bilinear, ssd and rglru over the compile of phase 7,
each reset to 0 just before its path and read just after.

It prints the card (phase 1), a ``{"kernels": [...]}`` JSON line before the
last, and as the last line ``{"ok": true, "device": {...}}``. Without a CUDA
card, or without the repository beside it, it exits non-zero and prints no
result. It imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Peak rates of one H100 SXM (NVIDIA's data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12,      # float32 outside the tensor cores
              "bfloat16": 989e12}    # bf16 tensor cores
# Full-width serving geometry (qwen2-1.5b): padded heads, head dim, cache.
HQ, HKV, HEAD_DIM, MAX_LEN = 16, 2, 128, 1024
D_MODEL, D_FF = 1536, 8960
# Max |kernel - plain| allowed, relative to max |plain| (at least 1): float32
# differs only by the order of its sums; bfloat16 also by one rounding of the
# output (at most one ulp, 2^-8 relative).
REL_TOL = {"float32": 2e-5, "bfloat16": 1e-2}
# Full-width logits, kernels vs plain versions, relative to max |logit|.
LOGIT_REL_TOL = 1e-3


class SmokeError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


# ---------------------------------------------------------------------------
# Timing and bounds
# ---------------------------------------------------------------------------

def time_ms(fns, iters: int = 32, warmup: int = 3) -> float:
    """Median per-call time of ``fns``, from CUDA events. Each closure
    holds its own input copy, and the callers pass ``copies_for`` of them:
    cycled in order, every copy once per timed run at the least, they
    overflow the 50 MB L2, so every call reads its inputs from HBM."""
    import torch

    calls = itertools.count()
    for _ in range(warmup):
        fns[next(calls) % len(fns)]()
    torch.cuda.synchronize()
    per_rep = max(iters, len(fns))
    times = []
    for rep in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_rep):
            fns[next(calls) % len(fns)]()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_rep)
    return statistics.median(times)


def copies_for(nbytes: int) -> int:
    """Input copies to cycle through so that the bytes the calls touch
    overflow the L2 cache (200 MiB in all, at most 512 copies)."""
    return max(1, min(512, -(-200 * 2**20 // max(nbytes, 1))))


def library_ms(fns):
    """``time_ms`` of a PyTorch library call, or None where this PyTorch
    does not take the call (it is a yardstick only)."""
    try:
        return time_ms(fns)
    except (TypeError, RuntimeError) as exc:
        log(f"  (library call not timed: {exc})")
        return None


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(out, ref) -> float:
    return float((out.float() - ref.float()).abs().max())


def within(err: float, ref, dtype: str) -> bool:
    scale = max(1.0, float(ref.float().abs().max()))
    return err <= REL_TOL[dtype] * scale


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def kernel_checks(quick: bool):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.decode import (
        flash_decode, flash_decode_ref,
    )
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
    )
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.matmul.ops import mm
    from repro_torch.kernels.matmul.ref import matmul_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def record(kernel, case, dtype_name, out, ref, timing=None):
        err = max_err(out, ref)
        ok = within(err, ref, dtype_name)
        row = dict(kernel=kernel, case=case, dtype=dtype_name,
                   max_abs_err=err, ref_max=float(ref.float().abs().max()),
                   rel_tol=REL_TOL[dtype_name], ok=ok)
        if timing:
            row.update(timing)
        rows.append(row)
        extra = ""
        if timing:
            extra = (f" | {timing['ms']:.4f} ms, plain {timing['plain_ms']:.4f}"
                     f", library {timing['library_ms']}, bound "
                     f"{timing['bound_ms']:.4f} ({timing['bound_by']})")
            if timing.get("library_max_abs_err") is not None:
                extra += f", library err {timing['library_max_abs_err']:.3e}"
        log(f"  {kernel:16s} {case:34s} {dtype_name:8s} err {err:.3e} "
            f"(tol {REL_TOL[dtype_name]:g} x {max(1.0, row['ref_max']):.3g})"
            f" {'ok' if ok else 'FAIL'}{extra}")
        return row

    dtypes = (("float32", torch.float32), ("bfloat16", torch.bfloat16))

    # -- matmul: the SwiGLU GEMMs, decode (M = 1) and prefill (M = prompt).
    ms = (1, 600) if not quick else (1,)
    for dname, dt in dtypes:
        for m in ms:
            for k, n in ((D_MODEL, D_FF), (D_FF, D_MODEL)):
                a = randn((m, k), dt)
                b = randn((k, n), dt, scale=k ** -0.5)
                out = mm(a, b)
                torch.cuda.synchronize()
                ref = matmul_ref(a, b)
                timing = None
                if not quick:
                    nb = (m * k + k * n + m * n) * a.element_size()
                    t_b, by = bound(nb, 2.0 * m * k * n, dname)
                    copies = [(randn((m, k), dt), randn((k, n), dt))
                              for _ in range(copies_for(nb))]
                    timing = dict(
                        ms=time_ms([lambda x=x, y=y: mm(x, y)
                                    for x, y in copies]),
                        plain_ms=time_ms([lambda x=x, y=y: matmul_ref(x, y)
                                          for x, y in copies]),
                        library_ms=library_ms([lambda x=x, y=y: torch.matmul(x, y)
                                            for x, y in copies]),
                        bound_ms=t_b, bound_by=by,
                        shape=dict(m=m, k=k, n=n))
                record("matmul", f"m={m} k={k} n={n}", dname, out, ref, timing)

    # -- flash_attention: whole-prompt prefill, B = 1, Hq = 16, Hkv = 2.
    lengths = (16, 100, 257, 512, 600) if not quick else (257,)
    for dname, dt in dtypes:
        for s in lengths:
            q = randn((1, HQ, s, HEAD_DIM), dt)
            k = randn((1, HKV, s, HEAD_DIM), dt)
            v = randn((1, HKV, s, HEAD_DIM), dt)
            out = flash_attention(q, k, v, causal=True)
            torch.cuda.synchronize()
            ref = flash_attention_ref(q, k, v, causal=True)
            timing = None
            if not quick and s == 512:
                nb = (2 * q.numel() + 2 * k.numel()) * q.element_size()
                pairs = s * (s + 1) // 2
                t_b, by = bound(nb, 4.0 * HEAD_DIM * HQ * pairs, dname)
                copies = [(randn(q.shape, dt), randn(k.shape, dt),
                           randn(v.shape, dt)) for _ in range(copies_for(nb))]
                timing = dict(
                    ms=time_ms([lambda x=x, y=y, z=z: flash_attention(
                        x, y, z, causal=True) for x, y, z in copies]),
                    plain_ms=time_ms([lambda x=x, y=y, z=z: flash_attention_ref(
                        x, y, z, causal=True) for x, y, z in copies]),
                    library_ms=library_ms([
                        lambda x=x, y=y, z=z: F.scaled_dot_product_attention(
                            x, y, z, is_causal=True, enable_gqa=True)
                        for x, y, z in copies]),
                    bound_ms=t_b, bound_by=by,
                    shape=dict(b=1, hq=HQ, hkv=HKV, sq=s, skv=s, d=HEAD_DIM))
            record("flash_attention", f"sq=skv={s} causal", dname, out, ref,
                   timing)
        if not quick:
            s = 300
            q = randn((2, HQ, s, HEAD_DIM), dt)
            k = randn((2, HKV, s, HEAD_DIM), dt)
            v = randn((2, HKV, s, HEAD_DIM), dt)
            for case, kw in (("b=2 window=64", dict(window=64)),
                             ("b=2 softcap=5", dict(softcap=5.0)),
                             ("b=2 q_offset=100 (sq=200)",
                              dict(q_offset=100))):
                qq = q[:, :, :200].contiguous() if "q_offset" in case else q
                out = flash_attention(qq, k, v, causal=True, **kw)
                torch.cuda.synchronize()
                ref = flash_attention_ref(qq, k, v, causal=True, **kw)
                record("flash_attention", case, dname, out, ref)

    # -- flash_decode: one query over the linear cache of max_len slots.
    s = MAX_LEN
    cases = [("pos=0", dict(pos=0)), ("pos=37", dict(pos=37)),
             ("pos=511", dict(pos=511)), ("pos=1023", dict(pos=1023)),
             ("pos=511 window=100", dict(pos=511, window=100)),
             ("pos=300 softcap=5", dict(pos=300, softcap=5.0))]
    gcpu = torch.Generator().manual_seed(1)
    kv_pos = torch.arange(s, dtype=torch.int32)
    kv_pos[torch.rand(s, generator=gcpu) < 0.3] = -1
    cases.append(("pos=800 kv_pos(-1 slots)",
                  dict(pos=800, kv_pos=kv_pos.to(dev))))
    ring = torch.full((s,), -1, dtype=torch.int32)
    p_end = 1500
    written = torch.arange(p_end - s + 1 + 200, p_end + 1, dtype=torch.int32)
    ring[(written % s).long()] = written
    cases.append(("pos=1500 ring kv_pos window=700",
                  dict(pos=p_end, kv_pos=ring.to(dev), window=700)))
    if quick:
        cases = [cases[2], cases[-2]]
    for dname, dt in dtypes:
        for case, kw in cases:
            q = randn((1, HQ, HEAD_DIM), dt)
            k = randn((1, HKV, s, HEAD_DIM), dt)
            v = randn((1, HKV, s, HEAD_DIM), dt)
            out = flash_decode(q, k, v, **kw)
            torch.cuda.synchronize()
            ref = flash_decode_ref(q, k, v, **kw)
            timing = None
            if not quick and case == "pos=511":
                pos = kw["pos"]
                seen = pos + 1
                eb = q.element_size()
                nb = (2 * q.numel() + 2 * HKV * seen * HEAD_DIM) * eb
                t_b, by = bound(nb, 4.0 * HEAD_DIM * HQ * seen, dname)
                mask = (torch.arange(s, device=dev) <= pos)[None, None, None]
                copies = [(randn(q.shape, dt), randn(k.shape, dt),
                           randn(v.shape, dt)) for _ in range(copies_for(nb))]
                timing = dict(
                    ms=time_ms([lambda x=x, y=y, z=z: flash_decode(
                        x, y, z, pos=pos) for x, y, z in copies]),
                    plain_ms=time_ms([lambda x=x, y=y, z=z: flash_decode_ref(
                        x, y, z, pos=pos) for x, y, z in copies]),
                    library_ms=library_ms([
                        lambda x=x, y=y, z=z: F.scaled_dot_product_attention(
                            x[:, :, None], y, z, attn_mask=mask,
                            enable_gqa=True) for x, y, z in copies]),
                    bound_ms=t_b, bound_by=by,
                    shape=dict(b=1, hq=HQ, hkv=HKV, s=s, pos=pos, d=HEAD_DIM))
            record("flash_decode", case, dname, out, ref, timing)
        if not quick:
            q = randn((2, HQ, HEAD_DIM), dt)
            k = randn((2, HKV, s, HEAD_DIM), dt)
            v = randn((2, HKV, s, HEAD_DIM), dt)
            out = flash_decode(q, k, v, pos=700)
            torch.cuda.synchronize()
            record("flash_decode", "b=2 pos=700", dname, out,
                   flash_decode_ref(q, k, v, pos=700))
    head_dim_256_checks(record, randn, dtypes, quick)
    bilinear_checks(record, randn, dtypes, quick)
    ssd_checks(record, dtypes, quick)
    rglru_checks(record, dtypes, quick)
    bad = [r for r in rows if not r["ok"]]
    check(not bad, f"{len(bad)} kernel check(s) disagree with the plain "
                   f"version: {[(r['kernel'], r['case'], r['dtype']) for r in bad]}")
    return rows


def head_dim_256_checks(record, randn, dtypes, quick: bool):
    """flash_attention and flash_decode at recurrentgemma-9b's local
    attention: Hq 16, Hkv 1, head_dim 256, window 2048."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.decode import (
        flash_decode, flash_decode_ref,
    )
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
    )
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    hq, hkv, d, win = 16, 1, 256, 2048
    s = 1024 if quick else 4096
    for dname, dt in dtypes:
        q = randn((1, hq, s, d), dt)
        k, v = randn((1, hkv, s, d), dt), randn((1, hkv, s, d), dt)
        out = flash_attention(q, k, v, causal=True, window=win)
        torch.cuda.synchronize()
        ref = flash_attention_ref(q, k, v, causal=True, window=win)
        timing = None
        if not quick:
            nb = (2 * q.numel() + 2 * k.numel()) * q.element_size()
            pairs = sum(min(i + 1, win) for i in range(s))
            t_b, by = bound(nb, 4.0 * d * hq * pairs, dname)
            pos = torch.arange(s, device="cuda")
            mask = ((pos[None, :] <= pos[:, None])
                    & (pos[None, :] > pos[:, None] - win))
            copies = [(randn(q.shape, dt), randn(k.shape, dt),
                       randn(v.shape, dt)) for _ in range(copies_for(nb))]
            timing = dict(
                ms=time_ms([lambda x=x, y=y, z=z: flash_attention(
                    x, y, z, causal=True, window=win) for x, y, z in copies]),
                plain_ms=time_ms([lambda x=x, y=y, z=z: flash_attention_ref(
                    x, y, z, causal=True, window=win) for x, y, z in copies],
                    iters=4),
                library_ms=library_ms([
                    lambda x=x, y=y, z=z: F.scaled_dot_product_attention(
                        x, y, z, attn_mask=mask, enable_gqa=True)
                    for x, y, z in copies]),
                bound_ms=t_b, bound_by=by,
                shape=dict(b=1, hq=hq, hkv=hkv, sq=s, skv=s, d=d, window=win))
        record("flash_attention", f"D=256 sq=skv={s} window={win}", dname,
               out, ref, timing)
        qd = randn((1, hq, d), dt)
        out = flash_decode(qd, k, v, pos=s - 1, window=win)
        torch.cuda.synchronize()
        ref = flash_decode_ref(qd, k, v, pos=s - 1, window=win)
        timing = None
        if not quick:
            seen = min(s, win)
            nb = (2 * qd.numel() + 2 * hkv * seen * d) * qd.element_size()
            t_b, by = bound(nb, 4.0 * d * hq * seen, dname)
            kp = torch.arange(s, device="cuda")
            mask = (kp > s - 1 - win)[None, None, None]
            copies = [(randn(qd.shape, dt), randn(k.shape, dt),
                       randn(v.shape, dt)) for _ in range(copies_for(nb))]
            timing = dict(
                ms=time_ms([lambda x=x, y=y, z=z: flash_decode(
                    x, y, z, pos=s - 1, window=win) for x, y, z in copies]),
                plain_ms=time_ms([lambda x=x, y=y, z=z: flash_decode_ref(
                    x, y, z, pos=s - 1, window=win) for x, y, z in copies]),
                library_ms=library_ms([
                    lambda x=x, y=y, z=z: F.scaled_dot_product_attention(
                        x[:, :, None], y, z, attn_mask=mask, enable_gqa=True)
                    for x, y, z in copies]),
                bound_ms=t_b, bound_by=by,
                shape=dict(b=1, hq=hq, hkv=hkv, s=s, pos=s - 1, d=d,
                           window=win))
        record("flash_decode", f"D=256 s={s} pos={s - 1} window={win}",
               dname, out, ref, timing)


def bilinear_checks(record, randn, dtypes, quick: bool):
    """The paper's 800x800 image at scales 2-10. The library yardstick is
    ``F.grid_sample`` on the same source positions (align_corners, border
    padding), timed in float32 with its error against the plain version."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.bilinear.ops import upscale
    from repro_torch.kernels.bilinear.ref import (
        bilinear_upscale_ref, source_positions,
    )

    side = 800
    for dname, dt in dtypes:
        for scale in ((4,) if quick else (2, 4, 6, 8, 10)):
            src = randn((side, side), dt)
            out = upscale(src, scale)
            torch.cuda.synchronize()
            ref = bilinear_upscale_ref(src, scale)
            timing = None
            if not quick:
                eb = src.element_size()
                nb = (side * side + (side * scale) ** 2) * eb
                t_b, by = bound(nb, 10.0 * (side * scale) ** 2, dname)
                copies = [randn(src.shape, dt) for _ in range(copies_for(nb))]
                lib = lib_err = None
                if dt == torch.float32:
                    p = source_positions(side, scale, "cuda") * (2.0 / (side - 1)) - 1.0
                    grid = torch.stack(torch.broadcast_tensors(
                        p[None, :], p[:, None]), dim=-1)[None]

                    def gs(x):
                        return F.grid_sample(x[None, None], grid, mode="bilinear",
                                             padding_mode="border",
                                             align_corners=True)[0, 0]

                    # A speed yardstick only: it renormalises the positions
                    # to [-1, 1] and back, so it differs from the plain
                    # version by float rounding; its error is printed.
                    lib_err = max_err(gs(src), ref)
                    lib = library_ms([lambda x=x: gs(x) for x in copies])
                timing = dict(
                    ms=time_ms([lambda x=x: upscale(x, scale) for x in copies]),
                    plain_ms=time_ms([lambda x=x: bilinear_upscale_ref(x, scale)
                                      for x in copies], iters=8),
                    library_ms=lib, library_max_abs_err=lib_err,
                    bound_ms=t_b, bound_by=by,
                    shape=dict(src_h=side, src_w=side, scale=scale))
            record("bilinear", f"{side}x{side} scale={scale}", dname, out, ref,
                   timing)


def _ssd_operands(b, s, h, p, n, dt, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    log_a = -(torch.rand((b, h, s), generator=g, device="cuda") * 0.1).to(dt)
    dtx = (torch.randn((b, s, h, p), generator=g, device="cuda") * 0.05).to(dt)
    bm = torch.randn((b, s, n), generator=g, device="cuda").to(dt)
    cm = torch.randn((b, s, n), generator=g, device="cuda").to(dt)
    h0 = torch.randn((b, h, n, p), generator=g, device="cuda").to(dt)
    return log_a, dtx, bm, cm, h0


def ssd_checks(record, dtypes, quick: bool):
    """The SSD chunk scan at mamba2-2.7b's width (H 80, P 64, N 128), a
    4096-step sequence and one decode step; no PyTorch call computes it."""
    import torch

    from repro_torch.kernels.ssd.ops import SPEC, ssd_scan, ssd_scan_ref

    h, p, n = 80, 64, 128
    for dname, dt in dtypes:
        for s in ((512,) if quick else (4096, 1)):
            ops_in = _ssd_operands(1, s, h, p, n, dt, seed=s)
            (q,) = SPEC.default_tile(dict(s=s, h=h, p=p, n=n), dname)
            y, hl = ssd_scan(*ops_in, chunk=q)
            torch.cuda.synchronize()
            yr, hr = ssd_scan_ref(*ops_in, chunk=q)
            timing = None
            if not quick:
                eb = ops_in[1].element_size()
                # Every input once, y (like dtx) and h_last (like h0) out.
                nb = (sum(t.numel() for t in ops_in) + ops_in[1].numel()
                      + ops_in[4].numel()) * eb
                chunks = -(-s // q)
                flops = h * chunks * (2.0 * q * q * n + 2.0 * q * q * p
                                      + 4.0 * q * n * p)
                t_b, by = bound(nb, flops, dname)
                copies = [_ssd_operands(1, s, h, p, n, dt, seed=100 + i)
                          for i in range(copies_for(nb))]
                timing = dict(
                    ms=time_ms([lambda c=c: ssd_scan(*c, chunk=q) for c in copies]),
                    plain_ms=time_ms([lambda c=c: ssd_scan_ref(*c, chunk=q)
                                      for c in copies], iters=4),
                    library_ms=None, bound_ms=t_b, bound_by=by,
                    shape=dict(b=1, s=s, h=h, p=p, n=n, chunk=q))
            record("ssd", f"s={s} h={h} p={p} n={n} y", dname, y, yr, timing)
            record("ssd", f"s={s} h={h} p={p} n={n} h_last", dname, hl, hr)


def rglru_checks(record, dtypes, quick: bool):
    """The RG-LRU scan at recurrentgemma-9b's width (F 4096), a 4096-step
    sequence and one decode step; no PyTorch call computes it."""
    import torch

    from repro_torch.kernels.rglru.ops import rglru_scan, rglru_scan_ref

    f = 4096
    for dname, dt in dtypes:
        for s in ((256,) if quick else (4096, 1)):
            def operands(seed):
                g = torch.Generator(device="cuda").manual_seed(seed)
                return (torch.rand((1, s, f), generator=g, device="cuda").to(dt),
                        torch.randn((1, s, f), generator=g, device="cuda").to(dt),
                        torch.randn((1, f), generator=g, device="cuda").to(dt))

            a, x, h0 = operands(s)
            y, hl = rglru_scan(a, x, h0)
            torch.cuda.synchronize()
            yr, hr = rglru_scan_ref(a, x, h0)
            timing = None
            if not quick:
                eb = x.element_size()
                nb = (3 * s * f + 2 * f) * eb
                t_b, by = bound(nb, 2.0 * s * f, dname)
                copies = [operands(100 + i) for i in range(copies_for(nb))]
                timing = dict(
                    ms=time_ms([lambda c=c: rglru_scan(*c) for c in copies]),
                    plain_ms=time_ms([lambda c=c: rglru_scan_ref(*c)
                                      for c in copies], iters=2),
                    library_ms=None, bound_ms=t_b, bound_by=by,
                    shape=dict(b=1, s=s, f=f))
            record("rglru", f"s={s} f={f} y", dname, y, yr, timing)
            record("rglru", f"s={s} f={f} h_last", dname, hl, hr)


# ---------------------------------------------------------------------------
# Phases 4 and 5: full-width qwen2-1.5b through the port
# ---------------------------------------------------------------------------

def serve_full_width(cfg, params):
    import numpy as np
    import torch

    from repro_torch.kernels import build
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.metrics import nearest_rank

    def engine():
        return ServeEngine(cfg, params, max_len=MAX_LEN, slots=4,
                           dtype=torch.float32, device="cuda")

    rng = np.random.default_rng(0)
    # Warm-up: load the kernels' libraries and set their attributes.
    warm = engine()
    warm.add_request(rng.integers(2, cfg.vocab_size, size=32), max_new_tokens=2)
    warm.run_until_done()
    torch.cuda.synchronize()

    lengths = (16, 100, 257, 384, 511, 600)
    new_tokens = 16
    prompts = [rng.integers(2, cfg.vocab_size, size=n) for n in lengths]
    eng = engine()
    build.reset_launches()
    t0 = time.perf_counter()
    rids = [eng.add_request(p, max_new_tokens=new_tokens) for p in prompts]
    done = eng.run_until_done()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    check(all(r is not None for r in rids), f"requests rejected: {rids}")
    check(len(done) == len(prompts),
          f"{len(done)} of {len(prompts)} requests finished")
    for r in done:
        check(len(r.out_tokens) == new_tokens,
              f"request {r.rid} got {len(r.out_tokens)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.out_tokens),
              f"request {r.rid} has tokens outside the vocabulary")
    for name in SERVE_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was never launched on the serving path")
    toks = sum(len(r.out_tokens) for r in done)
    ttft = sorted(eng.metrics.ttft_since())
    stats = dict(requests=len(done), prompt_lengths=list(lengths),
                 new_tokens=new_tokens, tokens=toks, seconds=dt,
                 tok_per_s=toks / dt, ttft_p50_s=nearest_rank(ttft, 0.5),
                 ttft_max_s=ttft[-1], launches=launches,
                 decode_steps=eng.steps_run,
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"  {len(done)} requests, {toks} tokens in {dt:.3f} s "
        f"({toks / dt:.2f} tok/s), TTFT p50 {stats['ttft_p50_s'] * 1e3:.1f} ms"
        f", max {stats['ttft_max_s'] * 1e3:.1f} ms, {eng.steps_run} steps")
    log(f"  launches on the serving path: {launches}")
    return stats


def full_width_parity(cfg, params):
    import numpy as np
    import torch

    from repro_torch.models import api

    rng = np.random.default_rng(1)
    tokens = rng.integers(2, cfg.vocab_size, size=(1, 384))
    v = cfg.vocab_size
    report = []
    with torch.inference_mode():
        lk, sk = api.prefill(params, cfg, {"tokens": tokens}, max_len=MAX_LEN)
        lr, sr = api.prefill(params, cfg, {"tokens": tokens}, max_len=MAX_LEN,
                             impl="reference")
        steps = [(lk, lr)]
        for _ in range(4):
            tok = torch.argmax(lk[:, :v], dim=-1, keepdim=True)
            lk, sk = api.decode_step(params, cfg, tok, sk)
            lr, sr = api.decode_step(params, cfg, tok, sr, impl="reference")
            steps.append((lk, lr))
    for i, (a, b) in enumerate(steps):
        a, b = a[0, :v].float(), b[0, :v].float()
        check(bool(torch.isfinite(a).all()), f"step {i}: non-finite logits")
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        top2 = torch.topk(b, 2).values
        margin = float(top2[0] - top2[1])
        same = int(a.argmax()) == int(b.argmax())
        tol = LOGIT_REL_TOL * scale
        report.append(dict(step=i, max_abs_err=err, max_logit=scale,
                           tol=tol, top2_margin=margin, same_token=same))
        log(f"  step {i} ({'prefill' if i == 0 else 'decode'}): max |d| "
            f"{err:.3e} vs tol {tol:.3e} (rel {LOGIT_REL_TOL:g} of "
            f"{scale:.3f}); top-2 margin {margin:.3e}, same token {same}")
        check(err <= tol, f"step {i}: kernel logits differ by {err:.3e}")
        check(same or margin <= tol,
              f"step {i}: tokens differ with margin {margin:.3e} > {tol:.3e}")
    return report


def _kernel_group(name: str) -> str:
    for key, group in (("matmul_kernel", "matmul"), ("splitk_reduce", "matmul"),
                       ("flash_attention_kernel", "flash_attention"),
                       ("flash_decode_kernel", "flash_decode")):
        if key in name:
            return group
    if any(key in name.lower() for key in ("gemm", "gemv", "cutlass")):
        return "torch.matmul (qkv, out, head)"
    return "other torch ops"


def profile_request(cfg, params, prompt_len: int = 600, steps: int = 8):
    """Where the time of one full-width request goes: the prefill of a
    ``prompt_len`` prompt and ``steps`` decode steps at batch 1. Per phase:
    the wall time on the host clock (median of 3), then the device time by
    kernel group from ``torch.profiler`` and so the device's idle share."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import api

    tokens = torch.as_tensor(np.random.default_rng(2).integers(
        2, cfg.vocab_size, size=(1, prompt_len)), device="cuda")
    state = {}

    def prefill():
        state["logits"], state["cache"] = api.prefill(
            params, cfg, {"tokens": tokens}, max_len=MAX_LEN)

    def decode():
        for _ in range(steps):
            tok = torch.argmax(state["logits"][:, :cfg.vocab_size], dim=-1,
                               keepdim=True)
            state["logits"], state["cache"] = api.decode_step(
                params, cfg, tok, state["cache"])

    def wall_ms(phase, fn, per):
        if phase == "decode":
            prefill()                             # decode from the same pos
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / per

    out = {}
    with torch.inference_mode():
        prefill(), decode()                       # warm-up
        for phase, fn, per in (("prefill", prefill, 1),
                               ("decode", decode, steps)):
            unit = "request" if phase == "prefill" else "step"
            wall = statistics.median(wall_ms(phase, fn, per)
                                     for _ in range(3))
            log(f"  {phase} ({prompt_len}-token prompt, per {unit}): wall "
                f"{wall:.3f} ms")
            rec = dict(wall_ms=wall)
            if phase == "decode":
                prefill()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            groups, n_kernels = {}, 0
            for ev in prof.events():
                if ev.device_type == DeviceType.CUDA:
                    n_kernels += 1
                    g = _kernel_group(ev.name)
                    groups[g] = groups.get(g, 0.0) + ev.time_range.elapsed_us()
            rec["kernels_per_" + unit] = n_kernels / per
            rec["by_group_ms"] = {g: t / 1e3 / per for g, t in sorted(
                groups.items(), key=lambda kv: -kv[1])}
            if n_kernels:
                busy = sum(rec["by_group_ms"].values())
                rec.update(device_busy_ms=busy,
                           device_idle_share=max(0.0, 1.0 - busy / wall))
                log(f"    profiler: device busy {busy:.3f} ms in "
                    f"{n_kernels / per:.0f} kernels, idle share "
                    f"{rec['device_idle_share']:.3f}")
            else:
                log("    profiler: not measured (it saw no device activity)")
            for g, t in rec["by_group_ms"].items():
                log(f"    {g:32s} {t:.4f} ms")
            out[phase] = rec
    return out


def run_launcher():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + (os.pathsep + env["PYTHONPATH"]
                                    if env.get("PYTHONPATH") else "")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cuda",
         "--requests", "4", "--new-tokens", "6"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    tail = "\n".join(proc.stdout.strip().splitlines()[-14:])
    log("  " + tail.replace("\n", "\n  "))
    check(proc.returncode == 0,
          f"launcher exited {proc.returncode}: {proc.stderr[-2000:]}")
    check("4 requests (0 rejected)" in proc.stdout,
          "launcher did not serve its 4 requests")
    for name in ("matmul", "flash_attention", "flash_decode"):
        check(f"'{name}': 0" not in proc.stdout,
              f"launcher never launched {name}")


# ---------------------------------------------------------------------------
# Phase 7: tile plans on the card
# ---------------------------------------------------------------------------

FIG3_AXIS = [(h, w) for h in (4, 8, 16, 32) for w in (4, 8, 16, 32)]


def plan_jobs():
    """The bounded job set of the plan phase, from the port's own cell
    builders: the paper's bilinear family, the train_4k ssd cell of
    mamba2-2.7b, the train_4k rglru and D = 256 attention cells of
    recurrentgemma-9b, and qwen2-1.5b's serve cells at bucket edge 512 and
    decode (4 slots, 1024)."""
    from repro_torch import configs
    from repro_torch.configs.shapes import TRAIN_4K
    from repro_torch.core import H100_SXM, registry
    from repro_torch.kernels import register_all
    from repro_torch.launch.compile_plans import (
        BILINEAR_PROBLEMS, serve_bucket_cells,
    )
    from repro_torch.launch.specs import cell_problems

    register_all()
    cells = [("bilinear", p) for p in BILINEAR_PROBLEMS]
    mamba = cell_problems(configs.get_arch("mamba2-2.7b"), TRAIN_4K)
    rgemma = cell_problems(configs.get_arch("recurrentgemma-9b"), TRAIN_4K)
    cells += [("ssd", mamba["ssd"]), ("rglru", rgemma["rglru"]),
              ("flash_attention", rgemma["flash_attention"])]
    cells += [(k, p) for k, p in serve_bucket_cells(
        ["qwen2-1.5b"], [512], slots=4, max_len=MAX_LEN)
        if k in registry.names()]
    return [(k, p, "float32", H100_SXM) for k, p in cells]


def plan_phase(out_dir: Path):
    """Compile the bounded job set with wall-clock timing on the card, check
    the artifact, and time the paper's Fig. 3 tiles at every scale. Returns
    the per-cell report and the launches of the compile."""
    import torch

    from repro_torch.core import (
        GEFORCE_8800GTS, GTX260, H100_SXM, Autotuner, TilePlan, compile_plan,
    )
    from repro_torch.core.plans import plan_key
    from repro_torch.core.tiling import TileShape
    from repro_torch.kernels import build
    from repro_torch.launch.measure import make_measure_fn

    jobs = plan_jobs()
    timed = {}

    def factory(kernel, problem, dtype, hw):
        fn = make_measure_fn(kernel, problem, dtype, hw)
        if fn is None:
            return None
        rec = timed.setdefault(plan_key(kernel, problem, dtype, hw.name), [])

        def measure(tile):
            t = fn(tile)
            rec.append((tuple(tile), t))
            return t

        return measure

    build.reset_launches()
    t0 = time.perf_counter()
    plan = compile_plan(jobs, autotuner=Autotuner(), measure_fn_factory=factory,
                        meta={"generated_by": "chip_smoke.py"})
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    check(plan.meta["skipped_jobs"] == 0,
          f"{plan.meta['skipped_jobs']} plan cells skipped")
    check(len(plan) == len(jobs), f"{len(plan)} entries for {len(jobs)} jobs")
    unmeasured = [e.key for e in plan.entries()
                  if e.hardware == "h100_sxm" and not e.measured]
    check(not unmeasured, f"h100_sxm cells not measured: {unmeasured}")
    path = out_dir / "chip_smoke_plans.json"
    out_dir.mkdir(parents=True, exist_ok=True)
    plan.save(str(path))
    loaded = TilePlan.load(str(path))
    cells = []
    log(f"  {len(jobs)} cells compiled and timed in {compile_s:.1f} s")
    for kernel, problem, dtype, hw in jobs:
        res = loaded.resolve(kernel, problem, dtype, hw)
        entry = plan.lookup(kernel, problem, dtype, hw.name)
        check(res is not None and res.source == "exact"
              and res.tile == entry.tile,
              f"{kernel} {problem}: the saved artifact does not resolve "
              f"exactly ({res and res.source})")
        rec = timed[plan_key(kernel, problem, dtype, hw.name)]
        model_best, model_s = rec[0]
        meas_best, meas_s = min(rec, key=lambda r: r[1])
        spread = max(t for _, t in rec) / meas_s
        cells.append(dict(kernel=kernel, problem=dict(problem), dtype=dtype,
                          model_best=list(model_best),
                          model_best_ms=model_s * 1e3,
                          measured_best=list(meas_best),
                          measured_best_ms=meas_s * 1e3,
                          timed=len(rec), spread=spread))
        log(f"  {kernel:16s} {_problem_str(problem):44s} model best "
            f"{TileShape(model_best)} ({model_s * 1e3:.4f} ms), measured best "
            f"{TileShape(meas_best)} ({meas_s * 1e3:.4f} ms), spread "
            f"{spread:.2f}x over {len(rec)} tiles")
    log(f"  launches while compiling: {launches}")

    log("  Fig. 3 on the H100: all 16 tiles of {4,8,16,32}^2 timed per scale "
        "(tile W x H); the paper's GPUs modelled")
    fig3 = []
    tiles = [TileShape(d) for d in FIG3_AXIS]
    for prob in [p for k, p, _, _ in jobs if k == "bilinear"]:
        at = Autotuner()
        res = at.sweep("bilinear", prob, "float32", H100_SXM, tiles=tiles,
                       measure_fn=make_measure_fn("bilinear", prob, "float32",
                                                  H100_SXM),
                       measure_top_k=len(tiles))
        check(all(e.measured_s is not None for e in res.entries),
              "a Fig. 3 tile was not timed")
        row = dict(scale=prob["scale"], h100_best=list(res.best.tile.dims),
                   h100_best_ms=res.best.measured_s * 1e3,
                   h100_sensitivity=res.sensitivity(),
                   h100_ms={_wxh(e.tile): e.measured_s * 1e3
                            for e in res.entries})
        for hw in (GTX260, GEFORCE_8800GTS):
            mod = at.sweep("bilinear_cuda", prob, "float32", hw, tiles=tiles)
            row[hw.name + "_best"] = list(mod.best.tile.dims)
            row[hw.name + "_sensitivity"] = mod.sensitivity()
        fig3.append(row)
        log(f"  scale {prob['scale']:2d}: H100 best {_wxh(res.best.tile)} "
            f"({row['h100_best_ms']:.4f} ms, sensitivity "
            f"{row['h100_sensitivity']:.2f}); modelled GTX260 "
            f"{_wxh(row['gtx260_best'])}, 8800 GTS "
            f"{_wxh(row['geforce_8800gts_best'])}")
    return dict(cells=cells, fig3=fig3, compile_s=compile_s,
                launches=launches)


def _wxh(tile) -> str:
    return f"{tile[1]}x{tile[0]}"


def _problem_str(problem) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(problem.items()))


# ---------------------------------------------------------------------------

KERNEL_META = {
    "matmul": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/matmul.cu",
        replaces="src/repro/kernels/matmul/matmul.py:39",
        headline=dict(dtype="float32", case=f"m=1 k={D_MODEL} n={D_FF}")),
    "flash_attention": dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:98",
        headline=dict(dtype="float32", case="sq=skv=512 causal")),
    "flash_decode": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_decode.cu",
        replaces="src/repro/kernels/flash_attention/decode.py:113",
        headline=dict(dtype="float32", case="pos=511")),
    "bilinear": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/bilinear.cu",
        replaces="src/repro/kernels/bilinear/bilinear.py:73",
        headline=dict(dtype="float32", case="800x800 scale=10")),
    "ssd": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/ssd.cu",
        replaces="src/repro/kernels/ssd/ssd.py:70",
        headline=dict(dtype="float32", case="s=4096 h=80 p=64 n=128 y")),
    "rglru": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/rglru.cu",
        replaces="src/repro/kernels/rglru/rglru.py:50",
        headline=dict(dtype="float32", case="s=4096 f=4096 y")),
}
# The path whose launches each kernel's count is read from.
SERVE_KERNELS = ("matmul", "flash_attention", "flash_decode")
PLAN_KERNELS = ("bilinear", "ssd", "rglru")


def kernels_line(rows, launches):
    out = []
    for name, meta in KERNEL_META.items():
        head = next(r for r in rows if r["kernel"] == name
                    and r["case"] == meta["headline"]["case"]
                    and r["dtype"] == meta["headline"]["dtype"])
        out.append(dict(
            name=name, route=meta["route"], source=meta["source"],
            replaces=meta["replaces"], launches=launches.get(name, 0),
            max_abs_err=max(r["max_abs_err"] for r in rows
                            if r["kernel"] == name and r["dtype"] == "float32"),
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"],
            library_max_abs_err=head.get("library_max_abs_err"),
            shape=dict(head["shape"], dtype=head["dtype"])))
    return {"kernels": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="build with the ptxas report, one check per kernel, "
                         "and stop")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one full-width request with "
                         "torch.profiler: where its time goes")
    ap.add_argument("--out", default=None,
                    help="write every measurement of the run here (JSON)")
    args = ap.parse_args(argv)

    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: FAIL: the port's sources are not beside this "
              f"script ({SRC / 'repro_torch'} is missing)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()
    result = {}
    try:
        # 1. The card.
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
        check(smi.returncode == 0 and card, f"nvidia-smi failed: {smi.stderr}")
        log(card)
        result["card"] = card
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        # 2. Build.
        from repro_torch.kernels import build

        log("== build")
        t0 = time.perf_counter()
        per_source = build.build(verbose=args.quick)
        result["build_s"] = time.perf_counter() - t0
        log(f"  built {sorted(per_source)} in {result['build_s']:.1f} s "
            f"({', '.join(f'{k} {v:.1f} s' for k, v in per_source.items())})")

        phase_s = result["phase_s"] = {"build": result["build_s"]}

        def phase_done(name, t0):
            phase_s[name] = time.perf_counter() - t0
            log(f"  [{name}: {phase_s[name]:.1f} s]")

        # 3. Kernels against their plain versions.
        log("== kernels against their plain versions")
        t0 = time.perf_counter()
        rows = kernel_checks(args.quick)
        result["kernel_checks"] = rows
        phase_done("kernels", t0)
        if args.quick:
            log(json.dumps({"quick": True, "checks": len(rows)}))
        else:
            from repro_torch import configs
            from repro_torch.models import api

            # 4. Full-width serve.
            log("== serve full-width qwen2-1.5b (28 layers, float32)")
            cfg = configs.get_arch("qwen2-1.5b")
            t_phase = t0 = time.perf_counter()
            params = api.init_params(cfg, 0, dtype=torch.float32,
                                     device="cuda")
            torch.cuda.synchronize()
            log(f"  initialised {sum(p.numel() for p in _leaves(params)) / 1e9:.3f}"
                f" B parameters in {time.perf_counter() - t0:.1f} s")
            result["serve"] = serve_full_width(cfg, params)
            phase_done("serve", t_phase)

            # 5. Full-width parity, kernels vs plain versions.
            log("== full-width parity: kernels vs plain versions")
            t0 = time.perf_counter()
            result["parity"] = full_width_parity(cfg, params)
            if args.profile:
                log("== where the time of one full-width request goes")
                result["profile"] = profile_request(cfg, params)
            del params
            torch.cuda.empty_cache()
            phase_done("parity", t0)

            # 6. The launcher.
            log("== launcher (smoke config) on the card")
            t0 = time.perf_counter()
            run_launcher()
            phase_done("launcher", t0)

            # 7. Tile plans on the card.
            log("== tile plans on the card (wall-clock compile)")
            t0 = time.perf_counter()
            result["plans"] = plan_phase(ROOT / "build")
            phase_done("plans", t0)
            for name in PLAN_KERNELS:
                check(result["plans"]["launches"].get(name, 0) > 0,
                      f"kernel {name} was never launched by the plan compile")

            check("jax" not in sys.modules, "jax was imported")
            check(not any(m == "repro" or m.startswith("repro.")
                          for m in sys.modules), "the JAX package was imported")
            launches = {name: result["serve"]["launches"][name]
                        for name in SERVE_KERNELS}
            launches.update({name: result["plans"]["launches"][name]
                             for name in PLAN_KERNELS})
            line = kernels_line(rows, launches)
            result["kernels"] = line["kernels"]
        result["seconds"] = time.perf_counter() - t_start
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(result, indent=1))
    except Exception as exc:  # every phase's failure ends the run here
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        return 1
    log(f"done in {result['seconds']:.1f} s")
    if not args.quick:
        log(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
