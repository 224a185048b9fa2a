#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py                      # every phase; needs one card
    python3 chip_smoke.py --quick              # build with the ptxas report,
                                               # one check per kernel, stop
    python3 chip_smoke.py --out smoke.json     # also write every measurement
    python3 chip_smoke.py --profile            # also profile one request

Phases, each of which fails the run if it fails:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once);
3. hold each kernel against its plain PyTorch version on the card, in
   float32 and bfloat16, at the shapes its path gives it — the full-width
   qwen2-1.5b serving path (the matmul in each of its regimes: decode at
   M = 1 and 4 slots, prefill at M = 600, the plain path for unaligned
   rows; flash_attention in its float32 mma and bf16 wgmma regimes at
   every head dim, and every tile of each regime timed at qwen2's prefill
   widths, S = 600 and 4096; flash_decode with its position read from
   device memory on a grid fixed by the cache length, one position tensor
   moved over {0, bkv - 1, bkv, S / 2, S - 1} and rings with wrapped and
   unwritten slots at head dims 80, 128 and 256), recurrentgemma-9b's
   head_dim-256 attention, h2o-danube-1.8b's head_dim-80 attention
   (prefill at S = 512 and 4096, decode with and without split KV), the
   paper's 800x800 image at scales 2-10 in both dtypes (with the store
   path each took, and images whose rows take scalar stores),
   mamba2-2.7b's SSD (every chunk the spec sweeps, S = 4096, and the
   decode step), recurrentgemma-9b's RG-LRU (a few tiles) and phase 15's
   shapes (flash_attention at deepseek-moe-16b's MHA, 16 / 16 heads at D
   128, in both regimes, at qwen3-moe's 64 / 4 and non-causal at
   whisper's 32 / 32 heads at D 64, 1500 x 1500 and 64 x 1500;
   flash_decode at GQA ratio 1, D 128 and 64, and ratio 16; the matmul at
   K 2048, N 10944 and 2816, M 1 and 600) — and time
   kernel, plain version and one PyTorch library call (where one computes
   the same function; for SDPA also the kernels it ran) on the device: CUDA events around the replay of a CUDA
   graph of many calls, so the host's launch cost is left out; for the
   multi-launch scans also each launch's device time (torch.profiler);
4. serve full-width qwen2-1.5b (28 layers, random weights from a seed)
   through the port's ``ServeEngine``, whose decode steps replay one
   captured CUDA graph per slot, and check that every kernel of the path
   was launched; then time a decode step on the host clock at one slot
   and at four, an eager ``api.decode_step`` loop beside the engine's
   graphs;
4b. the same six requests with tile plans: compile a wall-clock
   ``h100_sxm`` plan of qwen2-1.5b's float32 serving cells (prefill at
   bucket edges 16, 128, 384, 512 and 640, decode at 4 slots and 1024;
   the cost model's best tile beside the measured best per cell), serve
   the requests through ``ServeEngine(plans=...)`` with the plan's bucket
   edges (every prefill an exact hit) and with FIFO (100, 257, 511 and 600
   tokens resolve by nearest shape), hold the tokens against the no-plan
   serves (a token may differ only where the plain top-2 margin is within
   1e-3 of max |logit|), print each kernel's tile and plan source per
   prefill length and for decode, the plan hit rates and the tile_fallback
   count, and time each request's prefill and a captured decode step at 4
   slots beside the no-plan engine's, in turns;
5. hold the full-width prefill logits and four decode steps of one request
   through the kernels against the same request through the plain
   versions, with TF32 off; then 16 captured decode steps of one request:
   their tokens equal an eager loop's, their logits the plain versions'
   within the tolerance;
6. serve full-width h2o-danube-1.8b (24 layers, 4096-slot ring caches)
   through the captured engine: 4 requests, two of which wrap their rings
   (one at prefill), held token by token against the plain versions;
7. gemma2-9b at full width and 4 of its 42 layers: prefill and 8 captured
   decode steps across a ring's wrap, against the plain versions;
8. run the port's launcher (``python -m repro_torch.launch.serve``) at the
   smoke configs of qwen2-1.5b, gemma2-9b, h2o-danube-1.8b, mamba2-2.7b,
   recurrentgemma-9b, deepseek-moe-16b and qwen3-moe-235b-a22b on the card,
   and qwen2-1.5b through the fleet: ``--fleet h100_sxm,gtx260`` on an
   analytic plan of both (each instance's ``tile_fallback`` count printed)
   and ``--fleet h100_sxm --autoscale``;
9. compile tile plans with wall-clock timing on the card (the port's
   ``compile_plan`` with ``make_measure_fn``) over a bounded job set: the
   paper's bilinear family, the train_4k ssd, rglru and head_dim-256
   attention cells, and qwen2-1.5b's serve cells; check that every cell was
   measured, none skipped, and that the saved artifact resolves each cell
   exactly; then time all 16 tiles of the paper's Fig. 3 at every scale
   beside the paper's two GPUs as the cost model sees them;
10. serve full-width mamba2-2.7b (64 layers, float32, random weights from
   seed 0; SSD states) through the captured engine at 4 slots and max_len
   1024: six requests of 16, 64, 100, 257, 600 and 1000 prompt tokens (a
   slot serves a second request), 16 new tokens each, held token by token
   against the plain versions; ssd must launch in the prefills and in the
   replayed decode steps (as many times as steps times its launches a
   step); one request's prefill logits and four decode steps against the
   plain versions; prefill device ms at 600 and 1000 tokens; decode ms a
   step at 1 and 4 slots, eager beside captured;
11. the same for full-width recurrentgemma-9b (all 38 layers: RG-LRU
   states, GeGLU FF, local attention at head_dim 256) at max_len 2304, so
   its local layers keep 2048-slot rings: prompts of 2100 (wraps at
   prefill), 2040 (wraps while decoding), 64 and 500 tokens; matmul,
   flash_attention and rglru must launch in the prefills, matmul,
   flash_decode and rglru in the replayed decode steps;
12. chunked and packed serving at full width (float32, TF32 off): (a)
   qwen2-1.5b at max_len 1280, 4 slots, bucket edges 64, 128 and 512 with
   overflow, a step budget of 260 tokens: phase 4's prompts and a
   1000-token one (600 and 1000 admitted at 1024 by chunking), served
   chunked (2 prefill slots) and packed (3), every token held against the
   plain versions on the padded prompt; flash_attention must launch at
   q_offset > 0 and a packed step must hold two segments; chunks per
   prefill, segments per packed step, launches, and one 256-token chunk's
   device idle share; (b) a 16-token request behind a 1000-token one: its
   time to first token unchunked, chunked and packed (recorded); (c) in
   phase 6, h2o-danube-1.8b's 4200-token prompt in 512-token chunks across
   its 4096-slot rings' wrap against the whole prefill and against the
   same chunks on the plain versions (logits, ring K/V, slot maps), then 8
   captured decode steps from each state give the same tokens; (d) in
   phases 10 and 11, mamba2-2.7b (1000 tokens in chunks of 256) and
   recurrentgemma-9b (2100 in chunks of 512) against their whole
   prefills, logits and states. In (c) and (d) every chunk of every
   attention layer must launch flash_attention, ring layers included. The launcher of phase 8 also serves
   qwen2-1.5b with ``--chunk-prefill``, ``--pack-prefill`` and ``--paged``;
13. paged serving (the KV pool, after phase 12b): (a) full-width
   qwen2-1.5b at max_len 1280, 4 slots, FIFO, phase 12a's prompts and a
   510-token one (two tokens before the default 512-row page's edge),
   unchunked, chunked and packed, on the pool against the unpaged engine:
   tokens held (``hold_tokens``), the pool balanced (allocs = frees),
   matmul, flash_attention and flash_decode launched under paging, each
   slot captured once as unpaged (no recapture when a decode maps a new
   page), the peak pages x page beside the unpaged caches' rows; (b) page
   64: a 768-token donor decodes while its prompt plus 32 tokens arrives,
   then its prompt again (a copy-on-write split): tokens equal to a run
   without sharing, prefix hits and splits, the 800-token request's TTFT
   with and without sharing; (d) the captured decode step paged against
   unpaged at 1 and 4 slots, device and host ms (with ``--profile`` the
   gather's share), and one layer's attention call (gather + flash_decode
   over the 1536-row view beside flash_decode over 1280 rows); (c)
   h2o-danube-1.8b at full width and 4 layers, paged (windowed decode over
   the linear view) against the ring engine's tokens. 13d times each
   attention call beside its plain version and SDPA;
14. request tracing and shadow plan refinement (after phase 12b), on phase
   4's engine (full-width qwen2-1.5b, 4 slots, max_len 1024, captured
   decode, phase 4b's bucket edges) and phase 4's six requests: (a) served
   with and without a ``Tracer`` (off, on, on, off): tokens bit-equal, each
   slot captured once, the trace's TTFT p95 equal to the metrics', the
   trace written (Chrome JSON and JSONL), read back and summarised by
   ``trace_report``; events and wall ms on and off printed; (b) a
   cost-model plan of phase 4b's cells (a GTX260 plan holds none of the
   Hopper kernels' tiles, which is printed), served with a quarter of the
   steps timing a cell's incumbent and a candidate on the card
   (``make_shadow_measure(h100_sxm)``) into a ``PlanRefiner``, the
   requests repeated until every timed cell with candidates holds 3
   samples of both: tokens bit-equal to the shadowless serve every round,
   no slot recaptured, matmul, flash_attention and flash_decode launched
   by the measurements, every time finite (or ``inf`` for a tile that
   would not launch), the allocated bytes flat once every cell's timer is
   built; then ``refine``, the drift report, ``set_plans(refined)`` and a
   serve: tokens held, one recapture per slot, every refined cell exact;
   (c) after phase 11, the paper's four examples (``repro_torch.examples``)
   on the card;
15. the MoE, encoder-decoder and vision models, each after the models of
   the phases before it are released: (a) full-width deepseek-moe-16b (28
   layers, 64 routed experts top-6 and 2 shared, float32, 16.4 B
   parameters from seed 0) served through the captured engine at 4 slots,
   max_len 1024, FIFO: six requests of phase 4's prompt lengths, 16 new
   tokens each, held token by token against the plain versions; matmul
   and flash_attention launched in the prefills, matmul and flash_decode
   in every replayed decode step; one 600-token request's prefill logits
   and four decode steps against the plain versions with every routing
   recorded on both paths (a flip, a token whose top-k set differs, is
   printed and allowed only where the plain k / k+1 probability margin is
   within 1e-5); 16 captured decode steps against an eager loop; prefill
   device ms at 600 tokens, decode ms a step at 1 and 4 slots and the peak
   allocated memory (``--profile``: the split between matmul, attention,
   the experts' torch.bmm, other torch.matmul and other ops); (b)
   qwen3-moe-235b-a22b at full width and 4 of its 94 layers: a 600-token
   prefill and 8 captured decode steps against the plain versions; (c)
   whisper-large-v3 at full width (32 + 32 layers, 1500 frames from a
   seed): the encoder output, a 64-token decoder prefill and 16
   ``api.decode_step``s against the plain versions, flash_attention and
   flash_decode launches counted; (d) internvl2-1b at full width: 256
   patch embeddings and 64 text tokens, then 16 decode steps, against the
   plain versions.

16. the fleet (after phase 14c, before phase 15): full-width qwen2-1.5b
   (28 layers, float32, random weights from seed 0, shared by every
   instance), phase 4's engine (4 slots, max_len 1024, captured decode)
   with phase 4b's bucket edges, 12 requests (phase 4's six prompts and
   six more of their lengths), 16 new tokens each, held against a
   fault-free serve on one engine: (a) two instances under a
   ``FaultScript``: "b" killed while it decodes with work queued, a fresh
   engine joined under its name, "a" stalled while it decodes (the
   watchdog evicts its work onto the new "b") and recovered; every fid
   once, none lost, no slot of "a" recaptured and its slot tensors at
   their addresses, matmul, flash_attention and flash_decode launched
   after the kill, recovered requests' TTFT beside the others', and the
   allocated bytes before the fleet, before and after the kill and after
   the join (the joiner replaces the dead engine's memory); (b) the same
   paged, "b" killed with slots decoding, a prefill in flight and one
   waiting for a slot, every pool balanced; then a 768-token prefix donor
   cancelled under a decoding recipient at page 64 (its tokens those of a
   run without the donor); (c) one instance and a burst of 24 requests
   under the autoscaler (candidates ``h100-1`` and ``h100-2``, both the
   card's own model): a join, and a drain once idle, with the host ms of
   the step that builds a joiner and of its first capture; (d)
   ``roll_plans`` of phase 14b's refined artifact over two instances on
   14b's plan, each behind a probe of phase 4's six requests: tokens held
   and one recapture a slot for each ``set_plans``.

``--profile`` adds, after phase 5, where the time of one full-width qwen2
request goes (prefill, eager decode, captured decode): wall time, device
time by kernel group and the device's idle share; and the same for one
600-token request of each of phases 10 and 11.

Launch counts: matmul, flash_attention and flash_decode are counted over
the serve of phase 15a (the replays of captured steps included; the line
also gives their counts over phase 4's serve), bilinear
over the compile of phase 9, ssd over the serve of phase 10 and rglru over
the serve of phase 11, each reset to 0 just before its path and read just
after (phase 16 prints its own counts over the phase and after the kill,
on lines before the kernels line); phase 4b reads its own counts over its two plan serves and fails
unless each of the serving kernels ran, phase 9 fails unless its compile
launched bilinear, ssd and rglru, and phase 13 sets the counts to 0 before
each paged serve and fails unless matmul, flash_attention and flash_decode
ran in it.

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
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Peak rates of one H100 SXM (NVIDIA's data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12,      # float32 outside the tensor cores
              # float32 as 3xTF32 on the tensor cores: three TF32 products
              # (495 TFLOP/s) for each float32 one
              "float32_3xtf32": 495e12 / 3,
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
    """Median per-call device time of ``fns``. The calls are captured into
    one CUDA graph (a run of ``max(iters, len(fns))`` calls) and CUDA
    events time five replays of it, so what is timed is the device's work
    and not the host's launches (a few microseconds each, more than the
    decode kernels take). Each closure holds its own input copy, and the
    callers pass ``copies_for`` of them: cycled in order, every copy once
    per replay at the least, they overflow the 50 MB L2, so every call
    reads its inputs from HBM."""
    import torch

    calls = itertools.count()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                 # warm-up off the capture
        for _ in range(warmup):
            fns[next(calls) % len(fns)]()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    per_rep = max(iters, len(fns))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(per_rep):
            fns[next(calls) % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for rep in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_rep)
    del graph
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


def bound(nbytes: float, flops: float, rate: str):
    """The least time (ms) for the bytes and the operations; ``rate`` names
    the peak the kernel's arithmetic runs at (a key of PEAK_FLOPS)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[rate] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dev_pos(pos: int):
    """A decode position as a cache holds it: a 0-d int32 tensor on the
    card, which flash_decode reads from device memory."""
    import torch

    return torch.full((), int(pos), dtype=torch.int32, device="cuda")


def ring_map(s: int, pos: int):
    """The slot -> position map of an ``s``-slot ring after position
    ``pos``: unwritten slots (-1) before it wraps, and once it has, the
    first tenth of the slots set back to -1 (slots not reached again)."""
    import torch

    kv_pos = torch.full((s,), -1, dtype=torch.int32)
    lo = max(0, pos - s + 1 + (s // 10 if pos >= s else 0))
    written = torch.arange(lo, pos + 1, dtype=torch.int32)
    kv_pos[(written % s).long()] = written
    return kv_pos.cuda()


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
        decode_splits, flash_decode, flash_decode_ref,
    )
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention, regime as fa_regime,
    )
    from repro_torch.kernels.flash_attention.ops import DECODE_SPEC
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.matmul.ops import mm, regime
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
            if timing.get("launch_ms"):
                extra += " | launches " + ", ".join(
                    f"{k} {v:.4f}" for k, v in timing["launch_ms"].items())
        log(f"  {kernel:16s} {case:34s} {dtype_name:8s} err {err:.3e} "
            f"(tol {REL_TOL[dtype_name]:g} x {max(1.0, row['ref_max']):.3g})"
            f" {'ok' if ok else 'FAIL'}{extra}")
        return row

    dtypes = (("float32", torch.float32), ("bfloat16", torch.bfloat16))

    # -- matmul: the SwiGLU GEMMs in each regime: decode at one slot and at
    # four (skinny), prefill of a 600-token prompt (simt in float32, wgmma
    # in bf16); then ragged checks, N = 1001 taking the plain path.
    ms = (1, 4, 600) if not quick else (1, 600)
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
                        shape=dict(m=m, k=k, n=n, regime=regime(m, n, k, dt)))
                record("matmul", f"m={m} k={k} n={n}", dname, out, ref, timing)
        if not quick:
            for m, k, n in ((4, 1000, 1001), (601, 1000, 1001),
                            (17, 1000, 1536), (601, 8960, 1000)):
                a = randn((m, k), dt)
                b = randn((k, n), dt, scale=k ** -0.5)
                out = mm(a, b)
                torch.cuda.synchronize()
                record("matmul", f"m={m} k={k} n={n} "
                       f"({regime(m, n, k, dt)})", dname, out,
                       matmul_ref(a, b))

    # -- flash_attention: whole-prompt prefill, B = 1, Hq = 16, Hkv = 2, in
    # the dtype's regime (mma in float32, wgmma in bf16).
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
                t_b, by = bound(nb, 4.0 * HEAD_DIM * HQ * pairs,
                                TC_RATE[dname])
                copies = [(randn(q.shape, dt), randn(k.shape, dt),
                           randn(v.shape, dt)) for _ in range(copies_for(nb))]

                def sdpa(x, y, z):
                    return F.scaled_dot_product_attention(
                        x, y, z, is_causal=True, enable_gqa=True)

                timing = dict(
                    ms=time_ms([lambda x=x, y=y, z=z: flash_attention(
                        x, y, z, causal=True) for x, y, z in copies]),
                    plain_ms=time_ms([lambda x=x, y=y, z=z: flash_attention_ref(
                        x, y, z, causal=True) for x, y, z in copies]),
                    library_ms=library_ms([lambda x=x, y=y, z=z: sdpa(x, y, z)
                                           for x, y, z in copies]),
                    library_kernels=sorted(device_kernels(lambda: sdpa(q, k, v))),
                    bound_ms=t_b, bound_by=by,
                    shape=dict(b=1, hq=HQ, hkv=HKV, sq=s, skv=s, d=HEAD_DIM,
                               regime=fa_regime(dt, HEAD_DIM)))
            record("flash_attention", f"sq=skv={s} causal", dname, out, ref,
                   timing)
        if not quick:
            # A chunk of the chunked prefill (phase 12): 256 queries at
            # q_offset 512 over the 768 keys written so far, with the tile
            # the chunk path launches.
            from repro_torch.kernels.flash_attention.ops import (
                chunk_launch_tile, CHUNKED_SPEC,
            )

            start, sq = IDLE_CHUNK
            q = randn((1, HQ, sq, HEAD_DIM), dt)
            k = randn((1, HKV, start + sq, HEAD_DIM), dt)
            v = randn((1, HKV, start + sq, HEAD_DIM), dt)
            prob = dict(sq=start + sq, skv=start + sq, d=HEAD_DIM, hq=12,
                        hkv=HKV, window=0)
            tile = chunk_launch_tile(CHUNKED_SPEC.default_tile(prob, dname),
                                     sq, 12, HEAD_DIM, dt)
            out = flash_attention(q, k, v, causal=True, q_offset=start,
                                  tile=tile)
            torch.cuda.synchronize()
            ref = flash_attention_ref(q, k, v, causal=True, q_offset=start)
            nb = (2 * q.numel() + 2 * k.numel()) * q.element_size()
            pairs = sq * start + sq * (sq + 1) // 2
            t_b, by = bound(nb, 4.0 * HEAD_DIM * HQ * pairs, TC_RATE[dname])
            copies = [(randn(q.shape, dt), randn(k.shape, dt),
                       randn(v.shape, dt)) for _ in range(copies_for(nb))]
            # SDPA takes the offset causal mask as a boolean mask.
            mask = (torch.arange(start + sq, device=dev)[None, :]
                    <= start + torch.arange(sq, device=dev)[:, None])

            def sdpa(x, y, z):
                return F.scaled_dot_product_attention(
                    x, y, z, attn_mask=mask, enable_gqa=True)

            record("flash_attention", f"chunk sq={sq} q_offset={start}",
                   dname, out, ref, dict(
                       ms=time_ms([lambda x=x, y=y, z=z: flash_attention(
                           x, y, z, causal=True, q_offset=start, tile=tile)
                           for x, y, z in copies]),
                       plain_ms=time_ms([
                           lambda x=x, y=y, z=z: flash_attention_ref(
                               x, y, z, causal=True, q_offset=start)
                           for x, y, z in copies]),
                       library_ms=library_ms([
                           lambda x=x, y=y, z=z: sdpa(x, y, z)
                           for x, y, z in copies]),
                       bound_ms=t_b, bound_by=by,
                       shape=dict(b=1, hq=HQ, hkv=HKV, sq=sq,
                                  skv=start + sq, q_offset=start,
                                  d=HEAD_DIM, tile=list(tile),
                                  regime=fa_regime(dt, HEAD_DIM))))
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
        # Every head dim below qwen2's, at its 16 / 2 heads.
        for d in (16, 32, 64):
            s = 257 if quick else 600
            q = randn((1, HQ, s, d), dt)
            k, v = randn((1, HKV, s, d), dt), randn((1, HKV, s, d), dt)
            out = flash_attention(q, k, v, causal=True)
            torch.cuda.synchronize()
            record("flash_attention", f"D={d} sq=skv={s} causal", dname, out,
                   flash_attention_ref(q, k, v, causal=True))
    if not quick:
        rows.extend(flash_tile_sweep(randn, dtypes))

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
            # The kernel reads the position from device memory, as a
            # cache's 0-d position tensor holds it.
            kd = dict(kw, pos=dev_pos(kw["pos"]))
            out = flash_decode(q, k, v, **kd)
            torch.cuda.synchronize()
            ref = flash_decode_ref(q, k, v, **kw)
            timing = None
            # pos 511 is the headline; 0 and 1023 show the grid fixed by S
            # at its emptiest (one split of 66 has a block) and its fullest.
            if not quick and case in ("pos=0", "pos=511", "pos=1023"):
                pos = kw["pos"]
                seen = pos + 1
                eb = q.element_size()
                nb = (2 * q.numel() + 2 * HKV * seen * HEAD_DIM) * eb
                t_b, by = bound(nb, 4.0 * HEAD_DIM * HQ * seen, dname)
                mask = (torch.arange(s, device=dev) <= pos)[None, None, None]
                copies = [(randn(q.shape, dt), randn(k.shape, dt),
                           randn(v.shape, dt)) for _ in range(copies_for(nb))]
                pos_t = kd["pos"]
                bkv = DECODE_SPEC.default_tile(
                    dict(b=1, skv=s, d=HEAD_DIM, hq=HQ, hkv=HKV, window=0),
                    dname)[0]
                sp = decode_splits(1, HKV, s, bkv, pos, True)
                timing = dict(
                    ms=time_ms([lambda x=x, y=y, z=z: flash_decode(
                        x, y, z, pos=pos_t) for x, y, z in copies]),
                    plain_ms=time_ms([lambda x=x, y=y, z=z: flash_decode_ref(
                        x, y, z, pos=pos_t) for x, y, z in copies]),
                    library_ms=library_ms([
                        lambda x=x, y=y, z=z: F.scaled_dot_product_attention(
                            x[:, :, None], y, z, attn_mask=mask,
                            enable_gqa=True) for x, y, z in copies]),
                    bound_ms=t_b, bound_by=by,
                    shape=dict(b=1, hq=HQ, hkv=HKV, s=s, pos=pos, d=HEAD_DIM,
                               bkv=bkv, splits=sp.splits,
                               blocks_visited=sp.n_blk))
            record("flash_decode", case, dname, out, ref, timing)
        if not quick:
            q = randn((2, HQ, HEAD_DIM), dt)
            k = randn((2, HKV, s, HEAD_DIM), dt)
            v = randn((2, HKV, s, HEAD_DIM), dt)
            out = flash_decode(q, k, v, pos=dev_pos(700))
            torch.cuda.synchronize()
            record("flash_decode", "b=2 pos=700", dname, out,
                   flash_decode_ref(q, k, v, pos=700))
    decode_position_checks(record, randn, dtypes, quick)
    head_dim_256_checks(record, randn, dtypes, quick)
    head_dim_80_checks(record, randn, dtypes, quick)
    moe_slice_checks(record, randn, dtypes, quick)
    bilinear_checks(record, randn, dtypes, quick)
    ssd_checks(record, dtypes, quick)
    rglru_checks(record, dtypes, quick)
    bad = [r for r in rows if not r["ok"]]
    check(not bad, f"{len(bad)} kernel check(s) disagree with the plain "
                   f"version: {[(r['kernel'], r['case'], r['dtype']) for r in bad]}")
    return rows


def decode_position_checks(record, randn, dtypes, quick: bool):
    """flash_decode with its position in device memory and its grid fixed
    by S = 1024, at h2o-danube-1.8b's (Hq 32, Hkv 8, D 80), qwen2-1.5b's
    (16, 2, 128) and recurrentgemma-9b's (16, 1, 256) heads: one position
    tensor moved over {0, bkv - 1, bkv, S / 2, S - 1} on a linear cache,
    then a ring (kv_pos) half written, wrapped, and wrapped twice with
    slots not reached again. Each launch is held against the plain version
    and the kernel's split arithmetic (``flash_decode_split_ref``)."""
    import torch

    from repro_torch.kernels.flash_attention.decode import (
        flash_decode, flash_decode_ref, flash_decode_split_ref,
    )
    from repro_torch.kernels.flash_attention.ops import DECODE_SPEC

    s = 1024
    heads = ((32, 8, 80), (HQ, HKV, HEAD_DIM), (16, 1, 256))
    for hq, hkv, d in heads[1:2] if quick else heads:
        for dname, dt in dtypes:
            q = randn((1, hq, d), dt)
            k, v = randn((1, hkv, s, d), dt), randn((1, hkv, s, d), dt)
            bkv = DECODE_SPEC.default_tile(dict(b=1, skv=s, d=d, hq=hq,
                                                hkv=hkv, window=0), dname)[0]
            sweep = [("linear", p) for p in (0, bkv - 1, bkv, s // 2, s - 1)]
            sweep += [("ring", p) for p in (s // 2, s + 37, 3 * s - 1)]
            pos = dev_pos(0)
            for cache, p in sweep:
                kw = dict(kv_pos=ring_map(s, p)) if cache == "ring" else {}
                pos.fill_(p)
                out = flash_decode(q, k, v, pos=pos, **kw)
                torch.cuda.synchronize()
                split = flash_decode_split_ref(q, k, v, pos=p, bkv=bkv, **kw)
                err = max_err(out, split)
                check(within(err, split, dname),
                      f"flash_decode D={d} pos={p} {cache} {dname}: kernel "
                      f"and its split arithmetic differ by {err:.3e}")
                record("flash_decode", f"D={d} device pos={p} {cache}", dname,
                       out, flash_decode_ref(q, k, v, pos=p, **kw))


# The rate the tensor-core kernels (flash_attention, ssd) run at: 3xTF32 on
# the tensor cores in float32, bf16 in bfloat16.
TC_RATE = {"float32": "float32_3xtf32", "bfloat16": "bfloat16"}


def device_kernels(fn, calls: int = 5):
    """Device ms per call of each CUDA kernel a call of ``fn`` runs (from
    ``torch.profiler``), by kernel name: where a multi-launch kernel's time
    goes, and which backend a library call took."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            name = re.sub(r"^void |\(anonymous namespace\)::", "", ev.name)
            name = re.sub(r"\(.*", "", name).split("::")[-1]
            out[name] = out.get(name, 0.0) + ev.time_range.elapsed_us() / 1e3 / calls
    return out


def flash_tile_sweep(randn, dtypes):
    """Every tile of the dtype's flash_attention regime at qwen2-1.5b's
    prefill widths (Hq 16, Hkv 2, D 128, causal; S = 600 and 4096), each
    checked against the plain version and timed: where the spec's default
    tiles come from. Returns one row per (dtype, S, tile)."""
    import torch

    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention, regime_tiles,
    )
    from repro_torch.kernels.flash_attention.ops import FLASH_SPEC
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    out = []
    for dname, dt in dtypes:
        for s in (600, 4096):
            q = randn((1, HQ, s, HEAD_DIM), dt)
            k, v = randn((1, HKV, s, HEAD_DIM), dt), randn((1, HKV, s, HEAD_DIM), dt)
            ref = flash_attention_ref(q, k, v, causal=True)
            nb = (2 * q.numel() + 2 * k.numel()) * q.element_size()
            copies = [(randn(q.shape, dt), randn(k.shape, dt),
                       randn(v.shape, dt)) for _ in range(copies_for(nb))]
            default = tuple(FLASH_SPEC.default_tile(
                dict(sq=s, skv=s, d=HEAD_DIM, hq=HQ, hkv=HKV, window=0),
                dname))
            for tile in regime_tiles(dt, HEAD_DIM):
                res = flash_attention(q, k, v, causal=True, tile=tile)
                torch.cuda.synchronize()
                err = max_err(res, ref)
                ms = time_ms([lambda x=x, y=y, z=z: flash_attention(
                    x, y, z, causal=True, tile=tile) for x, y, z in copies])
                row = dict(kernel="flash_attention",
                           case=f"tile {tile[0]}x{tile[1]} sq=skv={s}",
                           dtype=dname, max_abs_err=err,
                           ref_max=float(ref.float().abs().max()),
                           rel_tol=REL_TOL[dname], ok=within(err, ref, dname),
                           tile_ms=ms, default=tile == default)
                out.append(row)
                log(f"  flash_attention  tile {tile[0]:3d}x{tile[1]:<3d} "
                    f"sq=skv={s:<5d} {dname:8s} err {err:.3e} "
                    f"{'ok' if row['ok'] else 'FAIL'} | {ms:.4f} ms"
                    f"{' (default)' if row['default'] else ''}")
    return out


def head_dim_256_checks(record, randn, dtypes, quick: bool):
    """flash_attention and flash_decode at recurrentgemma-9b's local
    attention: Hq 16, Hkv 1, head_dim 256, window 2048."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.decode import (
        flash_decode, flash_decode_ref,
    )
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention, regime as fa_regime,
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
            t_b, by = bound(nb, 4.0 * d * hq * pairs, TC_RATE[dname])
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
                library_kernels=sorted(device_kernels(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=True))),
                bound_ms=t_b, bound_by=by,
                shape=dict(b=1, hq=hq, hkv=hkv, sq=s, skv=s, d=d, window=win,
                           regime=fa_regime(dt, d)))
        record("flash_attention", f"D=256 sq=skv={s} window={win}", dname,
               out, ref, timing)
        qd = randn((1, hq, d), dt)
        pos_t = dev_pos(s - 1)
        out = flash_decode(qd, k, v, pos=pos_t, window=win)
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
                    x, y, z, pos=pos_t, window=win) for x, y, z in copies]),
                plain_ms=time_ms([lambda x=x, y=y, z=z: flash_decode_ref(
                    x, y, z, pos=pos_t, window=win) for x, y, z in copies]),
                library_ms=library_ms([
                    lambda x=x, y=y, z=z: F.scaled_dot_product_attention(
                        x[:, :, None], y, z, attn_mask=mask, enable_gqa=True)
                    for x, y, z in copies]),
                bound_ms=t_b, bound_by=by,
                shape=dict(b=1, hq=hq, hkv=hkv, s=s, pos=s - 1, d=d,
                           window=win))
        record("flash_decode", f"D=256 s={s} pos={s - 1} window={win}",
               dname, out, ref, timing)


def moe_slice_checks(record, randn, dtypes, quick: bool):
    """The shapes phase 15's models give the three serving kernels, each
    timed (float32, the path's dtype; bf16 checked) beside its plain
    version and one library call: flash_attention at deepseek-moe-16b's
    MHA (Hq = Hkv = 16, D 128, S 600, both regimes), at qwen3-moe's GQA
    ratio 16 (64 / 4, D 128) and non-causal at whisper-large-v3's (Hq = Hkv
    = 32, D 64: the encoder's 1500 x 1500 and the decoder's 64 queries
    against 1500 frames); flash_decode at ratio 1 (D 128, deepseek; D 64,
    whisper) and ratio 16 (D 128, qwen3-moe) over 1024 slots; the matmul at
    deepseek's dense layer (K 2048, N 10944) and shared experts (N 2816)
    at M = 1 and 600."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.decode import (
        flash_decode, flash_decode_ref,
    )
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention, regime as fa_regime,
    )
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.matmul.ops import mm, regime
    from repro_torch.kernels.matmul.ref import matmul_ref

    def attention(label, hq, hkv, sq, skv, d, causal, dname, dt, timed):
        q = randn((1, hq, sq, d), dt)
        k, v = randn((1, hkv, skv, d), dt), randn((1, hkv, skv, d), dt)
        out = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref = flash_attention_ref(q, k, v, causal=causal)
        timing = None
        if timed:
            nb = (2 * q.numel() + 2 * k.numel()) * q.element_size()
            pairs = sq * (sq + 1) // 2 if causal else sq * skv
            t_b, by = bound(nb, 4.0 * d * hq * pairs, TC_RATE[dname])
            copies = [(randn(q.shape, dt), randn(k.shape, dt),
                       randn(v.shape, dt)) for _ in range(copies_for(nb))]

            def sdpa(x, y, z):
                return F.scaled_dot_product_attention(
                    x, y, z, is_causal=causal, enable_gqa=hq != hkv)

            timing = dict(
                ms=time_ms([lambda x=x, y=y, z=z: flash_attention(
                    x, y, z, causal=causal) for x, y, z in copies]),
                plain_ms=time_ms([lambda x=x, y=y, z=z: flash_attention_ref(
                    x, y, z, causal=causal) for x, y, z in copies], iters=8),
                library_ms=library_ms([lambda x=x, y=y, z=z: sdpa(x, y, z)
                                       for x, y, z in copies]),
                bound_ms=t_b, bound_by=by,
                shape=dict(b=1, hq=hq, hkv=hkv, sq=sq, skv=skv, d=d,
                           causal=causal, regime=fa_regime(dt, d)))
        record("flash_attention", label, dname, out, ref, timing)

    def decode(label, hq, hkv, d, s, pos, dname, dt, timed):
        q = randn((1, hq, d), dt)
        k, v = randn((1, hkv, s, d), dt), randn((1, hkv, s, d), dt)
        pos_t = dev_pos(pos)
        out = flash_decode(q, k, v, pos=pos_t)
        torch.cuda.synchronize()
        ref = flash_decode_ref(q, k, v, pos=pos)
        timing = None
        if timed:
            seen = pos + 1
            nb = (2 * q.numel() + 2 * hkv * seen * d) * q.element_size()
            t_b, by = bound(nb, 4.0 * d * hq * seen, dname)
            mask = (torch.arange(s, device="cuda") <= pos)[None, None, None]
            copies = [(randn(q.shape, dt), randn(k.shape, dt),
                       randn(v.shape, dt)) for _ in range(copies_for(nb))]
            timing = dict(
                ms=time_ms([lambda x=x, y=y, z=z: flash_decode(
                    x, y, z, pos=pos_t) for x, y, z in copies]),
                plain_ms=time_ms([lambda x=x, y=y, z=z: flash_decode_ref(
                    x, y, z, pos=pos_t) for x, y, z in copies]),
                library_ms=library_ms([
                    lambda x=x, y=y, z=z: F.scaled_dot_product_attention(
                        x[:, :, None], y, z, attn_mask=mask,
                        enable_gqa=hq != hkv) for x, y, z in copies]),
                bound_ms=t_b, bound_by=by,
                shape=dict(b=1, hq=hq, hkv=hkv, s=s, pos=pos, d=d))
        record("flash_decode", label, dname, out, ref, timing)

    for dname, dt in dtypes:
        timed = not quick and dname == "float32"
        both = not quick                      # both regimes timed at MHA
        attention("MHA 16/16 D=128 sq=skv=600 causal", 16, 16, 600, 600,
                  128, True, dname, dt, both)
        if quick:
            continue
        attention("GQA 64/4 D=128 sq=skv=600 causal", 64, 4, 600, 600, 128,
                  True, dname, dt, timed)
        attention("MHA 32/32 D=64 sq=skv=1500 non-causal", 32, 32, 1500,
                  1500, 64, False, dname, dt, timed)
        attention("MHA 32/32 D=64 sq=64 skv=1500 non-causal", 32, 32, 64,
                  1500, 64, False, dname, dt, timed)
        decode("ratio 1 16/16 D=128 s=1024 pos=611", 16, 16, 128, 1024, 611,
               dname, dt, timed)
        decode("ratio 1 32/32 D=64 s=1024 pos=79", 32, 32, 64, 1024, 79,
               dname, dt, timed)
        decode("ratio 16 64/4 D=128 s=1024 pos=607", 64, 4, 128, 1024, 607,
               dname, dt, timed)
        for m in (1, 600):
            for n in (10944, 2816):
                k = 2048
                a = randn((m, k), dt)
                b = randn((k, n), dt, scale=k ** -0.5)
                out = mm(a, b)
                torch.cuda.synchronize()
                timing = None
                if timed:
                    nb = (m * k + k * n + m * n) * a.element_size()
                    t_b, by = bound(nb, 2.0 * m * k * n, dname)
                    copies = [(randn((m, k), dt), randn((k, n), dt))
                              for _ in range(copies_for(nb))]
                    timing = dict(
                        ms=time_ms([lambda x=x, y=y: mm(x, y)
                                    for x, y in copies]),
                        plain_ms=time_ms([lambda x=x, y=y: matmul_ref(x, y)
                                          for x, y in copies]),
                        library_ms=library_ms([
                            lambda x=x, y=y: torch.matmul(x, y)
                            for x, y in copies]),
                        bound_ms=t_b, bound_by=by,
                        shape=dict(m=m, k=k, n=n,
                                   regime=regime(m, n, k, dt)))
                record("matmul", f"moe m={m} k={k} n={n}", dname, out,
                       matmul_ref(a, b), timing)


def head_dim_80_checks(record, randn, dtypes, quick: bool):
    """flash_attention and flash_decode at h2o-danube-1.8b's full-width
    attention: Hq 32, Hkv 8, head_dim 80 (the wgmma regime zero-pads it to
    128; the bound counts the function's D = 80 work). Prefill causal at
    S = 512 and 4096; decode at S = 4096, pos 4095, at B = 1 (split KV) and
    B = 32 (B * Hkv fills the card: one split)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.decode import (
        decode_splits, flash_decode, flash_decode_ref,
    )
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention, regime as fa_regime,
    )
    from repro_torch.kernels.flash_attention.ops import DECODE_SPEC
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    hq, hkv, d = 32, 8, 80
    for dname, dt in dtypes:
        for s in ((512,) if quick else (512, 4096)):
            q = randn((1, hq, s, d), dt)
            k, v = randn((1, hkv, s, d), dt), randn((1, hkv, s, d), dt)
            out = flash_attention(q, k, v, causal=True)
            torch.cuda.synchronize()
            ref = flash_attention_ref(q, k, v, causal=True)
            timing = None
            if not quick:
                nb = (2 * q.numel() + 2 * k.numel()) * q.element_size()
                t_b, by = bound(nb, 4.0 * d * hq * s * (s + 1) // 2,
                                TC_RATE[dname])
                copies = [(randn(q.shape, dt), randn(k.shape, dt),
                           randn(v.shape, dt)) for _ in range(copies_for(nb))]
                timing = dict(
                    ms=time_ms([lambda x=x, y=y, z=z: flash_attention(
                        x, y, z, causal=True) for x, y, z in copies]),
                    plain_ms=time_ms([lambda x=x, y=y, z=z: flash_attention_ref(
                        x, y, z, causal=True) for x, y, z in copies], iters=4),
                    library_ms=library_ms([
                        lambda x=x, y=y, z=z: F.scaled_dot_product_attention(
                            x, y, z, is_causal=True, enable_gqa=True)
                        for x, y, z in copies]),
                    bound_ms=t_b, bound_by=by,
                    shape=dict(b=1, hq=hq, hkv=hkv, sq=s, skv=s, d=d,
                               regime=fa_regime(dt, d)))
            if not quick and s == 4096:
                # What the padding costs: the same heads at D = 128, which
                # the bf16 regime runs D = 80 as.
                wide = [tuple(randn(x.shape[:-1] + (128,), dt) for x in c)
                        for c in copies]
                timing["d128_ms"] = time_ms([lambda x=x, y=y, z=z: flash_attention(
                    x, y, z, causal=True) for x, y, z in wide])
                log(f"  flash_attention  D=128 hq=32 hkv=8 sq=skv={s} causal "
                    f"{dname:8s} | {timing['d128_ms']:.4f} ms")
            record("flash_attention", f"D=80 hq=32 hkv=8 sq=skv={s} causal",
                   dname, out, ref, timing)
        s, pos = 4096, 4095
        for b in ((1,) if quick else (1, 32)):
            q = randn((b, hq, d), dt)
            k, v = randn((b, hkv, s, d), dt), randn((b, hkv, s, d), dt)
            pos_t = dev_pos(pos)
            out = flash_decode(q, k, v, pos=pos_t)
            torch.cuda.synchronize()
            ref = flash_decode_ref(q, k, v, pos=pos)
            timing = None
            bkv = DECODE_SPEC.default_tile(
                dict(b=b, skv=s, d=d, hq=hq, hkv=hkv, window=0), dname)[0]
            splits = decode_splits(b, hkv, s, bkv, pos, True).splits
            if not quick:
                nb = (2 * q.numel() + 2 * k.numel()) * q.element_size()
                t_b, by = bound(nb, 4.0 * d * b * hq * s, dname)
                copies = [(randn(q.shape, dt), randn(k.shape, dt),
                           randn(v.shape, dt)) for _ in range(copies_for(nb))]
                timing = dict(
                    ms=time_ms([lambda x=x, y=y, z=z: flash_decode(
                        x, y, z, pos=pos_t) for x, y, z in copies]),
                    plain_ms=time_ms([lambda x=x, y=y, z=z: flash_decode_ref(
                        x, y, z, pos=pos_t) for x, y, z in copies], iters=4),
                    library_ms=library_ms([
                        lambda x=x, y=y, z=z: F.scaled_dot_product_attention(
                            x[:, :, None], y, z, enable_gqa=True)
                        for x, y, z in copies]),
                    bound_ms=t_b, bound_by=by,
                    shape=dict(b=b, hq=hq, hkv=hkv, s=s, pos=pos, d=d,
                               splits=splits))
            record("flash_decode", f"D=80 b={b} s={s} pos={pos} "
                   f"({'split' if splits > 1 else 'one split'})", dname, out,
                   ref, timing)


def bilinear_checks(record, randn, dtypes, quick: bool):
    """The paper's 800x800 image at scales 2-10 in both dtypes, each case
    with its store path (16-byte vectors, or scalar stores where a row's
    bytes are no multiple of 16), and images whose widths take the scalar
    path. The library yardstick is ``F.grid_sample`` on the same source positions
    (align_corners, border padding), timed in float32 with its error against
    the plain version."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.bilinear import ops as bil
    from repro_torch.kernels.bilinear.ref import (
        bilinear_upscale_ref, source_positions,
    )

    side = 800
    for dname, dt in dtypes:
        for scale in ((4, 10) if quick else (2, 4, 6, 8, 10)):
            src = randn((side, side), dt)
            out = bil.upscale(src, scale)
            torch.cuda.synchronize()
            ref = bilinear_upscale_ref(src, scale)
            prob = dict(src_h=side, src_w=side, scale=scale)
            timing = None
            if not quick:
                eb = src.element_size()
                nb = (side * side + (side * scale) ** 2) * eb
                t_b, by = bound(nb, 3.0 * (side * scale) ** 2, dname)
                copies = [randn(src.shape, dt) for _ in range(copies_for(nb))]
                lib = lib_err = None
                if dt == torch.float32:
                    # (In bf16 grid_sample takes a bf16 grid, whose 8 bits
                    # miss the positions: not the same function.)
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
                    ms=time_ms([lambda x=x: bil.upscale(x, scale) for x in copies]),
                    plain_ms=time_ms([lambda x=x: bilinear_upscale_ref(x, scale)
                                      for x in copies], iters=8),
                    library_ms=lib, library_max_abs_err=lib_err,
                    bound_ms=t_b, bound_by=by,
                    shape=dict(prob, rows=bil.ROWS,
                               store=bil.store_path(prob, dt)))
            log(f"  bilinear store path at scale {scale} {dname}: "
                f"{bil.store_path(prob, dt)}")
            record("bilinear", f"{side}x{side} scale={scale}", dname, out, ref,
                   timing)
        # Widths whose rows are no multiple of 16 bytes: the scalar stores.
        for (h, w), scale in (((37, 53), 3), ((41, 29), 10), ((33, 1001), 2)):
            src = randn((h, w), dt)
            prob = dict(src_h=h, src_w=w, scale=scale)
            out = bil.upscale(src, scale)
            torch.cuda.synchronize()
            record("bilinear", f"{h}x{w} scale={scale} "
                   f"({bil.store_path(prob, dt)} stores)", dname, out,
                   bilinear_upscale_ref(src, scale))


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
    4096-step sequence with the default chunk and every other chunk the
    spec sweeps (where the default comes from), and one decode step; no
    PyTorch call computes it. The bound counts the causal pairs of each
    chunk (``ops.flops``), the float32 one at the 3xTF32 rate its products
    run at, over the inputs and outputs alone (not the chunk states'
    workspace)."""
    import torch

    from repro_torch.core.hardware import H100_SXM
    from repro_torch.core.tiling import enumerate_tiles
    from repro_torch.kernels.ssd.ops import SPEC, flops, ssd_scan, ssd_scan_ref

    h, p, n = 80, 64, 128
    for dname, dt in dtypes:
        for s in ((512,) if quick else (4096, 1)):
            prob = dict(s=s, h=h, p=p, n=n)
            (default,) = SPEC.default_tile(prob, dname)
            chunks = [default]
            if s > 1 and not quick:
                swept = enumerate_tiles(
                    SPEC.constraints(prob), H100_SXM, dname,
                    lambda t: SPEC.vmem_bytes(t, prob, dname))
                chunks += sorted(t[0] for t in swept if t[0] != default)
            ops_in = _ssd_operands(1, s, h, p, n, dt, seed=s)
            eb = ops_in[1].element_size()
            # Every input once, y (like dtx) and h_last (like h0) out.
            nb = (sum(t.numel() for t in ops_in) + ops_in[1].numel()
                  + ops_in[4].numel()) * eb
            copies = ([] if quick else
                      [_ssd_operands(1, s, h, p, n, dt, seed=100 + i)
                       for i in range(copies_for(nb))])
            for q in chunks:
                y, hl = ssd_scan(*ops_in, chunk=q)
                torch.cuda.synchronize()
                yr, hr = ssd_scan_ref(*ops_in, chunk=q)
                timing = None
                if not quick:
                    t_b, by = bound(nb, flops(q, prob), TC_RATE[dname])
                    timing = dict(
                        ms=time_ms([lambda c=c: ssd_scan(*c, chunk=q)
                                    for c in copies]),
                        plain_ms=time_ms([lambda c=c: ssd_scan_ref(*c, chunk=q)
                                          for c in copies], iters=4),
                        library_ms=None, bound_ms=t_b, bound_by=by,
                        launch_ms=device_kernels(
                            lambda: ssd_scan(*copies[0], chunk=q)),
                        shape=dict(b=1, s=s, h=h, p=p, n=n, chunk=q))
                case = f"s={s} h={h} p={p} n={n}"
                if q != default:
                    case += f" chunk={q}"
                record("ssd", case + " y", dname, y, yr, timing)
                record("ssd", case + " h_last", dname, hl, hr)


def rglru_checks(record, dtypes, quick: bool):
    """The RG-LRU scan at recurrentgemma-9b's width (F 4096), a 4096-step
    sequence with the default tile and a few other (bt, bf) (where the
    default comes from), and one decode step; no PyTorch call computes
    it."""
    import torch

    from repro_torch.kernels.rglru.ops import SPEC, rglru_scan, rglru_scan_ref

    f = 4096
    sweep = ((32, 256), (32, 512), (64, 128), (64, 256), (64, 512),
             (128, 256), (128, 512))
    for dname, dt in dtypes:
        for s in ((256,) if quick else (4096, 1)):
            def operands(seed):
                g = torch.Generator(device="cuda").manual_seed(seed)
                return (torch.rand((1, s, f), generator=g, device="cuda").to(dt),
                        torch.randn((1, s, f), generator=g, device="cuda").to(dt),
                        torch.randn((1, f), generator=g, device="cuda").to(dt))

            default = tuple(SPEC.default_tile(dict(s=s, f=f), dname))
            tiles = [default]
            if s > 1 and not quick:
                tiles += [t for t in sweep if t != default]
            a, x, h0 = operands(s)
            eb = x.element_size()
            nb = (3 * s * f + 2 * f) * eb
            copies = [] if quick else [operands(100 + i)
                                       for i in range(copies_for(nb))]
            yr, hr = rglru_scan_ref(a, x, h0)
            plain = None
            for tile in tiles:
                y, hl = rglru_scan(a, x, h0, tile=tile)
                torch.cuda.synchronize()
                timing = None
                if not quick:
                    t_b, by = bound(nb, 2.0 * s * f, dname)
                    if plain is None:
                        plain = time_ms([lambda c=c: rglru_scan_ref(*c)
                                         for c in copies], iters=2)
                    timing = dict(
                        ms=time_ms([lambda c=c: rglru_scan(*c, tile=tile)
                                    for c in copies]),
                        plain_ms=plain, library_ms=None, bound_ms=t_b,
                        bound_by=by,
                        launch_ms=device_kernels(
                            lambda: rglru_scan(*copies[0], tile=tile)),
                        shape=dict(b=1, s=s, f=f, tile=list(tile)))
                case = f"s={s} f={f}"
                if tile != default:
                    case += f" tile {tile[0]}x{tile[1]}"
                record("rglru", case + " y", dname, y, yr, timing)
                record("rglru", case + " h_last", dname, hl, hr)


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
    by_rid = {r.rid: r.out_tokens for r in done}
    stats = dict(requests=len(done), prompt_lengths=list(lengths),
                 prompts=[p.tolist() for p in prompts],
                 request_tokens=[by_rid[rid] for rid in rids],
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


def full_width_parity(cfg, params, prompt_len: int = 384,
                      max_len: int = MAX_LEN):
    """One request's prefill logits and four decode steps through the
    kernels against the same request through the plain versions (TF32
    off), within LOGIT_REL_TOL of max |logit|."""
    import numpy as np
    import torch

    from repro_torch.models import api

    rng = np.random.default_rng(1)
    tokens = rng.integers(2, cfg.vocab_size, size=(1, prompt_len))
    v = cfg.vocab_size
    ring = bool(cfg.attn_window)
    report = []
    with torch.inference_mode():
        lk, sk = api.prefill(params, cfg, {"tokens": tokens}, max_len=max_len,
                             ring_local=ring)
        lr, sr = api.prefill(params, cfg, {"tokens": tokens}, max_len=max_len,
                             ring_local=ring, impl="reference")
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


def decode_rates(cfg, params, prompt_len: int = 600, steps: int = 12,
                 reps: int = 3, max_len: int = MAX_LEN):
    """Decode wall ms a step on the host clock (the median of ``reps`` runs
    of ``steps`` steps), eager beside graph, at one slot and at four: eager
    is a direct ``api.decode_step`` loop over each slot's own batch-1
    caches (the engine's layout) that reads each slot's token back every
    step, as a server must; graph is ``ServeEngine``, which replays each
    slot's captured step and reads the tokens back once a step. Both decode
    from the same ``prompt_len``-token prompts."""
    import numpy as np
    import torch

    from repro_torch.models import api
    from repro_torch.serve import ServeEngine

    v = cfg.vocab_size
    rng = np.random.default_rng(3)
    out = {}
    for slots in (1, 4):
        prompts = [rng.integers(2, v, size=prompt_len) for _ in range(slots)]
        with torch.inference_mode():
            states, toks = [], []
            for p in prompts:
                logits, st = api.prefill(params, cfg, {"tokens": p[None]},
                                         max_len=max_len,
                                         ring_local=bool(cfg.attn_window))
                states.append(st)
                toks.append(int(torch.argmax(logits[0, :v])))

            def eager_step():
                for i in range(slots):
                    tok = torch.tensor([[toks[i]]], device="cuda")
                    logits, _ = api.decode_step(params, cfg, tok, states[i])
                    toks[i] = int(torch.argmax(logits[0, :v]))

            eager_step()
            eager = statistics.median(
                per_step_ms(eager_step, steps) for _ in range(reps))
        eng = ServeEngine(cfg, params, max_len=max_len, slots=slots,
                          device="cuda")
        for p in prompts:
            eng.add_request(p, max_new_tokens=reps * steps + 8)
        eng.step()                 # prefill, warm-up, capture, first replay
        eng.step()
        graph = statistics.median(
            per_step_ms(eng.step, steps) for _ in range(reps))
        check(eng.in_flight() == slots, "a request left the engine early")
        eng.run_until_done()
        out[f"slots_{slots}"] = dict(eager_ms=eager, graph_ms=graph,
                                     eager_tok_s=slots * 1e3 / eager,
                                     graph_tok_s=slots * 1e3 / graph)
        log(f"  decode at {slots} slot(s), {prompt_len}-token prompts: eager "
            f"{eager:.3f} ms a step ({slots * 1e3 / eager:.1f} tok/s), graph "
            f"{graph:.3f} ms a step ({slots * 1e3 / graph:.1f} tok/s), "
            f"{eager / graph:.2f}x")
    return out


def per_step_ms(step, steps: int) -> float:
    """Host-clock ms a call of ``step`` over ``steps`` calls, from a
    synchronised start to a synchronised end."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


# Phase 4b: the bucket edges of the plan-serve phase, which cover phase 4's
# prompts of 16-600 tokens: 16 and 384 are edges, the other four lie
# between them.
PLAN_SERVE_EDGES = (16, 128, 384, 512, 640)


def hold_tokens(params, cfg, prompt, got, want, label: str) -> int:
    """Two engines' tokens for one request: equal, or the first difference
    lies where the plain versions' top-2 logit margin after the common
    prefix is within LOGIT_REL_TOL of max |logit| (float32 sums in another
    order may pick either); past it the streams may rightly part. Returns 1
    if the tokens differ, else 0."""
    import numpy as np
    import torch

    from repro_torch.models import api

    check(len(got) == len(want), f"{label}: {len(got)} != {len(want)} tokens")
    for i, (a, b) in enumerate(zip(got, want)):
        if a == b:
            continue
        ctx = np.concatenate([np.asarray(prompt), np.asarray(want[:i])])[None]
        with torch.inference_mode():
            logits, _ = api.prefill(params, cfg, {"tokens": ctx},
                                    max_len=ctx.shape[1], impl="reference")
        v = logits[0, :cfg.vocab_size].float()
        top = torch.topk(v, 2).values
        margin, tol = float(top[0] - top[1]), LOGIT_REL_TOL * float(
            v.abs().max())
        log(f"    {label}: token {i} {a} != {b}, plain top-2 margin "
            f"{margin:.3e} (tol {tol:.3e})")
        check(margin <= tol, f"{label}: token {i} differs ({a} != {b}) with "
              f"margin {margin:.3e} > {tol:.3e}")
        return 1
    return 0


def _prefill_profile(eng, params, n: int, gen, reps: int = 3):
    """The engine's own prefill (its tiles for the length) of one
    ``n``-token request on a slot's caches: host-clock ms (the median of
    ``reps`` after a warm-up), and device-busy ms by kernel group
    (``torch.profiler``, the mean of 2 calls)."""
    import torch

    with torch.inference_mode():
        fn = eng._prefill_fn(n)
        batch = {"tokens": torch.randint(2, eng.cfg.vocab_size, (1, n),
                                         generator=gen, device="cuda")}

        def call():
            fn(params, batch, eng._slots[0].caches)

        call()
        host = statistics.median(per_step_ms(call, 1) for _ in range(reps))
        groups = {}
        for name, ms in device_kernels(call, calls=2).items():
            g = _kernel_group(name)
            groups[g] = groups.get(g, 0.0) + ms
    return host, groups


def _prefill_ms(eng, params, lengths, reps: int = 3):
    """Per length, :func:`_prefill_profile`'s host-clock ms, and its
    device-busy ms in all and in the matmul kernel."""
    import torch

    host, busy, matmul = [], [], []
    gen = torch.Generator(device="cuda").manual_seed(5)
    for n in lengths:
        h, groups = _prefill_profile(eng, params, n, gen, reps)
        host.append(h)
        busy.append(sum(groups.values()))
        matmul.append(groups.get("matmul", 0.0))
    return dict(host=host, busy=busy, matmul=matmul)


def _decode_ms(eng, prompts, steps: int = 12, reps: int = 3):
    """The engine's captured decode over ``len(prompts)`` slots: host-clock
    ms a step (the median of ``reps`` runs of ``steps``), and device ms a
    step (CUDA events around ``steps`` rounds of the slots' graph
    replays)."""
    import torch

    for p in prompts:
        eng.add_request(p, max_new_tokens=(reps + 1) * steps + 8)
    eng.step()                 # prefill, warm-up, capture, first replay
    eng.step()
    host = statistics.median(per_step_ms(eng.step, steps) for _ in range(reps))
    check(eng.in_flight() == len(prompts), "a request left the engine early")
    graphs = [s.graph for s in eng._slots if s.graph is not None]
    check(len(graphs) == len(prompts), f"{len(graphs)} captured slots")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(steps):
        for g in graphs:
            g.replay()
    end.record()
    torch.cuda.synchronize()
    device = start.elapsed_time(end) / steps
    eng.run_until_done()
    return dict(host=host, device=device)


def plan_serve(cfg, params, baseline):
    """Phase 4b: phase 4's serve with tile plans. Compile a wall-clock
    h100_sxm plan of qwen2-1.5b's float32 serving cells (prefill at the
    PLAN_SERVE_EDGES, decode at 4 slots and MAX_LEN), serve phase 4's six
    requests through ``ServeEngine(plans=...)`` with the plan's bucket
    edges (every prefill an exact hit) and with FIFO (the lengths between
    edges resolve by nearest shape), hold their tokens against the no-plan
    serves, and time prefill and captured decode beside the no-plan
    engine's, in turns (no plan, plan, plan, no plan)."""
    import numpy as np
    import torch

    from repro_torch.core import H100_SXM, registry
    from repro_torch.kernels import build, register_all
    from repro_torch.launch.compile_plans import serve_bucket_cells
    from repro_torch.serve import (BucketPolicy, ServeEngine,
                                   ShapeBucketScheduler)

    register_all()
    jobs = [(k, p, "float32", H100_SXM) for k, p in serve_bucket_cells(
        ["qwen2-1.5b"], PLAN_SERVE_EDGES, slots=4, max_len=MAX_LEN)
        if k in registry.names()]
    plan, timed, compile_s = compile_timed(jobs)
    log(f"  {len(jobs)} serving cells compiled and timed in {compile_s:.1f} s"
        " (model best vs measured best, with the Hopper estimator):")
    cells = measured_cells(jobs, timed)
    policy = BucketPolicy.from_plan(plan, hardware="h100_sxm")
    check(policy.edges == PLAN_SERVE_EDGES, f"plan edges {policy.edges}")

    def engine(plans, bucket: bool, slots: int = 4):
        return ServeEngine(cfg, params, max_len=MAX_LEN, slots=slots,
                           dtype=torch.float32, plans=plans, hardware=H100_SXM,
                           scheduler=(ShapeBucketScheduler(policy) if bucket
                                      else None), device="cuda")

    prompts = [np.asarray(p) for p in baseline["prompts"]]
    new_tokens = baseline["new_tokens"]

    def serve(eng):
        rids = [eng.add_request(p, max_new_tokens=new_tokens)
                for p in prompts]
        check(all(r is not None for r in rids), f"requests rejected: {rids}")
        done = {r.rid: r.out_tokens for r in eng.run_until_done()}
        return [done[r] for r in rids]

    out = dict(edges=list(PLAN_SERVE_EDGES), compile_s=compile_s,
               cells=cells)
    build.reset_launches()
    engines, tokens = {}, {}
    for name, bucket in (("bucket", True), ("fifo", False)):
        engines[name] = engine(plan, bucket)
        tokens[name] = serve(engines[name])
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    for name in SERVE_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was never launched by the plan serve")
    log(f"  launches on the plan serve: {launches}")
    out["launches"] = launches
    buckets = [policy.bucket_for(len(p)) for p in prompts]
    no_plan_bucket = serve(engine(None, True))
    differ = {}
    for name, want, ctxs in (
            ("fifo", baseline["request_tokens"], prompts),
            ("bucket", no_plan_bucket,
             [ShapeBucketScheduler(policy).prepare(
                 types.SimpleNamespace(prompt=p, bucket=b))
              for p, b in zip(prompts, buckets)])):
        differ[name] = sum(
            hold_tokens(params, cfg, ctx, got, ref, f"{name} request {i}")
            for i, (ctx, got, ref) in enumerate(zip(ctxs, tokens[name],
                                                    want)))
    for name, eng in engines.items():
        m = eng.metrics
        counts = m.as_dict()["plan"]["counts"]
        rec = dict(plan_hit_rate_prefill=m.plan_hit_rate("prefill"),
                   plan_hit_rate_decode=m.plan_hit_rate("decode"),
                   tile_fallback=counts["tile_fallback"], counts=counts,
                   requests_differing=differ[name],
                   prefill={n: dict(tiles={k: list(t) for k, t in
                                           eng._prefill_tiles[n][0].items()},
                                    sources=eng._prefill_sources[n])
                            for n in sorted(eng._prefill_tiles)},
                   decode=dict(tiles={k: list(t) for k, t in
                                      eng.tiles.items()},
                               sources=eng.tile_sources))
        log(f"  {name}: plan_hit_rate prefill "
            f"{rec['plan_hit_rate_prefill']:.3f}, decode "
            f"{rec['plan_hit_rate_decode']:.3f}; tile_fallback "
            f"{rec['tile_fallback']}; counts {counts}; requests whose tokens "
            f"differ from the no-plan serve's: {differ[name]} (margin rule)")
        for n, cell in rec["prefill"].items():
            log(f"    prefill {n:4d}: " + ", ".join(
                f"{k} {'x'.join(map(str, t))} ({cell['sources'][k]})"
                for k, t in cell["tiles"].items()))
        log("    decode (4 slots, 1024): " + ", ".join(
            f"{k} {'x'.join(map(str, t))} ({eng.tile_sources[k]})"
            for k, t in rec["decode"]["tiles"].items()))
        out[name] = rec
    check(out["bucket"]["plan_hit_rate_prefill"] == 1.0,
          "a bucketed prefill missed its exact cell")
    check(out["bucket"]["plan_hit_rate_decode"] == 1.0
          and out["fifo"]["plan_hit_rate_decode"] == 1.0,
          "the decode cell did not resolve exactly")
    fifo_sources = {n: set(c["sources"].values())
                    for n, c in out["fifo"]["prefill"].items()}
    check(all(fifo_sources[n] == ({"exact"} if n in PLAN_SERVE_EDGES
                                  else {"nearest_shape"})
              for n in fifo_sources), f"FIFO sources {fifo_sources}")

    # Times, in turns: no plan, plan, plan, no plan.
    def turns(measure, plan_eng, bare_eng):
        got = {"no_plan": [], "plan": []}
        for name, eng in (("no_plan", bare_eng), ("plan", plan_eng),
                          ("plan", plan_eng), ("no_plan", bare_eng)):
            got[name].append(measure(eng))
        return {name: {k: (statistics.fmean(r[k] for r in runs)
                           if not isinstance(runs[0][k], list) else
                           [statistics.fmean(x) for x in
                            zip(*(r[k] for r in runs))])
                       for k in runs[0]} for name, runs in got.items()}

    lengths = [len(p) for p in prompts]
    bare = engine(None, False)
    pf = turns(lambda e: _prefill_ms(e, params, lengths), engines["fifo"],
               bare)
    pb = turns(lambda e: _prefill_ms(e, params, buckets), engines["bucket"],
               bare)
    rng = np.random.default_rng(3)
    dprompts = [rng.integers(2, cfg.vocab_size, size=600) for _ in range(4)]
    dec = {"no_plan": [], "plan": []}
    for name, plans in (("no_plan", None), ("plan", plan), ("plan", plan),
                        ("no_plan", None)):
        dec[name].append(_decode_ms(engine(plans, False), dprompts))
    dec = {name: {k: statistics.fmean(r[k] for r in runs) for k in runs[0]}
           for name, runs in dec.items()}
    out["prefill_ms"] = dict(lengths=lengths, **pf)
    out["prefill_ms_bucket"] = dict(lengths=buckets, **pb)
    out["decode_ms_4_slots"] = dec

    def fmt(xs):
        return "[" + ", ".join(f"{x:.3f}" for x in xs) + "]"

    for label, at, t in (("FIFO", lengths, pf), ("bucket, padded", buckets,
                                                  pb)):
        log(f"  prefill ms per request at {at} tokens ({label}):")
        for k in ("host", "busy", "matmul"):
            what = {"host": "host clock", "busy": "device busy",
                    "matmul": "matmul kernel"}[k]
            log(f"    {what:13s} no plan {fmt(t['no_plan'][k])} (sum "
                f"{sum(t['no_plan'][k]):.3f}), plan {fmt(t['plan'][k])} "
                f"(sum {sum(t['plan'][k]):.3f})")
    log(f"  decode ms a step (captured graphs, 4 slots, 600-token prompts): "
        f"host clock no plan {dec['no_plan']['host']:.3f}, plan "
        f"{dec['plan']['host']:.3f}; device no plan "
        f"{dec['no_plan']['device']:.3f}, plan {dec['plan']['device']:.3f}")
    return out


def graph_logits(eng, prompt, new_tokens: int):
    """Serve one request alone through ``eng`` (one slot), step by step,
    and keep each decode step's logits as its captured graph wrote them.
    Returns (tokens, [logits of decode steps 1..new_tokens-1])."""
    rid = eng.add_request(prompt, max_new_tokens=new_tokens)
    check(rid is not None, f"request rejected: {eng.last_reject_reason}")
    steps, done = [], []
    while eng.in_flight() or eng.scheduler.pending():
        done += eng.run_until_done(max_steps=1)
        # The slot's static logits buffer: the graph's output of the step.
        steps.append(eng._slots[0].logits[0].clone())
    (req,) = done
    return req.out_tokens, steps


def hold_against_plain(params, cfg, prompt, tokens, graph_steps, max_len,
                       ring_local: bool, label: str):
    """The plain versions (``impl="reference"``) teacher-forced with the
    engine's tokens: at every step the engine's token is the plain argmax
    unless the plain top-2 margin is within the tolerance, and, where the
    engine's logits are given, they lie within LOGIT_REL_TOL of max |plain
    logit|. Returns the worst relative difference and the smallest margin."""
    import torch

    from repro_torch.models import api

    v = cfg.vocab_size
    worst, min_margin = 0.0, float("inf")
    with torch.inference_mode():
        lr, st = api.prefill(params, cfg, {"tokens": prompt[None]},
                             max_len=max_len, ring_local=ring_local,
                             impl="reference")
        for i, tok in enumerate(tokens):
            b = lr[0, :v].float()
            check(bool(torch.isfinite(b).all()), f"{label} step {i}: "
                  "non-finite plain logits")
            scale = float(b.abs().max())
            tol = LOGIT_REL_TOL * scale
            top2 = torch.topk(b, 2)
            margin = float(top2.values[0] - top2.values[1])
            min_margin = min(min_margin, margin)
            check(int(top2.indices[0]) == tok or margin <= tol,
                  f"{label} step {i}: token {tok} != plain "
                  f"{int(top2.indices[0])} with margin {margin:.3e} > "
                  f"{tol:.3e}")
            if 0 < i <= len(graph_steps):
                a = graph_steps[i - 1][:v].float()
                check(bool(torch.isfinite(a).all()),
                      f"{label} step {i}: non-finite graph logits")
                err = float((a - b).abs().max())
                worst = max(worst, err / scale)
                check(err <= tol, f"{label} step {i}: graph logits differ "
                      f"from the plain ones by {err:.3e} > {tol:.3e}")
            if i + 1 < len(tokens):
                t = torch.tensor([[tok]], device="cuda")
                lr, st = api.decode_step(params, cfg, t, st, impl="reference")
    return worst, min_margin


def graph_parity(cfg, params, new_tokens: int = 17, label: str = "qwen2",
                 max_len: int = MAX_LEN):
    """16 decode steps of one full-width request through the captured
    engine: its tokens equal an eager kernel loop's, and its logits lie
    within LOGIT_REL_TOL of the plain versions' (TF32 off)."""
    import numpy as np
    import torch

    from repro_torch.models import api
    from repro_torch.serve import ServeEngine

    prompt = np.random.default_rng(1).integers(2, cfg.vocab_size, size=384)
    eng = ServeEngine(cfg, params, max_len=max_len, slots=1, device="cuda")
    tokens, steps = graph_logits(eng, prompt, new_tokens)
    del eng
    v = cfg.vocab_size
    with torch.inference_mode():
        logits, st = api.prefill(params, cfg, {"tokens": prompt[None]},
                                 max_len=max_len)
        eager = [int(torch.argmax(logits[0, :v]))]
        while len(eager) < new_tokens:
            t = torch.tensor([[eager[-1]]], device="cuda")
            logits, st = api.decode_step(params, cfg, t, st)
            eager.append(int(torch.argmax(logits[0, :v])))
    check(tokens == eager, f"graph tokens {tokens} != eager tokens {eager}")
    worst, margin = hold_against_plain(params, cfg, prompt, tokens, steps,
                                       max_len, False, f"{label} graph")
    log(f"  {len(steps)} captured decode steps: tokens equal the eager "
        f"loop's; logits within {worst:.3e} x max |logit| of the plain "
        f"versions' (tol {LOGIT_REL_TOL:g}); smallest top-2 margin "
        f"{margin:.3e}")
    return dict(decode_steps=len(steps), tokens_equal_eager=True,
                max_rel_err=worst, min_top2_margin=margin)


def serve_h2o_danube():
    """Full-width h2o-danube-1.8b (24 layers, Hq 32, Hkv 8, D 80, window
    4096; float32, random weights from seed 0) through the captured engine:
    4 requests at max_len 4608, so every layer keeps a 4096-slot ring; the
    4090-token prompt wraps its rings while it decodes, the 4200-token one
    overflows them at prefill, 64 and 500 do not wrap. 16 new tokens each,
    held against the same requests through the plain versions."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.models import api
    from repro_torch.serve import ServeEngine

    cfg = configs.get_arch("h2o-danube-1.8b")
    max_len, new_tokens, lengths = 4608, 16, (4090, 4200, 64, 500)
    t0 = time.perf_counter()
    params = api.init_params(cfg, 0, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    log(f"  initialised {sum(p.numel() for p in _leaves(params)) / 1e9:.3f} "
        f"B parameters in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, cfg.vocab_size, size=n) for n in lengths]
    eng = ServeEngine(cfg, params, max_len=max_len, slots=4,
                      dtype=torch.float32, device="cuda")
    build.reset_launches()
    t0 = time.perf_counter()
    rids = [eng.add_request(p, max_new_tokens=new_tokens) for p in prompts]
    # One engine step at a time: the first admits all four (their prefills)
    # and decodes once; each later one is a decode step of the four slots.
    done, step_ms = {}, []
    while eng.in_flight() or eng.scheduler.pending():
        t = time.perf_counter()
        done.update((r.rid, r) for r in eng.run_until_done(max_steps=1))
        step_ms.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    decode_ms = statistics.median(step_ms[1:])
    check(all(r is not None for r in rids), f"requests rejected: {rids}")
    check(sorted(done) == sorted(rids), "not every request finished")
    for name in SERVE_KERNELS:
        check(launches[name] > 0, f"h2o-danube never launched {name}")
    ring = cfg.attn_window
    tops = sorted(int(slot.caches[0]["slot_pos"].max()) for slot in eng._slots)
    check(all(c["k"].shape[2] == ring for c in eng._slots[0].caches),
          "h2o-danube's caches are not 4096-slot rings")
    check(sum(t >= ring for t in tops) >= 2,
          f"the rings did not wrap (highest positions held: {tops})")
    report = []
    for rid, n, p in zip(rids, lengths, prompts):
        toks = done[rid].out_tokens
        check(len(toks) == new_tokens, f"request {rid} got {len(toks)} tokens")
        _, margin = hold_against_plain(params, cfg, p, toks, [], max_len,
                                       True, f"h2o-danube prompt {n}")
        report.append(dict(prompt=n, tokens=toks, min_top2_margin=margin,
                           wraps=n + new_tokens - 1 > ring))
    log(f"  4 requests ({', '.join(map(str, lengths))}-token prompts), "
        f"{4 * new_tokens} tokens in {dt:.3f} s (first step, the prefills: "
        f"{step_ms[0]:.1f} ms; then {decode_ms:.3f} ms a decode step of 4 "
        f"slots, median); rings of {ring} slots, highest positions held "
        f"{tops}; every token the plain versions' or within a top-2 margin "
        f"of {LOGIT_REL_TOL:g} x max |logit|")
    log(f"  launches: {launches}")
    del eng
    log("  == 12c: ring continuation across the wrap (chunks vs whole)")
    cont = ring_continuation(cfg, params, max_len)
    return dict(requests=report, seconds=dt, launches=launches,
                first_step_ms=step_ms[0], decode_step_ms=decode_ms,
                chunked=cont,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)


def ring_continuation(cfg, params, max_len: int, n: int = 4200,
                      chunk: int = 512, steps: int = 8):
    """Phase 12c: ``n`` tokens in ``chunk``-token chunks across the 4096-slot
    rings' wrap against the whole prefill, then ``steps`` captured decode
    steps from each state: the same tokens."""
    t0 = time.perf_counter()
    cs, ws, rep = chunked_vs_whole(cfg, params, n, chunk, max_len,
                                   "h2o-danube", seed=13, plain=True)
    (tc, lc), (tw, lw) = decode_from_states(
        cfg, params, [(cs, rep["first_token"]),
                      (ws, rep["whole_first_token"])], n, steps, max_len)
    check(tc == tw, f"decode from the chunked state {tc} != from the whole "
          f"prefill's {tw}")
    err = max(_rel_err(a, b) for a, b in zip(lc, lw))
    check(err <= LOGIT_REL_TOL, f"decode logits from the two states differ "
          f"by {err:.3e} x max |logit|")
    log(f"  {steps} captured decode steps from each state: the same tokens "
        f"{tc}, logits within {err:.3e} x max |logit| "
        f"({time.perf_counter() - t0:.1f} s)")
    rep.update(decode_tokens=tc, decode_logit_rel_err=err,
               seconds=time.perf_counter() - t0)
    return rep


def gemma2_reduced_depth():
    """gemma2-9b at full width (d_model 3584, Hq 16, Hkv 8, D 256, d_ff
    14336, softcaps 50 / 30, window 4096) and 4 of its 42 layers (2
    local/global units; float32, random weights from seed 0): one request
    of 4092 prompt tokens at max_len 4352, so the local layers keep a
    4096-slot ring that wraps during 8 captured decode steps, held against
    the plain versions."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models import api
    from repro_torch.serve import ServeEngine

    full = configs.get_arch("gemma2-9b")
    cfg = dataclasses.replace(full, n_layers=4,
                              layer_pattern=full.layer_pattern[:4]).validate()
    params = api.init_params(cfg, 0, dtype=torch.float32, device="cuda")
    prompt = np.random.default_rng(6).integers(2, cfg.vocab_size, size=4092)
    max_len = 4352
    eng = ServeEngine(cfg, params, max_len=max_len, slots=1, device="cuda")
    t0 = time.perf_counter()
    tokens, steps = graph_logits(eng, prompt, 9)
    dt = time.perf_counter() - t0
    rings = [c["k"].shape[2] for c in eng._slots[0].caches]
    check(rings == [4096, max_len] * 2, f"gemma2 cache lengths {rings}")
    worst, margin = hold_against_plain(params, cfg, prompt, tokens, steps,
                                       max_len, True, "gemma2")
    cut = f"depth cut to {cfg.n_layers} of {full.n_layers} layers"
    log(f"  gemma2-9b ({cut}): prefill and {len(steps)} captured decode "
        f"steps in {dt:.3f} s; caches {rings}; logits within {worst:.3e} x "
        f"max |logit| of the plain versions' (tol {LOGIT_REL_TOL:g}); "
        f"smallest top-2 margin {margin:.3e}")
    return dict(reduced=cut, decode_steps=len(steps), tokens=tokens,
                max_rel_err=worst, min_top2_margin=margin, seconds=dt)


# ---------------------------------------------------------------------------
# Phases 10 and 11: the recurrent models at full width
# ---------------------------------------------------------------------------

def serve_counted(cfg, params, max_len: int, lengths, seed: int,
                    prefill_kernels, decode_kernels, label: str):
    """Serve one request per prompt length (16 new tokens each) through the
    captured engine at 4 slots and hold every request token by token
    against the plain versions. The launches are counted over the serve
    (reset right before it, read right after) and split into the
    admissions (prefills) and the decode steps; taking each captured slot's
    eager warm-up step out of the latter leaves the replays', which must be
    the number of decode steps times the launches of one step. Fails unless
    each of ``prefill_kernels`` launched in the prefills and each of
    ``decode_kernels`` in the replays."""
    import numpy as np
    import torch

    from repro_torch.kernels import build
    from repro_torch.serve import ServeEngine

    new_tokens, slots = 16, 4
    ring = bool(cfg.attn_window)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(2, cfg.vocab_size, size=n) for n in lengths]
    eng = ServeEngine(cfg, params, max_len=max_len, slots=slots,
                      dtype=torch.float32, device="cuda")
    by_phase = {"prefill": {}, "decode": {}}

    def counted(phase, fn):
        def run(*args, **kwargs):
            before = dict(build.LAUNCHES)
            out = fn(*args, **kwargs)
            for k, n in build.LAUNCHES.items():
                by_phase[phase][k] = by_phase[phase].get(k, 0) + n - before[k]
            return out
        return run

    eng._admit = counted("prefill", eng._admit)
    eng._decode_all = counted("decode", eng._decode_all)
    build.reset_launches()
    t0 = time.perf_counter()
    rids = [eng.add_request(p, max_new_tokens=new_tokens) for p in prompts]
    # One engine step at a time: the first admits four requests (their
    # prefills) and decodes once; a later one admits into a freed slot.
    done, step_ms = {}, []
    while eng.in_flight() or eng.scheduler.pending():
        t = time.perf_counter()
        done.update((r.rid, r) for r in eng.run_until_done(max_steps=1))
        step_ms.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    check(all(r is not None for r in rids), f"requests rejected: {rids}")
    check(sorted(done) == sorted(rids), "not every request finished")
    captured = [slot for slot in eng._slots if slot.graph is not None]
    check(len(captured) == min(slots, len(prompts)),
          f"{len(captured)} slots captured their decode step")
    step = captured[0].launches
    decode_calls = sum(len(done[r].out_tokens) - 1 for r in rids)
    replayed = {k: by_phase["decode"].get(k, 0)
                - sum(slot.launches.get(k, 0) for slot in captured)
                for k in launches}
    for name in prefill_kernels:
        check(by_phase["prefill"].get(name, 0) > 0,
              f"{label}: {name} was never launched by a prefill")
    for name in decode_kernels:
        check(step.get(name, 0) > 0 and
              replayed[name] == decode_calls * step[name],
              f"{label}: {name} launched {replayed[name]} times in "
              f"{decode_calls} replayed decode steps of {step.get(name, 0)}")
    report = []
    for rid, n, p in zip(rids, lengths, prompts):
        toks = done[rid].out_tokens
        check(len(toks) == new_tokens, f"request {rid} got {len(toks)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in toks),
              f"request {rid} has tokens outside the vocabulary")
        _, margin = hold_against_plain(params, cfg, p, toks, [], max_len,
                                       ring, f"{label} prompt {n}")
        report.append(dict(prompt=n, tokens=toks, min_top2_margin=margin))
    decode_ms = statistics.median(step_ms[1:])
    log(f"  {len(rids)} requests ({', '.join(map(str, lengths))}-token "
        f"prompts), {len(rids) * new_tokens} tokens in {dt:.3f} s (first "
        f"step, four prefills: {step_ms[0]:.1f} ms; then {decode_ms:.3f} ms "
        f"a step, median); every token the plain versions' or within a "
        f"top-2 margin of {LOGIT_REL_TOL:g} x max |logit|")
    log(f"  launches: {launches}; prefills {by_phase['prefill']}; "
        f"{decode_calls} replayed decode steps {replayed} "
        f"({step} a step)")
    out = dict(requests=report, seconds=dt, launches=launches,
               prefill_launches=by_phase["prefill"],
               replayed_launches=replayed, launches_per_step=step,
               decode_calls=decode_calls, first_step_ms=step_ms[0],
               decode_step_ms=decode_ms, engine=eng,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if ring:
        tops = sorted(int(next(c for c in slot.caches if "slot_pos" in c)
                          ["slot_pos"].max()) for slot in eng._slots)
        window = cfg.attn_window
        check(all(c["k"].shape[2] == window for slot in eng._slots
                  for c in slot.caches if "slot_pos" in c),
              f"{label}'s local caches are not {window}-slot rings")
        check(sum(t >= window for t in tops) >= 2,
              f"the rings did not wrap (highest positions held: {tops})")
        log(f"  rings of {window} slots, highest positions held {tops}")
        out["ring_tops"] = tops
    return out


def recurrent_phase(arch: str, max_len: int, lengths, seed: int,
                    prefill_kernels, decode_kernels, profile: bool,
                    chunking=None):
    """Phases 10 and 11: ``arch`` at full width (float32, random weights
    from seed 0) served through the captured engine
    (:func:`serve_counted`), one request's logits held against the plain
    versions, prefill device ms at 600 tokens and at the longest prompt,
    decode ms a step at 1 and 4 slots, with ``chunking = (n, chunk)`` an
    ``n``-token prompt prefilled in chunks against the whole prefill
    (phase 12d), and with ``profile`` where one 600-token request's time
    goes."""
    import torch

    from repro_torch import configs

    cfg = configs.get_arch(arch)
    label = arch.split("-")[0]
    params, n_params = _init_full(cfg)
    out = serve_counted(cfg, params, max_len, lengths, seed,
                        prefill_kernels, decode_kernels, label)
    eng = out.pop("engine")
    out.update(layers=cfg.n_layers, params_b=n_params / 1e9)
    out["parity"] = full_width_parity(cfg, params, max_len=max_len)
    if chunking is not None:
        log(f"  == 12d: {label} prefill in chunks vs whole")
        out["chunked"] = chunked_vs_whole(cfg, params, *chunking, max_len,
                                          label, seed=14)[2]
    gen = torch.Generator(device="cuda").manual_seed(5)
    out["prefill"] = {}
    for n in (600, max(lengths)):
        host, groups = _prefill_profile(eng, params, n, gen)
        busy = sum(groups.values())
        out["prefill"][str(n)] = dict(host_ms=host, device_busy_ms=busy,
                                      by_group_ms=groups)
        by_group = ", ".join(f"{g} {t:.3f}" for g, t in sorted(
            groups.items(), key=lambda kv: -kv[1]))
        log(f"  prefill of {n} tokens: host {host:.3f} ms, device busy "
            f"{busy:.3f} ms ({by_group})")
    del eng
    log(f"  decode wall time a step ({label}): eager loop vs captured graph")
    out["decode_rates"] = decode_rates(cfg, params, max_len=max_len)
    if profile:
        log(f"  where the time of one full-width {label} request goes")
        out["profile"] = profile_request(cfg, params, max_len=max_len)
    del params
    torch.cuda.empty_cache()
    return out


def _kernel_group(name: str) -> str:
    for key, group in (("matmul_", "matmul"),
                       ("flash_attention_kernel", "flash_attention"),
                       ("flash_decode", "flash_decode"),
                       ("ssd_", "ssd"), ("rglru_", "rglru")):
        if key in name:
            return group
    if any(key in name.lower() for key in ("gemm", "gemv", "cutlass")):
        return "torch.matmul (projections, head)"
    return "other torch ops"


def profile_request(cfg, params, prompt_len: int = 600, steps: int = 8,
                    max_len: int = MAX_LEN):
    """Where the time of one full-width request goes: the prefill of a
    ``prompt_len`` prompt and ``steps`` decode steps at batch 1, eager
    (``api.decode_step``) and captured (``ServeEngine``'s replayed graph).
    Per phase: the wall time on the host clock (median of 3), then the
    device time by kernel group from ``torch.profiler`` and so the device's
    idle share."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import api
    from repro_torch.serve import ServeEngine

    prompt = np.random.default_rng(2).integers(2, cfg.vocab_size,
                                               size=prompt_len)
    tokens = torch.as_tensor(prompt[None], device="cuda")
    state = {}
    eng = ServeEngine(cfg, params, max_len=max_len, slots=1, device="cuda")
    eng.add_request(prompt, max_new_tokens=6 * steps + 2)
    eng.step()                       # prefill, warm-up, capture, first replay

    def decode_graph():
        for _ in range(steps):
            eng.step()

    def prefill():
        state["logits"], state["cache"] = api.prefill(
            params, cfg, {"tokens": tokens}, max_len=max_len,
            ring_local=bool(cfg.attn_window))

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
        prefill(), decode(), decode_graph()       # warm-up
        for phase, fn, per in (("prefill", prefill, 1),
                               ("decode", decode, steps),
                               ("decode_graph", decode_graph, steps)):
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
            if cfg.moe is not None:
                # The routed experts' torch.bmm: each kernel an aten::bmm
                # launched moves from its name's group to its own (an
                # eager call's; a graph replay's kernels carry no op). The
                # projections' einsums also reach aten::bmm: not those.
                moved = 0
                for ev in prof.events():
                    parent = getattr(ev, "cpu_parent", None)
                    if ev.name != "aten::bmm" or (
                            parent is not None
                            and parent.name == "aten::einsum"):
                        continue
                    for kern in ev.kernels:
                        g = _kernel_group(kern.name)
                        groups[g] = groups.get(g, 0.0) - kern.duration
                        groups["experts (torch.bmm)"] = groups.get(
                            "experts (torch.bmm)", 0.0) + kern.duration
                        moved += 1
                if not moved:
                    log("    experts' torch.bmm: not separated (kernels "
                        "of a graph replay carry no op)")
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


# ---------------------------------------------------------------------------
# Phase 12: chunked and packed serving at full width
# ---------------------------------------------------------------------------

# Phase 12a: phase 4's prompts and a 1000-token one; 600 and 1000 are
# admitted at 1024 (twice the top edge) by chunking. A step takes at most
# 260 tokens, so a chunk at most 256 beside the 4-slot decode batch.
CHUNK_EDGES = (64, 128, 512)
CHUNK_LENGTHS = (16, 100, 257, 384, 511, 600, 1000)
CHUNK_BUDGET, CHUNK_MAX_LEN = 260, 1280
# The chunk whose time is profiled (start, tokens), and phase 12b's long
# and short prompts.
IDLE_CHUNK = (512, 256)
LONG_SHORT = (1000, 16)


def _q_offset_spy():
    """Count the flash-attention launches the attention layers make on the
    card, and those of them at q_offset > 0 (a chunk's continuation).
    Returns (counts, restore)."""
    from repro_torch.models import attention

    real = attention.flash_attention
    counts = {"launches": 0, "q_offset_gt_0": 0}

    def spy(q, *args, q_offset=0, **kw):
        if q.is_cuda:
            counts["launches"] += 1
            counts["q_offset_gt_0"] += q_offset > 0
        return real(q, *args, q_offset=q_offset, **kw)

    attention.flash_attention = spy

    def restore():
        attention.flash_attention = real

    return counts, restore


def _chunk_engine(cfg, params, mode: str, slots: int = 4):
    import torch

    from repro_torch.serve import (BucketPolicy, ServeEngine,
                                   ShapeBucketScheduler)

    policy = BucketPolicy(CHUNK_EDGES, allow_overflow=True)
    return ServeEngine(
        cfg, params, max_len=CHUNK_MAX_LEN, slots=slots, dtype=torch.float32,
        scheduler=ShapeBucketScheduler(policy), device="cuda",
        chunk_prefill=mode != "unchunked", pack_prefill=mode == "packed",
        step_token_budget=CHUNK_BUDGET if mode != "unchunked" else 0,
        prefill_slots=3 if mode == "packed" else 2)


def chunked_serve(cfg, params, phase4_prompts):
    """Phase 12a: full-width qwen2-1.5b served chunked, then packed: seven
    requests (16-1000 tokens) on 4 slots, every token held against the
    plain versions on the prompt as the scheduler padded it; the launches
    by kernel, flash_attention's at q_offset > 0, chunks per prefill,
    segments per packed step, and where one 256-token chunk's time goes."""
    import numpy as np
    import torch

    from repro_torch.kernels import build
    from repro_torch.models import api, transformer
    from repro_torch.serve import ShapeBucketScheduler

    rng = np.random.default_rng(0)
    prompts = [np.asarray(p) for p in phase4_prompts]
    prompts.append(rng.integers(2, cfg.vocab_size, size=CHUNK_LENGTHS[-1]))
    check(tuple(len(p) for p in prompts) == CHUNK_LENGTHS,
          f"prompt lengths {[len(p) for p in prompts]}")
    new_tokens = 16
    out = {}
    for mode in ("chunked", "packed"):
        eng = _chunk_engine(cfg, params, mode)
        counts, restore = _q_offset_spy()
        build.reset_launches()
        t0 = time.perf_counter()
        try:
            rids = [eng.add_request(p, max_new_tokens=new_tokens)
                    for p in prompts]
            check(all(r is not None for r in rids),
                  f"{mode}: requests rejected: {rids}")
            segments, steps = [], 0
            done = {}
            while eng.in_flight() or eng.scheduler.pending():
                done.update((r.rid, r) for r in eng.run_until_done(1))
                segments.append(len(eng.last_step_stats["prefill_segments"]))
                steps += 1
            torch.cuda.synchronize()
        finally:
            restore()
        dt = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        check(sorted(done) == sorted(rids), f"{mode}: not every request "
              "finished")
        for name in SERVE_KERNELS:
            check(launches[name] > 0, f"{mode}: {name} never launched")
        check(counts["q_offset_gt_0"] > 0,
              f"{mode}: no flash_attention launch at q_offset > 0")
        m = eng.metrics.as_dict()["chunked_prefill"]
        if mode == "packed":
            check(max(segments) >= 2, f"packed: no step held two segments "
                  f"({segments})")
        policy = eng.scheduler.policy
        sched = ShapeBucketScheduler(policy)
        held, margins = {}, []
        for rid, p in zip(rids, prompts):
            req = done[rid]
            padded = sched.prepare(types.SimpleNamespace(
                prompt=np.asarray(p, np.int32), bucket=req.bucket))
            key = (len(p), tuple(req.out_tokens))
            if key not in held:
                _, margin = hold_against_plain(
                    params, cfg, padded, req.out_tokens, [], CHUNK_MAX_LEN,
                    False, f"{mode} prompt {len(p)}")
                held[key] = margin
            margins.append(held[key])
        rec = dict(seconds=dt, steps=steps, launches=launches,
                   flash_attention_calls=counts["launches"],
                   flash_attention_q_offset_gt_0=counts["q_offset_gt_0"],
                   chunks_per_prefill=m["chunks_per_prefill"],
                   packed_chunks_per_step=m.get("packed_chunks_per_step"),
                   segments_per_step_max=max(segments),
                   buckets=[done[r].bucket for r in rids],
                   tokens=[done[r].out_tokens for r in rids],
                   min_top2_margin=min(margins),
                   cache_sets=eng.cache_sets_made,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        out[mode] = rec
        log(f"  {mode}: {len(rids)} requests (buckets {rec['buckets']}), "
            f"{len(rids) * new_tokens} tokens in {dt:.3f} s over {steps} "
            f"steps; chunks/prefill {rec['chunks_per_prefill']}"
            + (f", segments/packed step {rec['packed_chunks_per_step']}"
               if mode == "packed" else "")
            + f"; {eng.cache_sets_made} cache sets; every token the plain "
            f"versions' or within a top-2 margin of {LOGIT_REL_TOL:g} x max "
            f"|logit| (smallest margin {rec['min_top2_margin']:.3e})")
        log(f"  {mode} launches: {launches}; flash_attention at q_offset > "
            f"0: {counts['q_offset_gt_0']} of {counts['launches']}")

    # One 256-token chunk at start 512: wall time on the host clock, device
    # busy by kernel group, the device's idle share.
    eng = _chunk_engine(cfg, params, "chunked")
    start, chunk = IDLE_CHUNK
    tiles = eng._chunk_plan(eng.scheduler.admit_length(start + chunk))[1]
    toks = torch.as_tensor(rng.integers(2, cfg.vocab_size,
                                        size=(1, start + chunk)),
                           device="cuda")
    state = api.make_serve_state(cfg, 1, CHUNK_MAX_LEN, torch.float32,
                                 device="cuda")

    def one_chunk():
        with torch.inference_mode():
            api.prefill_chunk(params, cfg, toks[:, start:], state, start,
                              tiles=tiles)

    with torch.inference_mode():
        transformer.reset_caches(state)
        api.prefill_chunk(params, cfg, toks[:, :start], state, 0,
                          tiles=tiles)
    one_chunk()
    wall = statistics.median(per_step_ms(one_chunk, 1) for _ in range(5))
    groups = {}
    for name, ms in device_kernels(one_chunk, calls=3).items():
        g = _kernel_group(name)
        groups[g] = groups.get(g, 0.0) + ms
    busy = sum(groups.values())
    rec = out["idle_chunk"] = dict(
        start=start, tokens=chunk, wall_ms=wall, device_busy_ms=busy,
        idle_share=max(0.0, 1 - busy / wall), by_group_ms=groups,
        tile=list(tiles["chunked_prefill"]))
    by_group = ", ".join(f"{g} {t:.3f}" for g, t in sorted(
        groups.items(), key=lambda kv: -kv[1]))
    log(f"  one {chunk}-token chunk at start {start}: wall {wall:.3f} ms, "
        f"device busy {busy:.3f} ms, idle {100 * rec['idle_share']:.1f}% "
        f"({by_group})")
    return out


def short_behind_long(cfg, params, rounds: int = 3):
    """Phase 12b: a 1000-token request, then a 16-token one, submitted in
    the same step: each one's time to first token on the host clock (from
    its submit to the engine's reading of its first token, which waits for
    the device), unchunked, chunked and packed. Each mode's engine serves
    one round first (tile resolution, the slots' graph captures), then
    ``rounds`` more; the median is recorded, not gated."""
    import numpy as np

    rng = np.random.default_rng(12)
    out = {}
    for mode in ("unchunked", "chunked", "packed"):
        eng = _chunk_engine(cfg, params, mode)
        first = {}
        record = eng.metrics.record_first_token

        def stamp(rid, bucket, record=record):
            first[rid] = time.perf_counter()
            record(rid, bucket)

        eng.metrics.record_first_token = stamp
        runs = []
        for _ in range(rounds + 1):
            long_p, short_p = (rng.integers(2, cfg.vocab_size, size=n)
                               for n in LONG_SHORT)
            t0 = time.perf_counter()
            rid_long = eng.add_request(long_p, max_new_tokens=4)
            rid_short = eng.add_request(short_p, max_new_tokens=4)
            eng.run_until_done()
            runs.append(((first[rid_short] - t0) * 1e3,
                         (first[rid_long] - t0) * 1e3))
        short = statistics.median(r[0] for r in runs[1:])
        long_ = statistics.median(r[1] for r in runs[1:])
        out[mode] = dict(short_ttft_ms=short, long_ttft_ms=long_,
                         runs_ms=runs[1:])
        log(f"  {mode:9s}: the {LONG_SHORT[1]}-token request's TTFT "
            f"{short:.1f} ms, the {LONG_SHORT[0]}-token one's {long_:.1f} ms"
            f" (median of {rounds}, host clock)")
    return out


def _rel_err(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def chunked_vs_whole(cfg, params, n: int, chunk: int, max_len: int,
                     label: str, seed: int, plain: bool = False):
    """Phase 12c-d: an ``n``-token prompt prefilled in ``chunk``-token
    chunks (``api.prefill_chunk``) against the whole-prompt prefill through
    the same kernels: last logits and every cache tensor within
    LOGIT_REL_TOL of its max |value| (slot maps exact). Every chunk of
    every attention layer must launch flash_attention (counted over the
    chunks alone). With ``plain`` the chunks run once more on the plain
    versions (a ring's chunk the positioned ``flash_prefill_chunk_ref``),
    and the kernels' chunked state is held against that one too. Returns
    the two kernel states, and the report."""
    import numpy as np
    import torch

    from repro_torch.kernels import build
    from repro_torch.models import api
    from repro_torch.models.transformer import is_kv_cache

    ring = bool(cfg.attn_window)
    toks = np.random.default_rng(seed).integers(2, cfg.vocab_size,
                                                size=(1, n))

    def chunked(impl):
        state = api.make_serve_state(cfg, 1, max_len, torch.float32,
                                     device="cuda", ring_local=ring)
        for start in range(0, n, chunk):
            logits, _ = api.prefill_chunk(params, cfg,
                                          toks[:, start:start + chunk], state,
                                          start, impl=impl)
        return logits, state

    with torch.inference_mode():
        whole, ws = api.prefill(params, cfg, {"tokens": toks},
                                max_len=max_len, ring_local=ring)
        build.reset_launches()
        logits, cs = chunked("auto")
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        pl, ps = chunked("reference") if plain else (None, None)
    chunks = -(-n // chunk)
    attn_layers = sum(1 for c in cs if is_kv_cache(c))
    check(launches["flash_attention"] == chunks * attn_layers,
          f"{label}: {launches['flash_attention']} flash_attention launches "
          f"over {chunks} chunks of {attn_layers} attention layers")
    v = cfg.vocab_size

    def held(a_logits, a_state, b_logits, b_state, against):
        logit_err = _rel_err(a_logits[0, :v], b_logits[0, :v])
        check(logit_err <= LOGIT_REL_TOL, f"{label}: chunked logits differ "
              f"from {against} by {logit_err:.3e} x max |logit|")
        state_err = 0.0
        for li, (a, b) in enumerate(zip(a_state, b_state)):
            for key in a:
                if key == "slot_pos" or key == "pos":
                    check(torch.equal(a[key], b[key]),
                          f"{label} layer {li}: {key} differs from {against}")
                    continue
                x, y = a[key], b[key]
                if key in ("k", "v") and "slot_pos" not in a:
                    x, y = x[:, :, :n], y[:, :, :n]
                err = _rel_err(x, y)
                state_err = max(state_err, err)
                check(err <= LOGIT_REL_TOL, f"{label} layer {li}: {key} "
                      f"differs from {against} by {err:.3e} x max |value|")
        return logit_err, state_err

    logit_err, state_err = held(logits, cs, whole, ws, "the whole prefill")
    log(f"  {label}: {n} tokens in {chunks} chunks of {chunk} against the "
        f"whole prefill: logits within {logit_err:.3e}, states within "
        f"{state_err:.3e} x max |value| (tol {LOGIT_REL_TOL:g}; positions "
        f"and slot maps equal); flash_attention launched "
        f"{launches['flash_attention']} times ({attn_layers} attention "
        f"layers x {chunks} chunks)")
    report = dict(prompt=n, chunk=chunk, chunks=chunks,
                  logit_rel_err=logit_err, state_rel_err=state_err,
                  flash_attention_launches=launches["flash_attention"],
                  first_token=int(torch.argmax(logits[0, :v])),
                  whole_first_token=int(torch.argmax(whole[0, :v])))
    if plain:
        p_logit, p_state = held(logits, cs, pl, ps, "the plain chunks")
        log(f"  {label}: the same chunks on the plain versions: logits "
            f"within {p_logit:.3e}, states within {p_state:.3e} x max "
            f"|value|")
        report.update(plain_logit_rel_err=p_logit, plain_state_rel_err=p_state)
        del ps
    return cs, ws, report


def decode_from_states(cfg, params, states, n: int, steps: int, max_len):
    """``steps`` captured decode steps of a one-slot engine from each of
    ``states`` (moved into the slot as a chunked prefill's is): the token
    lists, one per state."""
    import torch

    from repro_torch.serve import ServeEngine
    from repro_torch.serve.engine import _move_state

    eng = ServeEngine(cfg, params, max_len=max_len, slots=1,
                      dtype=torch.float32, device="cuda")
    slot, out = eng._slots[0], []
    for st, first in states:
        _move_state(st, slot.caches, n)
        toks, logits = [first], []
        with torch.inference_mode():
            for _ in range(steps):
                slot.token.fill_(toks[-1])
                eng._step(slot)
                toks.append(int(slot.next_token))
                logits.append(slot.logits[0, :cfg.vocab_size].clone())
        out.append((toks, logits))
    check(slot.graph is not None, "the decode step was not captured")
    return out


# ---------------------------------------------------------------------------
# Phase 13: paged serving at full width
# ---------------------------------------------------------------------------

# 13a: phase 12a's prompts and a 510-token one, which ends two tokens
# before the default page's edge (512), so its third decode step maps a new
# page under a graph captured before it; FIFO, so no prompt is padded.
PAGED_EXTRA = 510
# 13b: a donor's prompt, and the page: 768 tokens are 12 whole pages.
PREFIX_DONOR, PREFIX_TAIL, PREFIX_PAGE = 768, 32, 64
# 13c: h2o-danube-1.8b at full width and 4 of its 24 layers.
PAGED_H2O_LAYERS, PAGED_H2O_MAX_LEN = 4, 4352
PAGED_H2O_LENGTHS = (4200, 4090, 64)


def _paged_engine(cfg, params, mode: str, paged: bool, slots: int = 4,
                  max_len: int = CHUNK_MAX_LEN, **kw):
    """A captured engine (FIFO) in ``mode``: unchunked, or chunked or
    packed under phase 12a's step budget; with ``paged`` on the pool."""
    import torch

    from repro_torch.serve import ServeEngine

    return ServeEngine(
        cfg, params, max_len=max_len, slots=slots, dtype=torch.float32,
        device="cuda", chunk_prefill=mode != "unchunked",
        pack_prefill=mode == "packed",
        step_token_budget=CHUNK_BUDGET if mode != "unchunked" else 0,
        prefill_slots=3 if mode == "packed" else 2, paged=paged, **kw)


def _count_captures(eng):
    """Count each slot's captures (warm-up and capture of its step)."""
    counts = [0] * eng.slots
    real = eng._capture

    def capture(slot):
        counts[next(i for i, s in enumerate(eng._slots) if s is slot)] += 1
        real(slot)

    eng._capture = capture
    return counts


def _serve_counted(eng, prompts, new_tokens: int):
    """Serve ``prompts`` to the end with the launch counts set to 0 just
    before: (tokens per prompt, launches, seconds, captures per slot)."""
    import torch

    from repro_torch.kernels import build

    captures = _count_captures(eng)
    build.reset_launches()
    t0 = time.perf_counter()
    rids = [eng.add_request(p, max_new_tokens=new_tokens) for p in prompts]
    check(all(r is not None for r in rids), f"requests rejected: {rids}")
    done = {r.rid: r for r in eng.run_until_done()}
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    check(sorted(done) == sorted(rids), "not every request finished")
    return [done[r].out_tokens for r in rids], launches, dt, captures


def _check_pool(eng, label: str):
    """The drained pool: balanced, every page allocated also freed."""
    try:
        eng.pool.check_balanced()
    except AssertionError as exc:
        raise SmokeError(f"{label}: pool not balanced: {exc}") from None
    pool = eng.metrics.as_dict()["pool"]
    check(pool["page_allocs"] == pool["page_frees"] > 0,
          f"{label}: {pool['page_allocs']} page allocs, "
          f"{pool['page_frees']} frees")
    return pool


def paged_serve(cfg, params, phase4_prompts):
    """Phase 13a: full-width qwen2-1.5b on the paged pool (default page)
    against the port's unpaged engine, unchunked, chunked and packed:
    phase 12a's seven prompts and a 510-token one, 16 new tokens each.
    Tokens held (``hold_tokens``), the pool balanced, matmul,
    flash_attention and flash_decode launched under paging (counts set to
    0 just before each paged serve), each slot captured once and as often
    as the unpaged run's, and the peak of pages in use x page beside the
    rows the unpaged engine's caches hold."""
    import numpy as np

    rng = np.random.default_rng(0)
    prompts = [np.asarray(p) for p in phase4_prompts]
    prompts.append(rng.integers(2, cfg.vocab_size, size=CHUNK_LENGTHS[-1]))
    prompts.append(rng.integers(2, cfg.vocab_size, size=PAGED_EXTRA))
    new_tokens = 16
    out = {}
    for mode in ("unchunked", "chunked", "packed"):
        base = _paged_engine(cfg, params, mode, paged=False)
        want, base_launches, base_s, base_caps = _serve_counted(
            base, prompts, new_tokens)
        base_sets = base.slots + base.cache_sets_made
        base_rows = CHUNK_MAX_LEN * base_sets
        del base
        eng = _paged_engine(cfg, params, mode, paged=True)
        got, launches, dt, caps = _serve_counted(eng, prompts, new_tokens)
        for name in SERVE_KERNELS:
            check(launches[name] > 0, f"paged {mode}: {name} never launched")
        check(caps == base_caps and caps == [1] * eng.slots,
              f"paged {mode}: captures per slot {caps}, unpaged {base_caps}")
        differ = sum(hold_tokens(params, cfg, p, a, b, f"paged {mode} "
                                 f"prompt {len(p)}")
                     for p, a, b in zip(prompts, got, want))
        pool = _check_pool(eng, f"paged {mode}")
        page = eng.pool.page
        rec = dict(page=page, n_pt=eng.pool.n_pt, pool_pages=eng.pool.n_pages,
                   seconds=dt, unpaged_seconds=base_s, launches=launches,
                   unpaged_launches=base_launches, captures=caps,
                   tokens_differ=differ, pool=pool,
                   peak_rows=pool["pages_used_max"] * page,
                   unpaged_rows=base_rows,
                   chunks_per_prefill=eng.metrics.as_dict()[
                       "chunked_prefill"]["chunks_per_prefill"])
        out[mode] = rec
        log(f"  {mode}: {len(prompts)} requests, {len(prompts) * new_tokens}"
            f" tokens in {dt:.3f} s paged, {base_s:.3f} s unpaged; page "
            f"{page} ({eng.pool.n_pt} table entries, pool of "
            f"{eng.pool.n_pages} pages); {differ} token streams differ (each"
            f" within the plain top-2 margin); captures per slot {caps}")
        log(f"    pool: {pool['page_allocs']} allocs = {pool['page_frees']} "
            f"frees, peak {pool['pages_used_max']} pages x {page} = "
            f"{rec['peak_rows']} rows against the unpaged engine's "
            f"{base_rows} ({base_sets} cache sets of {CHUNK_MAX_LEN}); "
            f"launches {launches}")
    return out


def prefix_sharing(cfg, params):
    """Phase 13b: a 768-token donor decodes while a request of the same 768
    tokens and 32 more arrives; once that one has its first token, one of
    the donor's 768 exactly arrives (768 is 12 whole pages of 64, so the
    800-token request maps them and splits none; the repeat's hit is
    capped at 767 and it splits the shared last page). Unchunked, page 64,
    with sharing against without: tokens equal, at least one prefix hit
    and one copy-on-write split, and the 800-token request's time to first
    token on the host clock (its submit to its first token)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(13)
    donor = rng.integers(2, cfg.vocab_size, size=PREFIX_DONOR)
    tail = np.concatenate([donor, rng.integers(2, cfg.vocab_size,
                                               size=PREFIX_TAIL)])
    out = {}
    for sharing in (True, False):
        eng = _paged_engine(cfg, params, "unchunked", paged=True,
                            page_size=PREFIX_PAGE, prefix_sharing=sharing)
        first = {}
        record = eng.metrics.record_first_token

        def stamp(rid, bucket, record=record):
            first[rid] = time.perf_counter()   # after the token's readback
            record(rid, bucket)

        eng.metrics.record_first_token = stamp
        rid_d = eng.add_request(donor, max_new_tokens=32)
        eng.step()                      # the donor prefills and registers
        eng.step()                      # and decodes
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rid_t = eng.add_request(tail, max_new_tokens=8)
        done = {}
        while rid_t not in first:
            done.update((r.rid, r.out_tokens) for r in eng.run_until_done(1))
        rid_r = eng.add_request(donor, max_new_tokens=8)
        done.update((r.rid, r.out_tokens) for r in eng.run_until_done())
        check(sorted(done) == sorted((rid_d, rid_t, rid_r)),
              "not every request finished")
        pool = _check_pool(eng, f"prefix sharing {sharing}")
        out[sharing] = dict(tokens=[done[r] for r in (rid_d, rid_t, rid_r)],
                            pool=pool, ttft_ms=(first[rid_t] - t0) * 1e3)
    on, off = out[True], out[False]
    for label, a, b, p in zip(("donor", "donor+32", "donor again"),
                              on["tokens"], off["tokens"],
                              (donor, tail, donor)):
        hold_tokens(params, cfg, p, a, b, f"prefix sharing {label}")
    check(on["pool"]["prefix_hits"] >= 1, "prefix reuse never fired")
    check(on["pool"]["cow_splits"] >= 1, "no copy-on-write split")
    check(off["pool"]["prefix_hits"] == 0 and off["pool"]["cow_splits"] == 0,
          "sharing off still shared")
    log(f"  page {PREFIX_PAGE}: {on['pool']['prefix_hits']} prefix hits, "
        f"{on['pool']['prefix_tokens_reused']} tokens reused, "
        f"{on['pool']['cow_splits']} copy-on-write splits; tokens equal to "
        f"the run without sharing; the {PREFIX_DONOR + PREFIX_TAIL}-token "
        f"request's TTFT {on['ttft_ms']:.1f} ms with sharing, "
        f"{off['ttft_ms']:.1f} ms without (host clock); peak pages "
        f"{on['pool']['pages_used_max']} / {off['pool']['pages_used_max']}")
    return dict(with_sharing=on, without_sharing=off)


def paged_windowed():
    """Phase 13c: h2o-danube-1.8b at full width (D 80, window 4096) and 4
    of its layers, paged (unchunked, the default page): windowed decode
    over the linear paged view against the ring engine's tokens, prompts
    of 4200 (past the window at prefill), 4090 (crosses it while decoding)
    and 64, 16 new tokens each."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models import api

    full = configs.get_arch("h2o-danube-1.8b")
    cfg = dataclasses.replace(
        full, n_layers=PAGED_H2O_LAYERS,
        layer_pattern=full.layer_pattern[:PAGED_H2O_LAYERS]).validate()
    params = api.init_params(cfg, 0, dtype=torch.float32, device="cuda")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(2, cfg.vocab_size, size=n)
               for n in PAGED_H2O_LENGTHS]
    ring = _paged_engine(cfg, params, "unchunked", paged=False, slots=3,
                         max_len=PAGED_H2O_MAX_LEN)
    check(all(c["k"].shape[2] == cfg.attn_window
              for c in ring._slots[0].caches), "the ring engine has no rings")
    want, _, ring_s, _ = _serve_counted(ring, prompts, 16)
    del ring
    eng = _paged_engine(cfg, params, "unchunked", paged=True, slots=3,
                        max_len=PAGED_H2O_MAX_LEN)
    got, launches, dt, caps = _serve_counted(eng, prompts, 16)
    for name in SERVE_KERNELS:
        check(launches[name] > 0, f"paged h2o-danube: {name} never launched")
    differ = sum(hold_tokens(params, cfg, p, a, b, f"paged h2o-danube "
                             f"prompt {len(p)}")
                 for p, a, b in zip(prompts, got, want))
    pool = _check_pool(eng, "paged h2o-danube")
    log(f"  {len(prompts)} requests ({', '.join(map(str, PAGED_H2O_LENGTHS))}"
        f"-token prompts) in {dt:.3f} s paged (page {eng.pool.page}, view "
        f"{eng.pool.n_pt * eng.pool.page} rows, window {cfg.attn_window}), "
        f"{ring_s:.3f} s on rings; {differ} token streams differ (within the "
        f"plain top-2 margin); captures {caps}; launches {launches}")
    return dict(seconds=dt, ring_seconds=ring_s, launches=launches,
                tokens_differ=differ, pool=pool, page=eng.pool.page,
                tokens=got)


def _paged_decode_times(cfg, params, slots: int, paged: bool, profile: bool,
                        prompt_len: int = 600, steps: int = 12,
                        reps: int = 3):
    """The engine's captured decode at ``slots`` slots (600-token prompts,
    phase 13a's geometry): host-clock ms a step (median of ``reps`` runs of
    ``steps``) and device ms a step (CUDA events around ``steps`` rounds
    of the slots' graph replays). Paged, the pages those replays write are
    mapped first, and every slot's position is put back after them. With
    ``profile``, the device ms of one round by kernel name."""
    import numpy as np
    import torch

    rng = np.random.default_rng(4)
    eng = _paged_engine(cfg, params, "unchunked", paged=paged, slots=slots)
    for _ in range(slots):
        eng.add_request(rng.integers(2, cfg.vocab_size, size=prompt_len),
                        max_new_tokens=(reps + 3) * steps + 8)
    eng.step()                 # prefill, warm-up, capture, first replay
    eng.step()
    host = statistics.median(per_step_ms(eng.step, steps)
                             for _ in range(reps))
    check(eng.in_flight() == slots, "a request left the engine early")
    active = [(s, r) for s, r in zip(eng._slots, eng._active)]
    if paged:
        for slot, req in active:
            eng.pool.prepare_span(req.rid, eng._pos[req.rid], 2 * steps)
            eng.pool.device_table(req.rid, slot.table)
            slot.table_host = list(eng.pool.tables[req.rid])
    saved = [[c["pos"].clone() for c in s.caches] for s, _ in active]
    graphs = [s.graph for s, _ in active]
    check(all(g is not None for g in graphs), "a slot has no graph")

    def rounds(n):
        for _ in range(n):
            for g in graphs:
                g.replay()

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    rounds(steps)
    end.record()
    torch.cuda.synchronize()
    device = start.elapsed_time(end) / steps
    kernels = device_kernels(lambda: rounds(1), calls=3) if profile else None
    for (s, _), pos in zip(active, saved):
        for c, p in zip(s.caches, pos):
            c["pos"].copy_(p)
    eng.run_until_done()
    if paged:
        _check_pool(eng, f"paged decode timing at {slots} slots")
    return dict(host_ms=host, device_ms=device, kernels_ms=kernels)


def paged_decode_step(cfg, params, profile: bool):
    """Phase 13d: the captured decode step, paged (page 512, a 1536-row
    gathered view) against unpaged (1280-row caches), at 1 and 4 slots, in
    turns (unpaged, paged, paged, unpaged; the medians of each pair); with
    ``profile`` the gather's share of a paged step's device time (the
    index_select kernels). Then the attention call alone on the card:
    flash_decode over a 1280-row cache beside the paged call (the gather of
    K and V and flash_decode over the 1536-row view) and the gather alone,
    all at position 600, each call beside its plain version
    (``flash_decode_ref``, after the same gather when paged) and the
    library's (SDPA with one query over the cache, or over the gathered
    view, masked past the position)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.decode import (
        flash_decode, flash_decode_ref, paged_gather,
    )

    out = {}
    for slots in (1, 4):
        runs = {False: [], True: []}
        for paged in (False, True, True, False):
            runs[paged].append(_paged_decode_times(
                cfg, params, slots, paged, profile and slots == 1))
        rec = {}
        for paged, label in ((False, "unpaged"), (True, "paged")):
            rec[label] = dict(
                host_ms=statistics.median(r["host_ms"] for r in runs[paged]),
                device_ms=statistics.median(r["device_ms"]
                                            for r in runs[paged]),
                runs=[dict(host_ms=r["host_ms"], device_ms=r["device_ms"])
                      for r in runs[paged]])
        if profile and slots == 1:
            for paged, label in ((False, "unpaged"), (True, "paged")):
                ks = runs[paged][0]["kernels_ms"]
                busy = sum(ks.values())
                gather = sum(ms for k, ms in ks.items() if "indexSelect" in k)
                rec[label].update(profile_busy_ms=busy, gather_ms=gather,
                                  gather_share=gather / busy if busy else 0.0,
                                  kernels_ms=ks)
        out[f"slots_{slots}"] = rec
        u, p = rec["unpaged"], rec["paged"]
        log(f"  decode at {slots} slot(s): unpaged {u['host_ms']:.3f} ms a "
            f"step on the host clock, {u['device_ms']:.3f} on the device; "
            f"paged {p['host_ms']:.3f} / {p['device_ms']:.3f} "
            f"({100 * (p['device_ms'] / u['device_ms'] - 1):+.1f}% device)")
        if "gather_ms" in p:
            log(f"    profiler: paged step busy {p['profile_busy_ms']:.3f} "
                f"ms, the gather (index_select) {p['gather_ms']:.4f} ms "
                f"({100 * p['gather_share']:.1f}%); unpaged busy "
                f"{u['profile_busy_ms']:.3f} ms")

    # The attention call alone, on one layer's shapes, each call on its own
    # copy of the inputs (``copies_for``: they overflow the L2).
    gen = torch.Generator(device="cuda").manual_seed(9)
    page, n_pt, n_pages = 512, 3, 12
    hkv, d = cfg.padded_kv_heads, cfg.head_dim_

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    q = randn(1, cfg.padded_heads, d)
    pos = dev_pos(600)
    table = torch.tensor([7, 2, 10], dtype=torch.int32, device="cuda")
    view_bytes = 2 * 2 * hkv * n_pt * page * d * 4
    linear = [(randn(1, hkv, CHUNK_MAX_LEN, d), randn(1, hkv, CHUNK_MAX_LEN,
                                                      d))
              for _ in range(copies_for(2 * hkv * CHUNK_MAX_LEN * d * 4))]
    pages = [(randn(n_pages, hkv, page, d), randn(n_pages, hkv, page, d))
             for _ in range(copies_for(view_bytes))]

    def unpaged_call(k, v):
        return lambda: flash_decode(q, k, v, pos=pos)

    def paged_call(kp, vp):
        return lambda: flash_decode(q, paged_gather(kp, table),
                                    paged_gather(vp, table), pos=pos)

    def gather(kp, vp):
        return lambda: (paged_gather(kp, table), paged_gather(vp, table))

    def plain(paged):
        def call(k, v):
            if paged:
                return lambda: flash_decode_ref(q, paged_gather(k, table),
                                                paged_gather(v, table),
                                                pos=pos)
            return lambda: flash_decode_ref(q, k, v, pos=pos)
        return call

    def sdpa(paged):
        rows = n_pt * page if paged else CHUNK_MAX_LEN
        mask = (torch.arange(rows, device="cuda") <= 600)[None, None, None]

        def call(k, v):
            if paged:
                return lambda: F.scaled_dot_product_attention(
                    q[:, :, None], paged_gather(k, table),
                    paged_gather(v, table), attn_mask=mask, enable_gqa=True)
            return lambda: F.scaled_dot_product_attention(
                q[:, :, None], k, v, attn_mask=mask, enable_gqa=True)
        return call

    calls = dict(unpaged_ms=time_ms([unpaged_call(*kv) for kv in linear]),
                 paged_ms=time_ms([paged_call(*kv) for kv in pages]),
                 gather_ms=time_ms([gather(*kv) for kv in pages]),
                 unpaged_plain_ms=time_ms([plain(False)(*kv)
                                           for kv in linear]),
                 paged_plain_ms=time_ms([plain(True)(*kv) for kv in pages]),
                 unpaged_library_ms=library_ms([sdpa(False)(*kv)
                                                for kv in linear]),
                 paged_library_ms=library_ms([sdpa(True)(*kv)
                                              for kv in pages]))
    del linear, pages
    calls["gather_bound_ms"] = view_bytes / HBM_BYTES_PER_S * 1e3
    out["attention_call"] = calls
    log(f"  one layer's attention call at position 600: flash_decode over "
        f"{CHUNK_MAX_LEN} rows {calls['unpaged_ms']:.4f} ms; paged (gather + "
        f"flash_decode over {n_pt * page} rows) {calls['paged_ms']:.4f} ms; "
        f"the gather alone {calls['gather_ms']:.4f} ms (bound "
        f"{calls['gather_bound_ms']:.4f} ms: {view_bytes} bytes)")
    log(f"    plain: {calls['unpaged_plain_ms']:.4f} ms unpaged, "
        f"{calls['paged_plain_ms']:.4f} ms gather + view; library (SDPA): "
        f"{_ms(calls['unpaged_library_ms'])} unpaged, "
        f"{_ms(calls['paged_library_ms'])} gather + view")
    return out


def _ms(t) -> str:
    return "not timed" if t is None else f"{t:.4f} ms"


# ---------------------------------------------------------------------------
# Phase 14: request tracing and shadow plan refinement in the engine, and the
# paper's examples, on the card
# ---------------------------------------------------------------------------

# 14b: a plan ranked by the cost model, refined by the card's times.
SHADOW_FRACTION = 1 / 4
REFINE_MIN_SAMPLES, REFINE_MIN_SPEEDUP = 3, 1.05
REFINE_MAX_ROUNDS = 24
TIMED_KERNELS = ("matmul", "flash_attention", "flash_decode")


def _bucket_engine(cfg, params, **kw):
    """Phase 4's engine (4 slots, MAX_LEN, captured decode) with phase 4b's
    bucket edges."""
    import torch

    from repro_torch.serve import (BucketPolicy, ServeEngine,
                                   ShapeBucketScheduler)

    return ServeEngine(cfg, params, max_len=MAX_LEN, slots=4,
                       dtype=torch.float32, device="cuda",
                       scheduler=ShapeBucketScheduler(BucketPolicy(
                           PLAN_SERVE_EDGES, max_queue=64)), **kw)


def trace_serve(cfg, params, phase4):
    """Phase 14a: phase 4's six requests served twice each with and
    without a tracer (off, on, on, off, after a warm-up serve). Tokens bit-equal, each slot
    captured once in every serve, the trace's TTFT p95 equal to the
    metrics' p95, and the written trace (Chrome JSON and JSONL) read back
    by ``load_trace`` and ``trace_report`` (``main`` returns 0)."""
    import contextlib
    import io

    import numpy as np

    from repro_torch.launch import trace_report
    from repro_torch.obs import Tracer, load_trace, write_jsonl, write_trace

    prompts = [np.asarray(p) for p in phase4["prompts"]]
    new_tokens = phase4["new_tokens"]
    # A warm-up serve: the bucketed lengths' first prefills.
    _serve_counted(_bucket_engine(cfg, params), prompts, new_tokens)
    runs = {False: [], True: []}
    tokens = {}
    for traced in (False, True, True, False):
        tracer = Tracer() if traced else None
        eng = _bucket_engine(cfg, params, tracer=tracer)
        got, _, dt, caps = _serve_counted(eng, prompts, new_tokens)
        check(caps == [1] * eng.slots,
              f"traced={traced}: captures per slot {caps}")
        tokens.setdefault(traced, got)
        check(got == tokens[traced], f"traced={traced}: tokens moved "
              "between two serves")
        runs[traced].append(dt)
        if traced:
            last_tracer, last_eng = tracer, eng
    check(tokens[True] == tokens[False], "tracing changed the tokens")
    last_tracer.flush()
    ttfts = trace_report.ttft_values({"events": last_tracer.events})
    trace_p95 = trace_report.nearest_rank(ttfts, 0.95)
    metrics_p95 = last_eng.metrics.ttft_p95()
    check(len(ttfts) == len(prompts) and trace_p95 == metrics_p95,
          f"trace TTFT p95 {trace_p95} != metrics p95 {metrics_p95} "
          f"({len(ttfts)} spans)")
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    summaries = {}
    for path, writer in ((out_dir / "trace_14a.json", write_trace),
                         (out_dir / "trace_14a.jsonl", write_jsonl)):
        writer(last_tracer, str(path))
        summary = trace_report.summarize(load_trace(str(path)))
        check(summary["requests"] == len(prompts)
              and summary["ttft"]["n"] == len(prompts),
              f"{path.name}: summary {summary['requests']} requests")
        with contextlib.redirect_stdout(io.StringIO()) as text:
            rc = trace_report.main([str(path)])
        check(rc == 0, f"trace_report on {path.name} returned {rc}")
        summaries[path.name] = summary["ttft"]
    report = text.getvalue().splitlines()
    off_s, on_s = (statistics.median(runs[k]) for k in (False, True))
    out = dict(events=len(last_tracer.events), seconds_off=runs[False],
               seconds_on=runs[True], median_off_s=off_s, median_on_s=on_s,
               trace_p95_s=trace_p95, metrics_p95_s=metrics_p95,
               summaries=summaries)
    log(f"  tokens equal with and without the tracer; captures per slot "
        f"[1, 1, 1, 1] in all four serves; {len(last_tracer.events)} "
        f"events")
    log(f"  serve wall ms: tracing off {runs[False][0] * 1e3:.1f} / "
        f"{runs[False][1] * 1e3:.1f}, on {runs[True][0] * 1e3:.1f} / "
        f"{runs[True][1] * 1e3:.1f} (medians {off_s * 1e3:.1f} / "
        f"{on_s * 1e3:.1f}, {100 * (on_s / off_s - 1):+.2f}%)")
    log(f"  TTFT p95 {trace_p95 * 1e3:.3f} ms in the trace = "
        f"{metrics_p95 * 1e3:.3f} ms in the metrics")
    for line in report[:4]:
        log(f"    trace_report: {line}")
    return out


def _shadow_cells(eng):
    """The cells the engine resolved whose plan entry has candidates."""
    return {key: eng._shadow_cell_map[key] for key in eng._shadow_order
            if eng._shadow_view(key) is not None}


def refine_serve(cfg, params, phase4):
    """Phase 14b: the refinement loop on the card. A cost-model plan of
    phase 4b's serving cells: first for the GTX260 alone (the paper's
    donor), which holds no tile of the Hopper matmul, flash_attention or
    flash_decode within its 16 KB of shared memory, so the loop's plan is
    the H100's own cost-model ranking, never timed on the card. Served
    with shadowing off, then with a quarter of the steps diverted to
    timing (``make_shadow_measure(h100_sxm)``) and a PlanRefiner, phase
    4's requests repeated until every resolved matmul, flash_attention and
    flash_decode cell with candidates holds REFINE_MIN_SAMPLES samples of
    its incumbent and of one candidate. Tokens bit-equal to the shadowless
    serve, no slot recaptured by a shadow step, the three kernels launched
    by the measurements, every time finite (or inf for a tile that would
    not launch), the allocated bytes flat once every cell's timer is
    built. Then ``refine`` and ``set_plans``: the tokens again, one
    recapture per slot, and every refined cell resolved exactly."""
    import gc
    import math

    import numpy as np
    import torch

    from repro_torch.core import GTX260, H100_SXM, compile_plan, registry
    from repro_torch.kernels import build
    from repro_torch.launch.compile_plans import serve_bucket_cells
    from repro_torch.serve.refine import (PlanRefiner, drift_report,
                                          make_shadow_measure)

    cells = [(k, p) for k, p in serve_bucket_cells(
        ["qwen2-1.5b"], PLAN_SERVE_EDGES, slots=4, max_len=MAX_LEN)
        if k in registry.names()]
    gtx = compile_plan([(k, p, "float32", GTX260) for k, p in cells])
    gtx_kernels = sorted({e.kernel for e in gtx.entries()})
    log(f"  a gtx260 plan of the {len(cells)} serving cells holds "
        f"{len(gtx)} entries ({', '.join(gtx_kernels) or 'none'}); "
        f"{gtx.meta['skipped_jobs']} cells have no tile within its "
        f"{GTX260.vmem_bytes // 1024} KB of shared memory")
    plan = compile_plan([(k, p, "float32", H100_SXM) for k, p in cells],
                        meta={"generated_by": "chip_smoke phase 14b"})
    prompts = [np.asarray(p) for p in phase4["prompts"]]
    new_tokens = phase4["new_tokens"]

    base = _bucket_engine(cfg, params, plans=plan, hardware=H100_SXM)
    want, _, base_s, base_caps = _serve_counted(base, prompts, new_tokens)
    check(base_caps == [1] * base.slots, f"no shadow: captures {base_caps}")
    del base
    # An engine is freed by the cycle collector, whenever it runs: collect
    # now, or its ~225 MiB of caches may go inside the window below.
    gc.collect()

    timed = make_shadow_measure(H100_SXM)
    shadow_launches = {k: 0 for k in build.LAUNCHES}
    times = []

    def measure(kernel, problem, dtype, tile):
        before = dict(build.LAUNCHES)
        dt = timed(kernel, problem, dtype, tile)
        for k, n in build.LAUNCHES.items():
            shadow_launches[k] += n - before.get(k, 0)
        times.append((kernel, dt))
        return dt

    refiner = PlanRefiner(min_samples=REFINE_MIN_SAMPLES,
                          min_speedup=REFINE_MIN_SPEEDUP)
    eng = _bucket_engine(cfg, params, plans=plan, hardware=H100_SXM,
                         shadow_fraction=SHADOW_FRACTION,
                         shadow_measure=measure, refiner=refiner)
    steps = []                 # (ms, allocated bytes, timers) a shadow step
    real_shadow = eng._maybe_shadow

    def maybe_shadow():
        n, t0 = eng.metrics.shadow_steps, time.perf_counter()
        real_shadow()
        if eng.metrics.shadow_steps > n:
            steps.append(((time.perf_counter() - t0) * 1e3,
                          torch.cuda.memory_allocated(), len(timed.timers)))

    eng._maybe_shadow = maybe_shadow
    captures = _count_captures(eng)

    def pending():
        """Cells of the three kernels still short of samples."""
        short = []
        for key, (kernel, problem) in _shadow_cells(eng).items():
            if kernel not in TIMED_KERNELS:
                continue
            inc, cands = eng._shadow_view(key)
            stats = refiner._cells.get(("h100_sxm", kernel, key.split("|")[1],
                                        "float32"))
            counts = ({} if stats is None else
                      {t: s.count for t, s in stats.tiles.items()})
            if (counts.get(inc, 0) < REFINE_MIN_SAMPLES or max(
                    (counts.get(c, 0) for c in cands), default=0)
                    < REFINE_MIN_SAMPLES):
                short.append(key)
        return short

    t0 = time.perf_counter()
    rounds = 0
    differ = 0
    while rounds < REFINE_MAX_ROUNDS:
        rounds += 1
        rids = [eng.add_request(p, max_new_tokens=new_tokens)
                for p in prompts]
        check(all(r is not None for r in rids), f"rejected: {rids}")
        done = {r.rid: r.out_tokens for r in eng.run_until_done()}
        got = [done[r] for r in rids]
        check(got == want, f"round {rounds}: shadowing changed the tokens")
        if not pending():
            break
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    check(not pending(), f"cells short of samples after {rounds} rounds: "
          f"{pending()}")
    check(captures == [1] * eng.slots,
          f"shadow steps recaptured a slot: captures {captures}")
    for k in TIMED_KERNELS:
        check(shadow_launches[k] > 0,
              f"shadow measurement never launched {k}")
    n_inf = sum(1 for _, dt in times if dt == math.inf)
    check(all(dt == math.inf or (math.isfinite(dt) and dt > 0)
              for _, dt in times), "a shadow time is neither finite nor inf")
    n_cells = len(_shadow_cells(eng))
    steady = [i for i, s in enumerate(steps) if s[2] == steps[-1][2]]
    mem_first, mem_steady, mem_last = (steps[0][1], steps[steady[0]][1],
                                       steps[-1][1])
    check(len(steps) - steady[0] >= 10, f"only {len(steps) - steady[0]} "
          "shadow steps after the last timer was built")
    check(abs(mem_last - mem_steady) <= 4 << 20,
          f"allocated bytes grew by {(mem_last - mem_steady) / 2**20:.1f} "
          f"MiB over {len(steps) - steady[0]} shadow steps of built timers")
    shadow_ms = [s[0] for s in steps]
    log(f"  gtx260's place taken by the H100's cost-model plan: "
        f"{len(plan)} entries, every cell exact on the h100_sxm engine")
    log(f"  {rounds} rounds of {len(prompts)} requests in {loop_s:.1f} s, "
        f"{eng.steps_run} steps, {eng.metrics.shadow_steps} shadow steps "
        f"over {n_cells} cells with candidates; tokens equal to the "
        f"shadowless serve ({base_s * 1e3:.1f} ms) every round; captures "
        f"per slot {captures}")
    log(f"  a shadow step: median {statistics.median(shadow_ms):.2f} ms, "
        f"max {max(shadow_ms):.2f} ms on the host clock (two timed "
        f"measurements); launches by the measurements "
        f"{ {k: shadow_launches[k] for k in TIMED_KERNELS} }; "
        f"{len(times)} times, {n_inf} inf (tiles that would not launch)")
    log(f"  allocated: {mem_first / 2**20:.1f} MiB after the first shadow "
        f"step, {mem_steady / 2**20:.1f} once all {steps[-1][2]} timers were "
        f"built (step {steady[0] + 1}), {mem_last / 2**20:.1f} after the "
        f"last ({len(steps)})")
    samples = {}
    for (hw, kernel, problem, dtype), cell in sorted(refiner._cells.items()):
        samples[f"{kernel}|{problem}"] = {
            str(t): dict(count=s.count, mean_s=s.mean_s)
            for t, s in cell.tiles.items()}
    refined = refiner.refine(plan)
    report = drift_report(refined)
    # Both artifacts for phase 16d's rollout.
    (ROOT / "build").mkdir(exist_ok=True)
    plan_path = ROOT / "build" / "plan_14b.json"
    refined_path = ROOT / "build" / "refined_14b.json"
    plan.save(str(plan_path))
    refined.save(str(refined_path))
    log(f"  drift report: {report['n_refined']} cell(s) re-ranked from "
        f"{report['shadow_samples']} samples")
    for cell in report["cells"]:
        log(f"    {cell['cell']}: {cell['incumbent']} -> {cell['refined']} "
            f"({cell['incumbent_s'] * 1e3:.4f} -> "
            f"{cell['refined_s'] * 1e3:.4f} ms, {cell['speedup']:.3f}x, "
            f"{cell['samples']} samples)")
    for m in refined.meta["measurements"]:
        res = refined.resolve(m["kernel"], m["problem"], m["dtype"],
                              H100_SXM)
        check(res is not None and res.source == "exact",
              f"refined {m['kernel']} resolves {res and res.source}")
    eng.set_plans(refined)
    eng.shadow_fraction = 0.0
    before = list(captures)
    rids = [eng.add_request(p, max_new_tokens=new_tokens) for p in prompts]
    done = {r.rid: r.out_tokens for r in eng.run_until_done()}
    for p, r, w in zip(prompts, rids, want):
        differ += hold_tokens(params, cfg, p, done[r], w,
                              f"refined plan prompt {len(p)}")
    recaptures = [a - b for a, b in zip(captures, before)]
    check(recaptures == [1] * eng.slots,
          f"set_plans: recaptures per slot {recaptures}")
    log(f"  set_plans(refined): {differ} token streams differ from the "
        f"donor plan's; recaptures per slot {recaptures}")
    return dict(gtx260_entries=len(gtx), gtx260_kernels=gtx_kernels,
                plan_entries=len(plan), rounds=rounds, loop_s=loop_s,
                steps=eng.steps_run, shadow_steps=len(steps),
                cells_with_candidates=n_cells, shadow_ms=shadow_ms,
                shadow_launches=shadow_launches, times=len(times),
                inf_times=n_inf, mem_first=mem_first, mem_steady=mem_steady,
                mem_last=mem_last, samples=samples, drift=report,
                refined_differ=differ, no_shadow_s=base_s,
                plan_path=str(plan_path), refined_path=str(refined_path))


def run_examples():
    """Phase 14c: the paper's examples (``repro_torch.examples``) on the
    card, in this process, their output lines logged: quickstart, the
    bilinear kernel over a batch of images (each held against the oracle
    at 2e-5), tune_tiles' plan compile into a temporary file, and the
    engine over a reduced model."""
    import contextlib
    import io
    import tempfile

    from repro_torch.core import TilePlan
    from repro_torch.examples import (quickstart, resize_images, serve_lm,
                                      tune_tiles)

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        plan_path = str(Path(tmp) / "tune_tiles_plan.json")
        runs = (("quickstart", quickstart, []),
                ("resize_images", resize_images,
                 ["--size", "800", "--scale", "10", "--count", "4"]),
                ("tune_tiles", tune_tiles, ["--compile-plans", plan_path]),
                ("serve_lm", serve_lm, ["--requests", "8"]))
        for name, example, argv in runs:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as text:
                example.main(argv)
            lines = text.getvalue().splitlines()
            out[name] = dict(seconds=time.perf_counter() - t0, lines=lines)
            log(f"  examples.{name} {' '.join(argv)} "
                f"({out[name]['seconds']:.1f} s):")
            for line in lines[-12:]:
                log(f"    {line}")
        plan = TilePlan.load(plan_path)
        check(plan.hardware_names() == ["geforce_8800gts", "gtx260",
                                        "h100_sxm"],
              f"tune_tiles plan hardware {plan.hardware_names()}")
    check(any("matches the oracle" in s for s in out["quickstart"]["lines"]),
          "quickstart did not match the oracle")
    check(sum(s.startswith("image ") for s in out["resize_images"]["lines"])
          == 4, "resize_images did not upscale its 4 images")
    return out


# The launcher's archs (phase 8) and the kernels each one's serve runs.
ATTN_KERNELS = ("matmul", "flash_attention", "flash_decode")
LAUNCHER_KERNELS = {"qwen2-1.5b": ATTN_KERNELS, "gemma2-9b": ATTN_KERNELS,
                    "h2o-danube-1.8b": ATTN_KERNELS, "mamba2-2.7b": ("ssd",),
                    "recurrentgemma-9b": ATTN_KERNELS + ("rglru",),
                    "deepseek-moe-16b": ATTN_KERNELS,
                    # Every layer MoE and no shared experts: no matmul.
                    "qwen3-moe-235b-a22b": ("flash_attention",
                                            "flash_decode")}


# Phase 8's fleet runs: the smoke serving cells' analytic plan for both
# hardware models and its bucket edges; requests enough that the h100_sxm
# instance queues and the gtx260 one steals, and the autoscaled burst.
FLEET_PLAN_EDGES, FLEET_PLAN_MAX_LEN = (16, 32), 128
LAUNCHER_REQUESTS = {"qwen2-1.5b --fleet": 12, "qwen2-1.5b --autoscale": 24}


def _fleet_plan(path: Path) -> None:
    """An analytic plan of the smoke serving cells for h100_sxm and
    gtx260: the gtx260 instance's tiles (16 KB of shared memory) are not
    the H100's, and those its calls cannot launch fall back."""
    from repro_torch import kernels
    from repro_torch.core import GTX260, H100_SXM, compile_plan, registry
    from repro_torch.launch.compile_plans import serve_bucket_cells

    kernels.register_all()
    cells = serve_bucket_cells(["qwen2-1.5b"], FLEET_PLAN_EDGES, slots=4,
                               max_len=FLEET_PLAN_MAX_LEN, smoke=True)
    compile_plan([(k, p, "float32", hw) for k, p in cells
                  for hw in (H100_SXM, GTX260)
                  if k in registry.names()]).save(str(path))


def run_launcher():
    """The launcher at the smoke configs of qwen2-1.5b (also chunked,
    packed and paged, and through the fleet: an h100_sxm and a gtx260
    instance on an analytic plan of both, and an autoscaled one from one
    h100_sxm instance), of the two windowed archs (ring caches; 20 new
    tokens wrap gemma2's and h2o-danube's 16-slot rings), of mamba2-2.7b
    (SSD states), of recurrentgemma-9b (RG-LRU states beside 16-slot
    rings) and of the two MoE archs, each in its own process."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + (os.pathsep + env["PYTHONPATH"]
                                    if env.get("PYTHONPATH") else "")
    (ROOT / "build").mkdir(exist_ok=True)
    plan_path = ROOT / "build" / "fleet_plans.json"
    _fleet_plan(plan_path)
    runs = {arch: ["--arch", arch] for arch in LAUNCHER_KERNELS}
    for mode in ("--chunk-prefill", "--pack-prefill"):
        runs[f"qwen2-1.5b {mode}"] = [mode, "--step-token-budget", "40",
                                      "--scheduler", "bucket"]
    runs["qwen2-1.5b --paged"] = ["--paged"]
    edges = ",".join(map(str, FLEET_PLAN_EDGES))
    runs["qwen2-1.5b --fleet"] = [
        "--fleet", "h100_sxm,gtx260", "--scheduler", "bucket",
        "--tile-plans", str(plan_path), "--bucket-policy", edges]
    runs["qwen2-1.5b --autoscale"] = [
        "--fleet", "h100_sxm", "--scheduler", "bucket", "--autoscale",
        "--max-instances", "3"]
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cuda",
         "--requests", str(LAUNCHER_REQUESTS.get(name, 4)),
         "--new-tokens", "20", *args],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for name, args in runs.items()}
    for name, proc in procs.items():
        arch = name.split()[0]
        n = LAUNCHER_REQUESTS.get(name, 4)
        try:
            stdout, stderr = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for p in procs.values():
                p.kill()
            raise
        tail = "\n".join(stdout.strip().splitlines()[-14:])
        log(f"  --arch {name}\n  " + tail.replace("\n", "\n  "))
        check(proc.returncode == 0,
              f"launcher ({arch}) exited {proc.returncode}: {stderr[-2000:]}")
        check(f"{n} requests (0 rejected)" in stdout,
              f"launcher ({name}) did not serve its {n} requests")
        for kernel in LAUNCHER_KERNELS[arch]:
            check(f"'{kernel}': 0" not in stdout,
                  f"launcher ({name}) never launched {kernel}")
        if name.endswith(("--fleet", "--autoscale")):
            lines = [s for s in stdout.splitlines()
                     if s.startswith(("instance ", "autoscale:", "  step ",
                                      "placements:", "WARNING"))]
            check("WARNING" not in stdout,
                  f"launcher ({name}): the fleet did not drain")
            log("  " + "\n  ".join(lines))
        elif name != arch:
            check("chunked prefill:" in stdout,
                  f"launcher ({name}) printed no chunk metrics")
        if name.endswith("--paged"):
            check("kv pool:" in stdout,
                  f"launcher ({name}) printed no pool metrics")


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
        GEFORCE_8800GTS, GTX260, H100_SXM, Autotuner, TilePlan,
    )
    from repro_torch.core.tiling import TileShape
    from repro_torch.kernels import build
    from repro_torch.launch.measure import make_measure_fn

    jobs = plan_jobs()
    build.reset_launches()
    plan, timed, compile_s = compile_timed(jobs)
    launches = dict(build.LAUNCHES)
    path = out_dir / "chip_smoke_plans.json"
    out_dir.mkdir(parents=True, exist_ok=True)
    plan.save(str(path))
    loaded = TilePlan.load(str(path))
    log(f"  {len(jobs)} cells compiled and timed in {compile_s:.1f} s")
    for kernel, problem, dtype, hw in jobs:
        res = loaded.resolve(kernel, problem, dtype, hw)
        entry = plan.lookup(kernel, problem, dtype, hw.name)
        check(res is not None and res.source == "exact"
              and res.tile == entry.tile,
              f"{kernel} {problem}: the saved artifact does not resolve "
              f"exactly ({res and res.source})")
    cells = measured_cells(jobs, timed)
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


def compile_timed(jobs):
    """Compile ``jobs`` with wall-clock timing on the card, keeping every
    tile each cell timed, in the order the sweep timed them (the cost
    model's best first). Checks that no cell was skipped and that every
    h100_sxm cell was measured, but for the serving cells
    (``chunked_prefill``, ``packed_prefill``) that ``launch/measure.py``
    scores by the cost model, which it names. Returns (plan, {plan key:
    [(tile, s)]}, seconds)."""
    import torch

    from repro_torch.core import Autotuner, compile_plan
    from repro_torch.core.plans import plan_key
    from repro_torch.launch.measure import ANALYTIC_ONLY, make_measure_fn

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

    t0 = time.perf_counter()
    plan = compile_plan(jobs, autotuner=Autotuner(), measure_fn_factory=factory,
                        meta={"generated_by": "chip_smoke.py"})
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    check(plan.meta["skipped_jobs"] == 0,
          f"{plan.meta['skipped_jobs']} plan cells skipped")
    check(len(plan) == len(jobs), f"{len(plan)} entries for {len(jobs)} jobs")
    unmeasured = [e.key for e in plan.entries()
                  if e.hardware == "h100_sxm" and not e.measured
                  and e.kernel not in ANALYTIC_ONLY]
    check(not unmeasured, f"h100_sxm cells not measured: {unmeasured}")
    analytic = sorted(e.key for e in plan.entries()
                      if e.kernel in ANALYTIC_ONLY)
    if analytic:
        log(f"  scored by the cost model (no timer for a serving step): "
            f"{', '.join(analytic)}")
    return plan, timed, compile_s


def measured_cells(jobs, timed):
    """Per cell: the cost model's best tile (the first the sweep timed)
    beside the measured best, with the spread of the timed tiles; one line
    each."""
    from repro_torch.core.plans import plan_key
    from repro_torch.core.tiling import TileShape

    cells = []
    for kernel, problem, dtype, hw in jobs:
        rec = timed.get(plan_key(kernel, problem, dtype, hw.name))
        if rec is None:         # an analytic-only serving cell
            continue
        model_best, model_s = rec[0]
        meas_best, meas_s = min(rec, key=lambda r: r[1])
        spread = max(t for _, t in rec) / meas_s
        cells.append(dict(kernel=kernel, problem=dict(problem), dtype=dtype,
                          model_best=list(model_best),
                          model_best_ms=model_s * 1e3,
                          measured_best=list(meas_best),
                          measured_best_ms=meas_s * 1e3,
                          model_loses=model_s / meas_s,
                          timed=len(rec), spread=spread))
        log(f"  {kernel:16s} {_problem_str(problem):44s} model best "
            f"{TileShape(model_best)} ({model_s * 1e3:.4f} ms), measured best "
            f"{TileShape(meas_best)} ({meas_s * 1e3:.4f} ms), model loses "
            f"{model_s / meas_s:.3f}x, spread {spread:.2f}x over {len(rec)} "
            f"tiles")
    return cells


def _wxh(tile) -> str:
    return f"{tile[1]}x{tile[0]}"


def _problem_str(problem) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(problem.items()))


# ---------------------------------------------------------------------------
# Phase 15: the MoE, encoder-decoder and vision models at full width
# ---------------------------------------------------------------------------

# 15a serves requests of phase 4's prompt lengths (tokens from deepseek's
# own vocabulary); a routing flip between the kernel and the plain path is
# allowed only where the plain k-th and (k+1)-th router probabilities lie
# within FLIP_MARGIN.
PHASE4_LENGTHS = (16, 100, 257, 384, 511, 600)
FLIP_MARGIN = 1e-5
MOE_MAX_LEN = 1024


def _release():
    """Free the models of earlier phases before a large one is made."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"  allocated before: {torch.cuda.memory_allocated() / 1e9:.2f} GB")


def _init_full(cfg):
    import torch

    from repro_torch.models import api

    t0 = time.perf_counter()
    params = api.init_params(cfg, 0, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    n = sum(p.numel() for p in _leaves(params))
    log(f"  initialised {n / 1e9:.3f} B parameters ({cfg.n_layers} layers, "
        f"{n * 4 / 1e9:.1f} GB in float32) in {time.perf_counter() - t0:.1f} s")
    return params, n


def routing_flips(cfg, params, prompt_len: int = 600,
                  max_len: int = MOE_MAX_LEN):
    """:func:`full_width_parity` (one request's prefill logits and four
    decode steps, kernels against plain versions) with every MoE layer's
    routing recorded on both paths: a flip is a token whose top-k expert
    set differs between them. Each flip is printed with the plain k-th /
    (k+1)-th probability margin, which must be within FLIP_MARGIN."""
    import torch

    from repro_torch.models import moe as moe_mod

    calls = []
    route = moe_mod._route

    def spy(p, cfg_, x2d):
        probs, gates, eidx = route(p, cfg_, x2d)
        calls.append((probs, eidx))
        return probs, gates, eidx

    moe_mod._route = spy
    try:
        report = full_width_parity(cfg, params, prompt_len=prompt_len,
                                   max_len=max_len)
    finally:
        moe_mod._route = route
    n_moe = sum(spec.ff == "moe" for spec in cfg.layers())
    k = cfg.moe.top_k
    # The parity runs the kernel prefill, the plain prefill, then each
    # decode step on the kernels and on the plain versions.
    runs = [calls[i:i + n_moe] for i in range(0, len(calls), n_moe)]
    check(len(runs) == 2 * len(report), f"{len(calls)} routings recorded")
    flips, decisions, least = [], 0, float("inf")
    for step in range(len(report)):
        for layer, ((_, ek), (pp, ep)) in enumerate(
                zip(runs[2 * step], runs[2 * step + 1])):
            differ = (torch.sort(ek, -1).values
                      != torch.sort(ep, -1).values).any(-1)
            top = torch.topk(pp, k + 1, dim=-1).values
            margin = (top[:, k - 1] - top[:, k]).float()
            decisions += differ.numel()
            least = min(least, float(margin.min()))
            for t in differ.nonzero().flatten().tolist():
                flips.append(dict(step=step, layer=layer + 1, token=t,
                                  margin=float(margin[t])))
    for f in flips:
        log(f"  routing flip: step {f['step']} layer {f['layer']} token "
            f"{f['token']}, plain k/k+1 margin {f['margin']:.3e}")
    log(f"  routing: {len(flips)} flip(s) in {decisions} token routings "
        f"({n_moe} MoE layers, prefill of {prompt_len} and 4 decode steps); "
        f"smallest plain k/k+1 margin {least:.3e}")
    check(all(f["margin"] <= FLIP_MARGIN for f in flips),
          f"a routing flip with a plain margin above {FLIP_MARGIN:g}")
    return dict(parity=report, flips=flips, routings=decisions,
                min_margin=least)


def deepseek_phase(profile: bool):
    """15a: full-width deepseek-moe-16b (28 layers, 64 routed experts top-6
    and 2 shared; float32, random weights from seed 0) through the captured
    engine at 4 slots, max_len 1024, FIFO: six requests of phase 4's prompt
    lengths, 16 new tokens each, held token by token against the plain
    versions, with matmul and flash_attention launched in the prefills and
    matmul and flash_decode in every replayed decode step
    (:func:`serve_counted`); routing flips (:func:`routing_flips`); 16
    captured decode steps against an eager loop (:func:`graph_parity`);
    prefill device ms at 600 tokens; decode ms a step at 1 and 4 slots;
    peak allocated memory."""
    import torch

    from repro_torch import configs

    cfg = configs.get_arch("deepseek-moe-16b")
    _release()
    params, n_params = _init_full(cfg)
    out = serve_counted(cfg, params, MOE_MAX_LEN, PHASE4_LENGTHS, seed=15,
                          prefill_kernels=("matmul", "flash_attention"),
                          decode_kernels=("matmul", "flash_decode"),
                          label="deepseek")
    eng = out.pop("engine")
    out.update(layers=cfg.n_layers, params_b=n_params / 1e9)
    out["routing"] = routing_flips(cfg, params)
    out["graph_parity"] = graph_parity(cfg, params, label="deepseek",
                                       max_len=MOE_MAX_LEN)
    gen = torch.Generator(device="cuda").manual_seed(5)
    host, groups = _prefill_profile(eng, params, 600, gen)
    busy = sum(groups.values())
    out["prefill_600"] = dict(host_ms=host, device_busy_ms=busy,
                              by_group_ms=groups)
    log(f"  prefill of 600 tokens: host {host:.3f} ms, device busy "
        f"{busy:.3f} ms (" + ", ".join(f"{g} {t:.3f}" for g, t in sorted(
            groups.items(), key=lambda kv: -kv[1])) + ")")
    del eng
    log("  decode wall time a step (deepseek): eager loop vs captured graph")
    out["decode_rates"] = decode_rates(cfg, params, max_len=MOE_MAX_LEN)
    if profile:
        log("  where the time of one full-width deepseek request goes")
        out["profile"] = profile_request(cfg, params, max_len=MOE_MAX_LEN)
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"  torch.cuda.max_memory_allocated: {out['peak_mem_gb']:.2f} GB")
    del params
    return out


def qwen3_moe_reduced_depth():
    """15b: qwen3-moe-235b-a22b at full width (d_model 4096, Hq 64, Hkv 4,
    D 128, 128 experts top-8, renormalised gates, q/k norms) and 4 of its
    94 layers (float32, random weights from seed 0): a 600-token prefill
    and 8 captured decode steps against the plain versions, as phase 7
    holds gemma2."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.serve import ServeEngine

    full = configs.get_arch("qwen3-moe-235b-a22b")
    cfg = dataclasses.replace(full, n_layers=4,
                              layer_pattern=full.layer_pattern[:4]).validate()
    _release()
    params, n_params = _init_full(cfg)
    prompt = np.random.default_rng(17).integers(2, cfg.vocab_size, size=600)
    eng = ServeEngine(cfg, params, max_len=MOE_MAX_LEN, slots=1,
                      device="cuda")
    build.reset_launches()
    t0 = time.perf_counter()
    tokens, steps = graph_logits(eng, prompt, 9)
    dt = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    for name in ("flash_attention", "flash_decode"):
        check(launches[name] > 0, f"qwen3-moe: {name} was never launched")
    del eng
    worst, margin = hold_against_plain(params, cfg, prompt, tokens, steps,
                                       MOE_MAX_LEN, False, "qwen3-moe")
    cut = f"depth cut to {cfg.n_layers} of {full.n_layers} layers"
    log(f"  qwen3-moe-235b-a22b ({cut}): prefill of 600 and {len(steps)} "
        f"captured decode steps in {dt:.3f} s; launches {launches}; logits "
        f"within {worst:.3e} x max |logit| of the plain versions' (tol "
        f"{LOGIT_REL_TOL:g}); smallest top-2 margin {margin:.3e}")
    out = dict(reduced=cut, params_b=n_params / 1e9, tokens=tokens,
               decode_steps=len(steps), launches=launches,
               max_rel_err=worst, min_top2_margin=margin, seconds=dt,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    del params
    return out


def api_held(cfg, params, batch, max_len: int, steps: int, label: str):
    """A prefill and ``steps`` decode steps through ``api`` on the kernels,
    and the same (teacher-forced with the kernel path's tokens) on the
    plain versions: every step's logits within LOGIT_REL_TOL of max |plain
    logit|, every token the plain argmax unless the plain top-2 margin is
    within it. Returns (tokens, worst relative difference, smallest
    margin)."""
    import torch

    from repro_torch.models import api

    v = cfg.vocab_size
    tokens, worst, least = [], 0.0, float("inf")
    with torch.inference_mode():
        lk, sk = api.prefill(params, cfg, batch, max_len=max_len)
        lr, sr = api.prefill(params, cfg, batch, max_len=max_len,
                             impl="reference")
        for i in range(steps + 1):
            a, b = lk[0, :v].float(), lr[0, :v].float()
            check(bool(torch.isfinite(a).all()),
                  f"{label} step {i}: non-finite logits")
            scale = float(b.abs().max())
            tol = LOGIT_REL_TOL * scale
            err = float((a - b).abs().max())
            worst = max(worst, err / scale)
            check(err <= tol, f"{label} step {i}: kernel logits differ from "
                  f"the plain ones by {err:.3e} > {tol:.3e}")
            top2 = torch.topk(b, 2)
            margin = float(top2.values[0] - top2.values[1])
            least = min(least, margin)
            tok = int(a.argmax())
            check(tok == int(top2.indices[0]) or margin <= tol,
                  f"{label} step {i}: token {tok} != plain "
                  f"{int(top2.indices[0])} with margin {margin:.3e}")
            tokens.append(tok)
            if i == steps:
                break
            t = torch.tensor([[tok]], device="cuda")
            lk, sk = api.decode_step(params, cfg, t, sk)
            lr, sr = api.decode_step(params, cfg, t, sr, impl="reference")
    return tokens, worst, least


def whisper_phase():
    """15c: full-width whisper-large-v3 (32 encoder and 32 decoder layers,
    d_model 1280, 20 heads padded to 32, D 64; float32, random weights and
    1500 frame embeddings from seed 0): the encoder output, then a 64-token
    decoder prefill and 16 ``api.decode_step``s (max_len 448, whisper's
    decoder limit), kernels against plain versions; flash_attention and
    flash_decode launches counted."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.models import encdec

    cfg = configs.get_arch("whisper-large-v3")
    _release()
    params, n_params = _init_full(cfg)
    rng = np.random.default_rng(0)
    frames = torch.tensor(rng.standard_normal(
        (1, cfg.encoder.seq_len, cfg.d_model)), dtype=torch.float32,
        device="cuda")
    prompt = rng.integers(2, cfg.vocab_size, size=(1, 64))
    with torch.inference_mode():
        t0 = time.perf_counter()
        enc = encdec.encode(params, cfg, frames)
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
        ref = encdec.encode(params, cfg, frames, impl="reference")
    err = float((enc - ref).abs().max())
    scale = float(ref.abs().max())
    check(bool(torch.isfinite(enc).all()) and err <= LOGIT_REL_TOL * scale,
          f"whisper encoder output differs by {err:.3e} (max {scale:.3f})")
    log(f"  encode of {cfg.encoder.seq_len} frames: {enc_s * 1e3:.1f} ms "
        f"(host clock, first call); output within {err / scale:.3e} x max "
        f"of the plain versions'")
    build.reset_launches()
    t0 = time.perf_counter()
    tokens, worst, margin = api_held(
        cfg, params, {"tokens": prompt, "frames": frames}, 448, 16,
        "whisper")
    dt = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    layers = cfg.n_layers
    # encode + the decoder's self and cross attention, then per step the
    # self (cache) and cross (frames) decodes.
    check(launches["flash_attention"] == cfg.encoder.n_layers + 2 * layers,
          f"whisper: flash_attention launched {launches['flash_attention']}")
    check(launches["flash_decode"] == 16 * 2 * layers,
          f"whisper: flash_decode launched {launches['flash_decode']}")
    log(f"  prefill of 64 tokens and 16 decode steps (kernels and plain) in "
        f"{dt:.3f} s; launches {launches}; logits within {worst:.3e} x max "
        f"|logit| of the plain versions' (tol {LOGIT_REL_TOL:g}); smallest "
        f"top-2 margin {margin:.3e}")
    out = dict(params_b=n_params / 1e9, encoder_rel_err=err / scale,
               tokens=tokens, launches=launches, max_rel_err=worst,
               min_top2_margin=margin, seconds=dt)
    del params
    return out


def internvl_phase():
    """15d: full-width internvl2-1b (24 layers, Hq 14 padded to 16, Hkv 2,
    D 64; float32, random weights and 256 patch embeddings from seed 0):
    ``api.prefill`` of the patches and 64 text tokens, then 16 decode
    steps, kernels against plain versions."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.kernels import build

    cfg = configs.get_arch("internvl2-1b")
    _release()
    params, n_params = _init_full(cfg)
    rng = np.random.default_rng(0)
    patches = torch.tensor(rng.standard_normal(
        (1, cfg.encoder.seq_len, 1024)), dtype=torch.float32, device="cuda")
    prompt = rng.integers(2, cfg.vocab_size, size=(1, 64))
    build.reset_launches()
    t0 = time.perf_counter()
    tokens, worst, margin = api_held(
        cfg, params, {"tokens": prompt, "patch_embeds": patches}, 512, 16,
        "internvl2")
    dt = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    for name in SERVE_KERNELS:
        check(launches[name] > 0, f"internvl2: {name} was never launched")
    log(f"  prefill of {cfg.encoder.seq_len} patches + 64 tokens and 16 "
        f"decode steps (kernels and plain) in {dt:.3f} s; launches "
        f"{launches}; logits within {worst:.3e} x max |logit| of the plain "
        f"versions' (tol {LOGIT_REL_TOL:g}); smallest top-2 margin "
        f"{margin:.3e}")
    out = dict(params_b=n_params / 1e9, tokens=tokens, launches=launches,
               max_rel_err=worst, min_top2_margin=margin, seconds=dt)
    del params
    return out


# ---------------------------------------------------------------------------
# Phase 16: the fleet at full width
# ---------------------------------------------------------------------------

# 16a-b: two prompts of each of phase 4's lengths (phase 4's own six, and
# six more from a seed), 16 new tokens each; the router's watchdog and
# retry budget; and the scripted faults (router step, action, instance): a
# kill of "b" while it decodes with work queued, a join of a fresh engine
# under its name (the injector's kill recovered first, or the router would
# find the new "b" dead too), a stall of "a" while it decodes (its work
# evicted onto the new "b" once the watchdog sees no progress) and the
# recover of "a".
FLEET_NEW_TOKENS, FLEET_WATCHDOG, FLEET_RETRY_BUDGET = 16, 3, 2
FLEET_SCRIPT = ((3, "kill", "b"), (4, "recover", "b"), (4, "join", "b"),
                (8, "stall", "a"), (14, "recover", "a"))
# 16b: a paged engine prefills through chunks, one a step: by step 6 "b"
# holds slots decoding, a finished prefill waiting for a slot and one in
# flight.
PAGED_FLEET_SCRIPT = ((6, "kill", "b"), (7, "recover", "b"),
                      (7, "join", "b"), (11, "stall", "a"),
                      (17, "recover", "a"))
# 16c: the autoscaler's candidates (both the card's own model: a candidate
# named for another GPU would run tiles this card does not have) and its
# policy over a burst of 24 requests.
SCALE_CANDIDATES = ("h100-1", "h100-2")
SCALE_POLICY = dict(min_instances=1, max_instances=3, interval=4, cooldown=1,
                    queue_high=4.0, queue_low=0.0, low_evals=2)


def _allocated(device):
    """Bytes allocated on the card once the cycle collector has run (an
    engine freed by it inside a window would read as negative growth)."""
    import gc

    import torch

    gc.collect()
    if device != "cuda":
        return 0
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def _reserved(device):
    """Bytes the caching allocator holds once its unused blocks are
    returned: the live tensors and the captured graphs' pools."""
    import torch

    if device != "cuda":
        return 0
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


class _FleetClock:
    """The host clock less the time spent measuring between router steps,
    so that a TTFT holds the fleet's own time and not the measurement's."""

    def __init__(self):
        self.paused = 0.0

    def __call__(self) -> float:
        return time.perf_counter() - self.paused


def _fleet_engine(cfg, params, name, device="cuda", **kw):
    """Phase 4's engine (4 slots, MAX_LEN, captured decode) with phase 4b's
    bucket edges, named for the fleet: its captures counted per slot
    (``eng.captures``) and each request's time to first token kept
    (``eng.ttft_s``: from its submit, a recovered request's original one,
    to its token's readback)."""
    import torch

    from repro_torch.serve import (BucketPolicy, ServeEngine,
                                   ShapeBucketScheduler)

    eng = ServeEngine(cfg, params, max_len=MAX_LEN, slots=4,
                      dtype=torch.float32, device=device, instance=name,
                      scheduler=ShapeBucketScheduler(BucketPolicy(
                          PLAN_SERVE_EDGES, max_queue=64)), **kw)
    eng.captures = _count_captures(eng)
    eng.ttft_s = {}
    metrics = eng.metrics
    record = metrics.record_first_token

    def stamp(rid, bucket, t=None):
        now = metrics.clock() if t is None else t
        submit = metrics.submit_time(rid)
        if submit is not None:
            eng.ttft_s[rid] = now - submit
        record(rid, bucket, t=now)

    metrics.record_first_token = stamp
    return eng


def _slot_ptrs(eng):
    return [[t.data_ptr() for c in s.caches for t in c.values()]
            + [s.token.data_ptr(), s.logits.data_ptr(),
               s.next_token.data_ptr()]
            + ([s.table.data_ptr()] if s.table is not None else [])
            for s in eng._slots]


def _fleet_router(cfg, params, names, device, injector=None,
                  autoscaler=None, **kw):
    """A router over ``_fleet_engine`` instances (``kw`` goes to each)."""
    from repro_torch.serve import BucketPolicy, FleetRouter

    return FleetRouter(
        {n: _fleet_engine(cfg, params, n, device, **kw) for n in names},
        BucketPolicy(PLAN_SERVE_EDGES, max_queue=64),
        watchdog_threshold=FLEET_WATCHDOG, retry_budget=FLEET_RETRY_BUDGET,
        injector=injector, autoscaler=autoscaler)


def _hold_results(params, cfg, router, prompts, fids, want, label):
    """Every fid once, none lost, each one's tokens held against the
    fault-free serve's. Returns the streams that differ (at near-ties)."""
    got = router.results()
    check(sorted(got) == sorted(fids), f"{label}: results hold "
          f"{len(got)} of {len(fids)} requests")
    check(router.lost == 0, f"{label}: {router.lost} requests lost")
    return sum(hold_tokens(params, cfg, p, got[f], w, f"{label} fid {f}")
               for f, p, w in zip(fids, prompts, want))


def fleet_faults(cfg, params, prompts, want, paged=False, device="cuda"):
    """16a (16b with ``paged``): two instances "a" and "b" serve the prompts
    through the router under the scripted kill, join, stall and recover.
    Checks: every fid once and none lost, every token held against the
    fault-free serve, "b" killed while it decodes with work queued (paged:
    with a prefill in flight and one waiting for a slot), "a" stalled while
    it decodes; no slot of "a" recaptured and its slot tensors at their
    addresses across both evictions (each engine captures each slot at
    most once); matmul, flash_attention and flash_decode launched after
    the kill; the join replaces the dead engine's memory (after it and
    after the run, the allocated bytes above the pre-kill level stay under
    half of one engine's)."""
    from repro_torch.kernels import build
    from repro_torch.serve import FaultEvent, FaultInjector, FaultScript

    label = "16b paged fleet" if paged else "16a fleet"
    script = PAGED_FLEET_SCRIPT if paged else FLEET_SCRIPT
    steps = {(action, name): step for step, action, name in script}
    kill_step, join_step = steps["kill", "b"], steps["join", "b"]
    stall_step, recover_step = steps["stall", "a"], steps["recover", "a"]

    clock = _FleetClock()

    def joiner():
        return _fleet_engine(cfg, params, "b", device, paged=paged,
                             clock=clock)

    injector = FaultInjector(FaultScript([
        FaultEvent(step, action, name,
                   make_engine=joiner if action == "join" else None)
        for step, action, name in script]))
    mem, reserved = {}, {}

    def measure(key):
        t0 = time.perf_counter()
        mem[key], reserved[key] = _allocated(device), _reserved(device)
        clock.paused += time.perf_counter() - t0

    measure("before")
    router = _fleet_router(cfg, params, ("a", "b"), device, paged=paged,
                           injector=injector, clock=clock)
    a = router.engines["a"]
    ptrs = _slot_ptrs(a)
    fids = [router.route(p, max_new_tokens=FLEET_NEW_TOKENS).fid
            for p in prompts]
    fleet_s, states = 0.0, {}
    for step in range(1, 1000):
        if step == kill_step:
            b = router.engines["b"]
            states["b at the kill"] = dict(
                decoding=sum(r is not None for r in b._active),
                prefilling=len(b._chunking), ready=len(b._ready),
                queued=b.scheduler.pending() + len(b._pool_wait))
            del b
            measure("pre_kill")
        if step == stall_step:
            states["a at the stall"] = dict(
                decoding=sum(r is not None for r in a._active),
                queued=a.scheduler.pending())
        t0 = time.perf_counter()
        pending = router.step_all()
        fleet_s += time.perf_counter() - t0
        if step == kill_step:
            check(router.status["b"] == "dead", f"{label}: b not dead")
            measure("after_kill")
            at_kill = dict(build.LAUNCHES)
        if step == join_step:
            check(router.status["b"] == "live", f"{label}: b not joined")
            measure("after_join")
        if step == recover_step:
            check(router.status["a"] == "live", f"{label}: a not live "
                  f"after its recover ({router.status['a']})")
        if not pending and not router.pending():
            break
    launches = {k: n - at_kill[k] for k, n in build.LAUNCHES.items()}
    measure("end")
    kill, stall = states["b at the kill"], states["a at the stall"]
    check(kill["decoding"] > 0 and kill["queued"] + kill["ready"]
          + kill["prefilling"] > 0, f"{label}: b at the kill {kill}")
    if paged:
        check(kill["prefilling"] > 0 and kill["ready"] > 0,
              f"{label}: b at the kill {kill}")
    check(stall["decoding"] > 0, f"{label}: a at the stall {stall}")
    fleet = router.metrics()["fleet"]
    check(fleet["recoveries"] > 0, f"{label}: nothing recovered")
    differ = _hold_results(params, cfg, router, prompts, fids, want, label)
    b = router.engines["b"]
    if device == "cuda":         # the CPU runs the step eagerly
        check(a.captures == [1] * a.slots,
              f"{label}: captures per slot of a {a.captures}")
        check(all(n <= 1 for n in b.captures),
              f"{label}: captures per slot of the new b {b.captures}")
    check(_slot_ptrs(a) == ptrs, f"{label}: a slot tensor of a moved")
    for name in SERVE_KERNELS:
        check(device != "cuda" or launches[name] > 0,
              f"{label}: {name} never launched after the kill")
    if paged:
        for name, eng in router.engines.items():
            _check_pool(eng, f"{label} {name}")
    recovered, others = [], []
    for fid, fr in router._fleet.items():
        ttft = router.engines[fr.instance].ttft_s[fr.rid]
        (recovered if fr.retries else others).append(ttft * 1e3)
    engine_bytes = (mem["pre_kill"] - mem["before"]) / 2
    growth = max(mem["after_join"], mem["end"]) - mem["pre_kill"]
    if device == "cuda":
        check(growth < engine_bytes / 2, f"{label}: {growth / 2**20:.1f} MiB"
              f" above the pre-kill level after the join (one engine: "
              f"{engine_bytes / 2**20:.1f} MiB)")
    out = dict(fleet=fleet, states=states, launches_after_kill=launches,
               captures={n: e.captures for n, e in router.engines.items()},
               ttft_recovered_ms=sorted(recovered),
               ttft_others_ms=sorted(others), fleet_s=fleet_s,
               memory=mem, reserved=reserved, engine_bytes=engine_bytes,
               differ=differ,
               statuses=dict(router.status))
    log(f"  {label}: {len(fids)} requests, {fleet['recoveries']} "
        f"recoveries, {fleet['steals']} steals, {fleet['lost']} lost, "
        f"{fleet['tokens_discarded']} tokens discarded, "
        f"{fleet['instance_steps']} instance steps; b at the kill {kill}, "
        f"a at the stall {stall}; {differ} token streams differ from the "
        f"fault-free serve's (near-ties)")
    log(f"  {label}: captures per slot {out['captures']}; launches after "
        f"the kill { {k: launches[k] for k in SERVE_KERNELS} }")
    log(f"  {label}: TTFT of the {len(recovered)} recovered requests "
        f"{_stats_ms(recovered)}, of the other {len(others)} "
        f"{_stats_ms(others)} (submit-anchored, host clock less the memory "
        f"readings); fleet {fleet_s:.3f} s of steps")
    log(f"  {label}: allocated {mem['before'] / 2**20:.1f} MiB before the "
        f"fleet, {mem['pre_kill'] / 2**20:.1f} before the kill, "
        f"{mem['after_kill'] / 2**20:.1f} after it, "
        f"{mem['after_join'] / 2**20:.1f} after the join, "
        f"{mem['end'] / 2**20:.1f} at the end (one engine "
        f"{engine_bytes / 2**20:.1f}); reserved (graph pools included) "
        f"{', '.join(f'{k} {v / 2**20:.1f}' for k, v in reserved.items())}"
        f" MiB")
    return out


def _stats_ms(xs) -> str:
    if not xs:
        return "none"
    return (f"median {statistics.median(xs):.1f} ms, max {max(xs):.1f} ms")


def fleet_cancel_donor(cfg, params, device="cuda"):
    """16b: one paged engine at page 64 (FIFO): a 768-token donor decodes,
    a request of its 768 tokens and 32 more maps its pages, and the donor
    is cancelled while that one decodes. The recipient's tokens equal a run
    without the donor; the pool balances (allocs = frees)."""
    import numpy as np

    from repro_torch.serve import ServeEngine

    rng = np.random.default_rng(16)
    donor = rng.integers(2, cfg.vocab_size, size=PREFIX_DONOR)
    recipient = np.concatenate([donor, rng.integers(2, cfg.vocab_size,
                                                    size=PREFIX_TAIL)])

    def run(with_donor):
        import torch

        eng = ServeEngine(cfg, params, max_len=MAX_LEN, slots=4,
                          dtype=torch.float32, device=device, paged=True,
                          page_size=PREFIX_PAGE)
        if with_donor:
            d = eng.add_request(donor, max_new_tokens=FLEET_NEW_TOKENS)
            eng.step()                   # the donor prefills, registers
            eng.step()                   # and decodes
        r = eng.add_request(recipient, max_new_tokens=FLEET_NEW_TOKENS)
        while not any(q is not None and q.rid == r for q in eng._active):
            eng.step()
        eng.step()                       # the recipient decodes
        if with_donor:
            check(eng.cancel(d) is not None, "16b: the donor was not here")
        done = {q.rid: q.out_tokens for q in eng.run_until_done()}
        check(r in done and (not with_donor or d not in done),
              f"16b: finished {sorted(done)}")
        return done[r], _check_pool(eng, f"16b donor={with_donor}")

    got, pool = run(True)
    want, _ = run(False)
    check(pool["prefix_hits"] >= 1, "16b: the recipient mapped no prefix")
    differ = hold_tokens(params, cfg, recipient, got, want,
                         "16b recipient of a cancelled donor")
    log(f"  16b cancel: a {PREFIX_DONOR}-token donor cancelled under its "
        f"recipient ({pool['prefix_tokens_reused']} tokens reused, page "
        f"{PREFIX_PAGE}): tokens {'differ at a near-tie' if differ else 'equal'}"
        f" to a run without the donor; pool {pool['page_allocs']} allocs "
        f"= {pool['page_frees']} frees")
    return dict(pool=pool, differ=differ)


def fleet_autoscale(cfg, params, prompts, want, device="cuda"):
    """16c: one instance and a burst of the prompts twice over (24
    requests); the autoscaler joins from SCALE_CANDIDATES while the queue
    is deep and, once idle, drains back. Checks: at least one join and
    one drain, nothing lost, every token held. Prints the decisions, and
    the host ms of the step that builds a joiner and of the step in which
    it first captures."""
    from repro_torch.serve import AutoscalePolicy, ScaleCandidate

    def make_engine(name):
        return _fleet_engine(cfg, params, name, device)

    scaler = AutoscalePolicy(
        tuple(ScaleCandidate(name=c, hardware="h100_sxm",
                             make_engine=make_engine)
              for c in SCALE_CANDIDATES), **SCALE_POLICY)
    router = _fleet_router(cfg, params, ("h100-0",), device,
                           autoscaler=scaler)
    burst = list(prompts) * 2
    fids = [router.route(p, max_new_tokens=FLEET_NEW_TOKENS).fid
            for p in burst]
    step_ms, built, first_capture = [], {}, {}
    for step in range(1, 2000):
        known = set(router.engines)
        t0 = time.perf_counter()
        pending = router.step_all()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        for name in set(router.engines) - known:
            built[name] = step
        for name in built:
            if name not in first_capture and sum(
                    router.engines[name].captures):
                first_capture[name] = step
        idle = not pending and not router.pending()
        if idle and any(d.action == "drain" for d in scaler.decisions):
            break
    actions = [d.action for d in scaler.decisions]
    check("join" in actions and "drain" in actions,
          f"16c: decisions {actions}")
    differ = _hold_results(params, cfg, router, burst, fids, list(want) * 2,
                           "16c autoscale")
    log(f"  16c autoscale: {len(burst)} requests, decisions:")
    for d in scaler.decisions:
        log(f"    step {d.step}: {d.action} {d.instance} ({d.reason}; queue "
            f"{d.signals['queue_depth']}, instances {d.signals['instances']})")
    for name, step in sorted(built.items()):
        cap = first_capture.get(name)
        log(f"  16c: {name} built in step {step} ({step_ms[step - 1]:.1f} ms "
            f"on the host clock), first captured in step {cap} "
            f"({step_ms[cap - 1]:.1f} ms)" if cap else
            f"  16c: {name} built in step {step} ({step_ms[step - 1]:.1f} "
            f"ms), never captured")
    med = statistics.median(step_ms)
    log(f"  16c: {len(step_ms)} steps, median {med:.1f} ms; "
        f"{router.metrics()['fleet']['instance_steps']} instance steps; "
        f"final fleet {router.live_instances()}; {differ} token streams "
        f"differ (near-ties)")
    return dict(decisions=[d.as_dict() for d in scaler.decisions],
                built=built, first_capture=first_capture,
                build_ms={n: step_ms[s - 1] for n, s in built.items()},
                capture_ms={n: step_ms[s - 1]
                            for n, s in first_capture.items()},
                median_step_ms=med, fleet=router.metrics()["fleet"],
                differ=differ)


def fleet_rollout(cfg, params, prompts, want, plan, refined, device="cuda"):
    """16d: two instances on phase 14b's cost-model plan; ``roll_plans``
    rolls 14b's refined artifact across them, each behind the p95-TTFT
    guard of a probe that serves the prompts (phase 4's six) on that
    instance. Then one more probe each. Checks: every probe's tokens held
    against the fault-free serve, and each slot captured once at first and
    once more for every ``set_plans`` (the swap, and a rollback's)."""
    from repro_torch.core import H100_SXM

    router = _fleet_router(cfg, params, ("a", "b"), device, plans=plan,
                           hardware=H100_SXM)
    swaps = {name: 0 for name in router.engines}
    differ = 0

    def count_swaps(name, eng):
        real = eng.set_plans

        def set_plans(p):
            swaps[name] += 1
            real(p)
        eng.set_plans = set_plans

    def probe(name):
        nonlocal differ
        eng = router.engines[name]
        rids = [eng.add_request(p, max_new_tokens=FLEET_NEW_TOKENS)
                for p in prompts]
        done = {r.rid: r.out_tokens for r in eng.run_until_done()}
        differ += sum(hold_tokens(params, cfg, p, done[r], w,
                                  f"16d probe on {name}")
                      for p, r, w in zip(prompts, rids, want))

    for name, eng in router.engines.items():
        count_swaps(name, eng)
    decisions = router.roll_plans(refined, drive_fn=probe)
    for name in sorted(router.engines):
        probe(name)
        eng = router.engines[name]
        check(device != "cuda" or eng.captures == [1 + swaps[name]] * eng.slots,
              f"16d: {name} captures per slot {eng.captures} after "
              f"{swaps[name]} set_plans")
    for d in decisions:
        log(f"  16d roll {d.instance}: p95 TTFT {d.pre_p95 * 1e3:.1f} -> "
            f"{d.post_p95 * 1e3:.1f} ms, rolled_back={d.rolled_back}, "
            f"clipped={d.clipped}; set_plans {swaps[d.instance]}x, captures "
            f"per slot {router.engines[d.instance].captures}")
    return dict(decisions=[dict(instance=d.instance, pre_p95=d.pre_p95,
                                post_p95=d.post_p95,
                                rolled_back=d.rolled_back, clipped=d.clipped)
                           for d in decisions], swaps=swaps, differ=differ)


def fleet_phase(phase4, refine):
    """Phase 16: full-width qwen2-1.5b (28 layers, float32, random weights
    from seed 0), one set of weights shared by every instance: 16a-d."""
    from repro_torch import configs

    cfg = configs.get_arch("qwen2-1.5b")
    params, _ = _init_full(cfg)
    out = fleet_checks(cfg, params, phase4, refine)
    del params
    _allocated("cuda")
    return out


def fleet_checks(cfg, params, phase4, refine, device="cuda"):
    """A fault-free serve of the 12 prompts on one engine, then 16a-d."""
    import numpy as np

    from repro_torch.core import TilePlan

    rng = np.random.default_rng(16)
    prompts = ([np.asarray(p) for p in phase4["prompts"]]
               + [rng.integers(2, cfg.vocab_size, size=n)
                  for n in phase4["prompt_lengths"]])
    solo = _fleet_engine(cfg, params, "solo", device)
    t0 = time.perf_counter()
    rids = [solo.add_request(p, max_new_tokens=FLEET_NEW_TOKENS)
            for p in prompts]
    done = {r.rid: r.out_tokens for r in solo.run_until_done()}
    solo_s = time.perf_counter() - t0
    check(sorted(done) == sorted(rids), "16: the fault-free serve")
    want = [done[r] for r in rids]
    del solo
    log(f"  fault-free serve of {len(prompts)} requests on one engine: "
        f"{solo_s:.3f} s")
    out = dict(fault_free_s=solo_s)
    out["faults"] = fleet_faults(cfg, params, prompts, want, device=device)
    out["paged"] = fleet_faults(cfg, params, prompts, want, paged=True,
                                device=device)
    out["cancel_donor"] = fleet_cancel_donor(cfg, params, device)
    out["autoscale"] = fleet_autoscale(cfg, params, prompts, want, device)
    out["rollout"] = fleet_rollout(
        cfg, params, prompts[:6], want[:6], TilePlan.load(refine["plan_path"]),
        TilePlan.load(refine["refined_path"]), device)
    return out


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
# The path whose launches each kernel's count is read from: the
# deepseek-moe-16b serve (phase 15a; the qwen2 serve of phase 4 beside it),
# the plan compile (phase 9; ssd and rglru are also checked there) and the
# mamba2 and recurrentgemma serves (phases 10 and 11).
SERVE_KERNELS = ("matmul", "flash_attention", "flash_decode")
PLAN_KERNELS = ("bilinear", "ssd", "rglru")
# Phases 10 and 11: ragged lengths and a chunk multiple, six requests on
# four slots (a slot serves a second); and recurrentgemma's 2048-slot
# rings wrapped at prefill (2100) and while decoding (2040).
MAMBA2_LENGTHS = (16, 64, 100, 257, 600, 1000)
RECURRENTGEMMA_LENGTHS = (2100, 2040, 64, 500)


def kernels_line(rows, launches, by_path=None):
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
        if by_path and name in by_path:
            out[-1]["launches_by_path"] = by_path[name]
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
            log("== decode wall time a step: eager loop vs captured graph")
            result["decode_rates"] = decode_rates(cfg, params)
            phase_done("serve", t_phase)

            # 4b. The same serve with tile plans.
            log("== plan serve: phase 4's requests with a wall-clock h100_sxm"
                " plan (bucketed and FIFO)")
            t0 = time.perf_counter()
            result["plan_serve"] = plan_serve(cfg, params, result["serve"])
            phase_done("plan-serve", t0)

            # 5. Full-width parity, kernels vs plain versions.
            log("== full-width parity: kernels vs plain versions")
            t0 = time.perf_counter()
            result["parity"] = full_width_parity(cfg, params)
            result["graph_parity"] = graph_parity(cfg, params)
            if args.profile:
                log("== where the time of one full-width request goes")
                result["profile"] = profile_request(cfg, params)
            phase_done("parity", t0)

            # 12a-b. Chunked and packed serving (12c-d ride phases 6, 10
            # and 11, where their models are loaded).
            log("== 12: chunked and packed serving, full-width qwen2-1.5b "
                "(28 layers, float32)")
            t0 = time.perf_counter()
            result["chunked_serve"] = chunked_serve(
                cfg, params, result["serve"]["prompts"])
            log("== 12b: a 16-token request behind a 1000-token one")
            result["short_behind_long"] = short_behind_long(cfg, params)
            phase_done("chunked", t0)

            # 14a-b. Tracing and shadow refinement (14c, the examples,
            # after phase 11).
            log("== 14a: request tracing on the card, phase 4's requests "
                "(tracer off, on, on, off)")
            t0 = time.perf_counter()
            result["trace_serve"] = trace_serve(cfg, params, result["serve"])
            log("== 14b: shadow refinement on the card: a cost-model plan, "
                "a quarter of the steps timing its cells")
            result["refine_serve"] = refine_serve(cfg, params,
                                                  result["serve"])
            phase_done("trace-refine", t0)

            # 13. Paged serving (13c loads its own model).
            log("== 13: paged serving, full-width qwen2-1.5b (28 layers, "
                "float32), the default page, against the unpaged engine")
            t0 = time.perf_counter()
            result["paged_serve"] = paged_serve(
                cfg, params, result["serve"]["prompts"])
            log(f"== 13b: shared prefixes and copy-on-write (page "
                f"{PREFIX_PAGE})")
            result["prefix_sharing"] = prefix_sharing(cfg, params)
            log("== 13d: the captured decode step, paged vs unpaged")
            result["paged_decode"] = paged_decode_step(cfg, params,
                                                       args.profile)
            del params
            torch.cuda.empty_cache()
            log("== 13c: h2o-danube-1.8b at full width, 4 layers, paged "
                "(windowed decode over the linear view) vs rings")
            result["paged_windowed"] = paged_windowed()
            torch.cuda.empty_cache()
            phase_done("paged", t0)

            # 6. Full-width h2o-danube-1.8b on ring caches.
            log("== serve full-width h2o-danube-1.8b (24 layers, float32, "
                "4096-slot rings)")
            t0 = time.perf_counter()
            result["h2o_danube"] = serve_h2o_danube()
            torch.cuda.empty_cache()
            phase_done("h2o-danube", t0)

            # 7. gemma2-9b at full width, reduced depth.
            log("== gemma2-9b at full width, 4 layers: prefill and captured "
                "decode on a ring")
            t0 = time.perf_counter()
            result["gemma2"] = gemma2_reduced_depth()
            torch.cuda.empty_cache()
            phase_done("gemma2", t0)

            # 8. The launcher.
            log("== launcher (smoke configs) on the card")
            t0 = time.perf_counter()
            run_launcher()
            phase_done("launcher", t0)

            # 9. Tile plans on the card.
            log("== tile plans on the card (wall-clock compile)")
            t0 = time.perf_counter()
            result["plans"] = plan_phase(ROOT / "build")
            phase_done("plans", t0)
            for name in PLAN_KERNELS:
                check(result["plans"]["launches"].get(name, 0) > 0,
                      f"kernel {name} was never launched by the plan compile")

            # 10. Full-width mamba2-2.7b.
            log("== serve full-width mamba2-2.7b (64 layers, float32; SSD "
                "states)")
            t0 = time.perf_counter()
            result["mamba2"] = recurrent_phase(
                "mamba2-2.7b", 1024, MAMBA2_LENGTHS, seed=7,
                prefill_kernels=("ssd",), decode_kernels=("ssd",),
                profile=args.profile, chunking=(1000, 256))
            phase_done("mamba2", t0)

            # 11. Full-width recurrentgemma-9b.
            log("== serve full-width recurrentgemma-9b (38 layers, float32; "
                "RG-LRU states, 2048-slot rings)")
            t0 = time.perf_counter()
            result["recurrentgemma"] = recurrent_phase(
                "recurrentgemma-9b", 2304, RECURRENTGEMMA_LENGTHS, seed=8,
                prefill_kernels=("matmul", "flash_attention", "rglru"),
                decode_kernels=("matmul", "flash_decode", "rglru"),
                profile=args.profile, chunking=(2100, 512))
            phase_done("recurrentgemma", t0)

            # 14c. The paper's examples.
            log("== 14c: the paper's examples on the card")
            t0 = time.perf_counter()
            result["examples"] = run_examples()
            phase_done("examples", t0)

            # 16. The fleet (before phase 15, whose 15a needs the card's
            # memory to itself).
            log("== 16: the fleet, full-width qwen2-1.5b (28 layers, "
                "float32): two instances on one set of weights, killed, "
                "stalled, joined, autoscaled and rolled onto 14b's plan")
            t0 = time.perf_counter()
            build.reset_launches()
            result["fleet"] = fleet_phase(result["serve"],
                                          result["refine_serve"])
            result["fleet"]["launches"] = dict(build.LAUNCHES)
            log(f"  launches over phase 16: "
                f"{ {k: build.LAUNCHES[k] for k in SERVE_KERNELS} }")
            phase_done("16 fleet", t0)

            # 15. The MoE, encoder-decoder and vision models.
            log("== 15a: serve full-width deepseek-moe-16b (28 layers, 64 "
                "routed experts top-6 + 2 shared, float32)")
            t0 = time.perf_counter()
            result["deepseek"] = deepseek_phase(args.profile)
            phase_done("15a deepseek", t0)
            log("== 15b: qwen3-moe-235b-a22b at full width, 4 layers: prefill "
                "and captured decode")
            t0 = time.perf_counter()
            result["qwen3_moe"] = qwen3_moe_reduced_depth()
            phase_done("15b qwen3-moe", t0)
            log("== 15c: whisper-large-v3 at full width through the model "
                "API")
            t0 = time.perf_counter()
            result["whisper"] = whisper_phase()
            phase_done("15c whisper", t0)
            log("== 15d: internvl2-1b at full width through the model API")
            t0 = time.perf_counter()
            result["internvl2"] = internvl_phase()
            phase_done("15d internvl2", t0)

            check("jax" not in sys.modules, "jax was imported")
            check(not any(m == "repro" or m.startswith("repro.")
                          for m in sys.modules), "the JAX package was imported")
            # The serving kernels' launches on this slice's path (phase
            # 15a), each beside its count on phase 4's qwen2 serve.
            launches = {name: result["deepseek"]["launches"][name]
                        for name in SERVE_KERNELS}
            launches["bilinear"] = result["plans"]["launches"]["bilinear"]
            launches["ssd"] = result["mamba2"]["launches"]["ssd"]
            launches["rglru"] = result["recurrentgemma"]["launches"]["rglru"]
            by_path = {name: {"qwen2 serve (phase 4)":
                              result["serve"]["launches"][name],
                              "deepseek-moe-16b serve (phase 15a)":
                              launches[name]} for name in SERVE_KERNELS}
            line = kernels_line(rows, launches, by_path)
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
