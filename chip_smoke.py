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
10. serve full-width mamba2-2.7b (8 of its 64 layers, float32, random
   weights from seed 0; SSD states) through the captured engine at 4 slots and max_len
   1024: six requests of 16, 64, 100, 257, 600 and 1000 prompt tokens (a
   slot serves a second request), 16 new tokens each, held token by token
   against the plain versions; ssd must launch in the prefills and in the
   replayed decode steps (as many times as steps times its launches a
   step); one request's prefill logits and four decode steps against the
   plain versions; prefill device ms at 600 and 1000 tokens; decode ms a
   step at 1 and 4 slots, eager beside captured;
11. the same for full-width recurrentgemma-9b (11 of its 38 layers:
   RG-LRU states, GeGLU FF, local attention at head_dim 256, three of the
   (rglru, rglru, local_attn) units and two rglru layers) at max_len 2304,
   so
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

17. training (last, after phase 15's models are released): (a) gradients
   through the matmul and flash-attention wrappers' autograd Functions
   against the plain versions' on the same inputs, float32 and bf16 —
   the matmul at full-width qwen2-1.5b's train FF (M = 4096 = 8 x 512, K
   1536 / N 8960 and K 8960 / N 1536, so dB is a K = 4096 product) and an
   unaligned plain-regime shape, three launches each (the forward, dA and
   dB); flash_attention causal at S 512, D 128, 16 / 2 heads, windowed,
   with softcap, at D 80, and whisper's non-causal 64 x 1500 at D 64, one
   launch and one plain backward each — then the step's four GEMM shapes,
   the attention forward at batch 8 and its plain backward (beside SDPA's)
   timed; (b) full-width qwen2-1.5b (float32, seed 0), one batch of 8 x
   512 tokens from the data pipeline: ``api.train_loss`` and backward
   through the kernels against ``impl="reference"``, the loss within 1e-5,
   every parameter's gradient set, non-zero and within 1e-3 of its leaf's
   max, and one step's launches (336 matmul: 3 forward, 3 recomputed and 6
   backward a layer; 56 flash_attention; 28 plain attention backwards);
   (c) five ``make_train_step`` steps (AdamW, warmup-cosine): the losses
   finite and falling, host ms a step, tokens/s, peak allocated bytes and
   model FLOP/s (6 N tokens) against float32's 67 TFLOP/s, with
   ``--profile`` a sixth step's device ms by group and idle share; (d)
   ``Trainer.run`` on the 100M example config (40 steps of 8 x 256,
   checkpoints every 20 in a temporary directory, removed after): the loss
   falls by more than 1.0, a failure at step 25 restores step 20 and ends
   at the uninterrupted run's loss, bit for bit, and the launcher
   ``python -m repro_torch.launch.train --steps 20 --checkpoint-every 10
   --fail-at 12`` exits 0 with one restart; (e) the recurrent mixers under
   training: (a) the ssd and rglru gradients through their autograd
   Functions (backwards on the kernels: the forward kernels reversed, read
   in place, with d log_a's dot products in their output launch, and one
   ``repro_ssd_bwd`` launch for dB and dC) against autograd of the plain
   scans, at mamba2-2.7b's width (S 4096, H 80, P 64, N 128, chunk 64) and
   recurrentgemma-9b's (S 4096, F 4096) and at a ragged S 4001, float32
   and bf16, one forward and one backward counted each; each backward
   timed beside the plain version's, its bound and its earlier time (the
   ssd's also at mamba2's train shape, B 8, S 512), the ssd backward's
   calls each timed alone (they must add up to the whole within 10%) and
   its launches named by the profiler in a fresh process (each ssd kernel
   of the design once a call, no flip, no copy but bf16's dtype casts); (b)
   full-width mamba2-2.7b (64 layers, float32, seed 0), one batch of 8 x
   512: ``api.train_loss`` and backward through the kernels against
   ``impl="reference"``, the loss and every leaf within 1e-4 of max(1,
   max |plain|), every leaf non-zero, 128 ssd and 64 ssd_bwd launches;
   (c) five ``make_train_step`` steps of it: losses falling, host ms a
   step, tokens/s, peak allocated bytes, with ``--profile`` a sixth step's
   device ms by group (einsum products, ssd forward, ssd backward, head
   and loss, AdamW, other); (d) recurrentgemma-9b at full width and 2 of
   its (rglru, rglru, local_attn) units (6 of 38 layers, 2.36 B
   parameters): the same check and three steps; then the train launcher
   at both models' smoke configs, 20 steps with a failure at step 12,
   each scan's forward and backward launched.

18. the mesh runtime (last; ``torch.distributed``, one process a rank):
   (a) ``Trainer(mesh=make_local_mesh(1, 1))`` over a one-rank NCCL group
   (NCCL cannot put two ranks on one card) against the mesh-less Trainer:
   full-width qwen2-1.5b at 2 of its 28 layers (a 28-layer Trainer's
   final checkpoint is 19 GB, two of them more than one call may write),
   3 steps of 8 x 512, losses and final parameters bit for bit; (b) ranks
   on cuda:0 over gloo (its all-gather, reduce-scatter and point-to-point
   copied through pinned host memory), each on its blocks
   (``api.rank_shardings``: attention heads, FF columns, experts
   and vocabulary over the model axis; the train step's under FSDP also
   every leaf's data block, the serving checks with ``fsdp=False``), each
   check against the one-process path of the same ranks: four ranks — the
   sequence-sharded decode of
   full-width qwen2-1.5b at 2 of its 28 layers on a 1 x 4 mesh (4 query
   heads a rank, gathered for the sharded body; 2 KV heads < 4: each rank
   a 256-row slice of the 1024-row cache of both), and the same model
   served tensor-parallel on 2 x 2 (a KV head a rank); each a 511-token
   prefill and 8 greedy steps: tokens equal, logits within 1e-3 of max
   |logit|, each rank launching matmul, flash_attention and flash_decode
   as often as the one-process path, a rank's parameter bytes at most
   0.51 (2 model ranks) and 0.27 (4) of the whole, the collectives' ms a
   step; the expert-parallel MoE of full-width deepseek-moe-16b at 3
   layers on 2 x 2 (16 of 64 experts a rank and its half of the shared
   experts, 4 x 64 tokens, capacity factor 32: logits within 2e-3), a
   2 x 2 train step of qwen2-1.5b at 2 layers on the model split alone
   (one step: its loss within 1e-6 and its clip norm within 1e-5 of the
   FSDP step's first, a rank holding at most 0.51 of the parameter bytes),
   then two FSDP steps of the same (8 x 256, 2 microbatches; each layer
   gathered over the data group as it runs and again in the recompute,
   its gradients reduce-scattered: losses within 1e-6 relative, gradients
   gathered whole within 1e-5 of each leaf's max and the first clip norm
   within 1e-5 relative, gathered parameters within 2 x lr, a rank holding
   at most 0.26 of the parameter bytes and launching each kernel as often
   as the one process) and the trained FSDP blocks saved; the recurrent
   mixers on their blocks: mamba2-2.7b at 2 layers served as qwen2 is
   (its SSD heads split, B and C whole) and one FSDP train step (8 x 256,
   2 microbatches; each leaf within 1e-5 of one process, or, where one
   process summing as the batch ranks do moves the leaf further, within
   twice that move), recurrentgemma-9b at 3 layers (one unit) served on
   2 x 2 (its RG-LRU features split), each rank launching ssd / rglru as
   often as one process and holding at most 0.51 of the bytes; two ranks —
   the restore onto 1 x 2 (blocks exact, each rank holding only its own)
   and one more tensor-parallel step, GPipe over two stages (loss within
   2e-4, gradients within 1e-4 of the sequential ones), ``compress_psum``
   over 20 rounds, FSDP's gather and reduce-scatter in float64 (the
   gather exact, its gradient the reduce-scatter of the ranks'
   cotangents); each check's wall ms and each rank's peak allocated
   bytes. The four ranks on one card measure correctness, not multi-GPU
   speed. Phase 3 holds flash_decode's log-sum-exp output
   (``return_lse``) against its plain version at the headline shape and at
   phase 18's slices, and times the headline call with and without it;
   it times the three serving kernels at a tensor-parallel rank's shapes,
   and ssd (40 and 5 heads) and rglru (2048 and 256 features) forward
   and backward at S 4096.

19. the dry run (last): (a) ``python -m repro_torch.launch.dryrun --arch
   qwen2-1.5b --single-pod --force`` on the host — a count of rank 0's
   step of each single-pod shape on ``meta`` tensors under a fake 256-rank
   group, started before phase 17 beside the card's work and collected
   here — its reference-style lines printed; (b) the count against the
   card: a bf16 train step of full-width qwen2-1.5b (28 layers, 8 x 512,
   AdamW with bf16 moments, remat) and an eager bf16 decode step (4 rows,
   a 1024-position cache), each counted on a 1 x 1 mesh, then run three
   times on the card: the counted launches equal one real step's
   ``build.LAUNCHES`` delta, kernel by kernel; the counted peak lies within
   10% of ``torch.cuda.max_memory_allocated`` over the step (from
   ``reset_peak_memory_stats``, less what was allocated before the step's
   tensors were made); the median step time is at least the roofline's
   ``total_s``; the train step's losses are finite. Measured / ``total_s``
   is printed for each. (c) 18b's FSDP train step counted as rank 0 of a
   fake 2 x 2 group (its all-gathers and reduce-scatters among the
   collectives): launches equal rank 0's, peak within 10% of it.

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
on lines before the kernels line; the matmul and flash_attention lines
also give their counts over one train step of phase 17c, the ssd and rglru
lines under ``launches_by_path["train"]`` the forward and backward calls
of one train step of phase 17e (c) and (d)); phase 4b reads its own counts over its two plan serves and fails
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
import math
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


def mm_flops(m, n, k):
    from repro_torch.kernels.matmul.ops import flops

    return flops(m, n, k)


def decode_flops(b, hq, d, seen):
    from repro_torch.kernels.flash_attention.decode import flops

    return flops(b, hq, d, seen)


def bilinear_flops(out_h, out_w):
    from repro_torch.kernels.bilinear.ops import flops

    return flops(out_h, out_w)


def rglru_flops(b, s, f):
    from repro_torch.kernels.rglru.ops import flops

    return flops(b, s, f)


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
                    t_b, by = bound(nb, mm_flops(m, n, k), dname)
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
                t_b, by = bound(nb, decode_flops(1, HQ, HEAD_DIM, seen), dname)
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
    decode_lse_checks(record, randn, dtypes, quick)
    head_dim_256_checks(record, randn, dtypes, quick)
    head_dim_80_checks(record, randn, dtypes, quick)
    moe_slice_checks(record, randn, dtypes, quick)
    tp_slice_checks(record, randn, dtypes, quick)
    bilinear_checks(record, randn, dtypes, quick)
    ssd_checks(record, dtypes, quick)
    rglru_checks(record, dtypes, quick)
    scan_tp_checks(record, dtypes, quick)
    bad = [r for r in rows if not r["ok"]]
    check(not bad, f"{len(bad)} kernel check(s) disagree with the plain "
                   f"version: {[(r['kernel'], r['case'], r['dtype']) for r in bad]}")
    return rows


def decode_lse_checks(record, randn, dtypes, quick: bool):
    """flash_decode's log-sum-exp output (``return_lse``) against its plain
    version's: at the headline shape (qwen2-1.5b's 16 / 2 heads, D 128, S
    1024, pos 511) and at phase 18's sequence slices (S / 4 = 256 rows at
    their ``kv_pos`` offsets: the slice holding pos, one before it and one
    wholly after it, whose LSE is NEG_INF's); the output beside it must be
    the one without the LSE, bit for bit. In float32 the headline call is
    timed with and without the output, in turns."""
    import torch

    from repro_torch.kernels.flash_attention.decode import (
        flash_decode, flash_decode_ref,
    )

    s, pos = MAX_LEN, 511
    for dname, dt in dtypes:
        q = randn((1, HQ, HEAD_DIM), dt)
        k = randn((1, HKV, s, HEAD_DIM), dt)
        v = randn((1, HKV, s, HEAD_DIM), dt)
        pos_t = dev_pos(pos)
        out, lse = flash_decode(q, k, v, pos=pos_t, return_lse=True)
        plain_out = flash_decode(q, k, v, pos=pos_t)
        torch.cuda.synchronize()
        check(torch.equal(out, plain_out), "flash_decode's output changed "
              "with return_lse")
        ref_out, ref_lse = flash_decode_ref(q, k, v, pos=pos, return_lse=True)
        record("flash_decode", f"pos={pos} lse", dname, lse, ref_lse)
        s_loc = s // 4
        for i in ((1, 3) if quick else (0, 1, 2, 3)):
            rows = slice(i * s_loc, (i + 1) * s_loc)
            kv_pos = torch.arange(i * s_loc, (i + 1) * s_loc,
                                  dtype=torch.int32, device="cuda")
            kk, vv = k[:, :, rows].contiguous(), v[:, :, rows].contiguous()
            o, ls = flash_decode(q, kk, vv, pos=pos_t, kv_pos=kv_pos,
                                 return_lse=True)
            torch.cuda.synchronize()
            ro, rl = flash_decode_ref(q, kk, vv, pos=pos, kv_pos=kv_pos,
                                      return_lse=True)
            if i * s_loc > pos:        # no visible key: NEG_INF + log(count)
                check(bool(torch.all(ls < -1e29)) and bool(
                    torch.all(rl < -1e29)), f"slice {i}: LSE of no key "
                    f"{float(ls.max())} / {float(rl.max())}")
            else:
                record("flash_decode", f"slice {i} of 4 pos={pos} lse",
                       dname, ls, rl)
                record("flash_decode", f"slice {i} of 4 pos={pos} out",
                       dname, o, ro)
        if not quick and dname == "float32":
            copies = [(randn(q.shape, dt), randn(k.shape, dt),
                       randn(v.shape, dt)) for _ in range(copies_for(
                           (2 * q.numel() + 2 * HKV * (pos + 1) * HEAD_DIM)
                           * q.element_size()))]
            turns = []
            for with_lse in (False, True, True, False):
                turns.append(time_ms([
                    lambda x=x, y=y, z=z: flash_decode(
                        x, y, z, pos=pos_t, return_lse=with_lse)
                    for x, y, z in copies]))
            off = statistics.mean((turns[0], turns[3]))
            on = statistics.mean((turns[1], turns[2]))
            log(f"  flash_decode pos={pos} {dname}: {off:.4f} ms without the "
                f"LSE output, {on:.4f} ms with it (turns "
                f"{', '.join(f'{t:.4f}' for t in turns)})")


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


# Idle host seconds a kernel listing's profile holds before and after its
# calls (device_kernel_launches).
PROFILE_PAD_S = 0.1


def device_kernels(fn, calls: int = 5):
    """Device ms per call of each CUDA kernel a call of ``fn`` runs (from
    ``torch.profiler``), by kernel name: where a multi-launch kernel's time
    goes, and which backend a library call took."""
    return {k: v[0] for k, v in device_kernel_launches(fn, calls).items()}


def device_kernel_launches(fn, calls: int = 5, full_names: bool = False):
    """{kernel name: (device ms, launches)} per call of ``fn``, from
    ``torch.profiler``; the name cut to its last component (templates kept)
    unless ``full_names``. The profile holds PROFILE_PAD_S of idle host
    time on either side of the calls: the profiler drops device events
    that fall outside its window on the host's clock, and the card's
    timestamps drift from that clock as a process ages (a listing of a few
    milliseconds came out empty late in a full run, and rglru's 0.5 ms one
    a minute or so into a fresh process)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    out = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            name = ev.name if full_names else short_kernel_name(ev.name)
            ms, n = out.get(name, (0.0, 0.0))
            out[name] = (ms + ev.time_range.elapsed_us() / 1e3 / calls,
                         n + 1 / calls)
    return out


def short_kernel_name(name: str) -> str:
    """A demangled kernel name cut to its last component, its template
    arguments kept (``ssd_out_kernel<float, true>``)."""
    import re

    name = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    return re.sub(r"\(.*", "", name).split("::")[-1]


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
            t_b, by = bound(nb, decode_flops(1, hq, d, seen), dname)
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


def _attention_row(record, randn, label, hq, hkv, sq, skv, d, causal, dname,
                   dt, timed, b=1):
    """Check ``flash_attention`` at one shape against its plain version;
    ``timed``: also its time, the plain version's, SDPA's and the bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention, regime as fa_regime,
    )
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    q = randn((b, hq, sq, d), dt)
    k, v = randn((b, hkv, skv, d), dt), randn((b, hkv, skv, d), dt)
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    ref = flash_attention_ref(q, k, v, causal=causal)
    timing = None
    if timed:
        nb = (2 * q.numel() + 2 * k.numel()) * q.element_size()
        pairs = sq * (sq + 1) // 2 if causal else sq * skv
        t_b, by = bound(nb, 4.0 * d * b * hq * pairs, TC_RATE[dname])
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
            shape=dict(b=b, hq=hq, hkv=hkv, sq=sq, skv=skv, d=d,
                       causal=causal, regime=fa_regime(dt, d)))
    record("flash_attention", label, dname, out, ref, timing)


def _decode_row(record, randn, label, hq, hkv, d, s, pos, dname, dt, timed):
    """Check ``flash_decode`` at one shape (batch 1) against its plain
    version; ``timed``: also its time, the plain version's, SDPA's and the
    bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.decode import (
        flash_decode, flash_decode_ref,
    )

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
        t_b, by = bound(nb, decode_flops(1, hq, d, seen), dname)
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


def _mm_row(record, randn, label, m, k, n, dname, dt, timed):
    """Check ``mm`` at one shape against its plain version; ``timed``: also
    its time, the plain version's, ``torch.matmul``'s and the bound."""
    import torch

    from repro_torch.kernels.matmul.ops import mm, regime
    from repro_torch.kernels.matmul.ref import matmul_ref

    a = randn((m, k), dt)
    b = randn((k, n), dt, scale=k ** -0.5)
    out = mm(a, b)
    torch.cuda.synchronize()
    timing = None
    if timed:
        nb = (m * k + k * n + m * n) * a.element_size()
        t_b, by = bound(nb, mm_flops(m, n, k), dname)
        copies = [(randn((m, k), dt), randn((k, n), dt))
                  for _ in range(copies_for(nb))]
        timing = dict(
            ms=time_ms([lambda x=x, y=y: mm(x, y) for x, y in copies]),
            plain_ms=time_ms([lambda x=x, y=y: matmul_ref(x, y)
                              for x, y in copies]),
            library_ms=library_ms([lambda x=x, y=y: torch.matmul(x, y)
                                   for x, y in copies]),
            bound_ms=t_b, bound_by=by,
            shape=dict(m=m, k=k, n=n, regime=regime(m, n, k, dt)))
    record("matmul", label, dname, out, matmul_ref(a, b), timing)


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
    for dname, dt in dtypes:
        timed = not quick and dname == "float32"
        both = not quick                      # both regimes timed at MHA
        args = (record, randn)
        _attention_row(*args, "MHA 16/16 D=128 sq=skv=600 causal", 16, 16,
                       600, 600, 128, True, dname, dt, both)
        if quick:
            continue
        _attention_row(*args, "GQA 64/4 D=128 sq=skv=600 causal", 64, 4, 600,
                       600, 128, True, dname, dt, timed)
        _attention_row(*args, "MHA 32/32 D=64 sq=skv=1500 non-causal", 32,
                       32, 1500, 1500, 64, False, dname, dt, timed)
        _attention_row(*args, "MHA 32/32 D=64 sq=64 skv=1500 non-causal", 32,
                       32, 64, 1500, 64, False, dname, dt, timed)
        _decode_row(*args, "ratio 1 16/16 D=128 s=1024 pos=611", 16, 16, 128,
                    1024, 611, dname, dt, timed)
        _decode_row(*args, "ratio 1 32/32 D=64 s=1024 pos=79", 32, 32, 64,
                    1024, 79, dname, dt, timed)
        _decode_row(*args, "ratio 16 64/4 D=128 s=1024 pos=607", 64, 4, 128,
                    1024, 607, dname, dt, timed)
        for m in (1, 600):
            for n in (10944, 2816):
                _mm_row(*args, f"moe m={m} k=2048 n={n}", m, 2048, n, dname,
                        dt, timed)


def tp_slice_checks(record, randn, dtypes, quick: bool):
    """The shapes a tensor-parallel rank of full-width qwen2-1.5b gives the
    three serving kernels (phase 18 (b)), each timed in float32 beside its
    plain version and one library call (bf16 checked): the FF GEMMs at
    M 4096, K 1536 with a rank's N = d_ff / m (4480 at 2 model ranks, 560
    at 16); flash_attention at B 1, S 512, D 128 on a rank's 8 query heads
    and 1 KV head (2 ranks) and 1 / 1 (16 ranks); flash_decode on 8 / 1
    heads over 1024 slots at position 511. And whisper-large-v3's rank
    shapes (its 32 padded heads over 2 and 16 model ranks, D 64):
    flash_attention non-causal on 16 / 16 and 2 / 2 heads, the encoder's
    1500 x 1500 and the cross-attention's 64 queries over 1500 frames;
    flash_decode over the 1500-frame cross cache on 16 / 16 and 2 / 2."""
    if quick:
        return
    for dname, dt in dtypes:
        timed = dname == "float32"
        args = (record, randn)
        for n in (4480, 560):
            _mm_row(*args, f"tp m=4096 k={D_MODEL} n={n}", 4096, D_MODEL, n,
                    dname, dt, timed)
        for hq, hkv in ((8, 1), (1, 1)):
            _attention_row(*args, f"tp {hq}/{hkv} D=128 sq=skv=512 causal",
                           hq, hkv, 512, 512, 128, True, dname, dt, timed)
        _decode_row(*args, "tp 8/1 D=128 s=1024 pos=511", 8, 1, 128, 1024,
                    511, dname, dt, timed)
        for h in (16, 2):
            for sq in (1500, 64):
                _attention_row(*args, f"tp whisper {h}/{h} D=64 sq={sq} "
                               "skv=1500 non-causal", h, h, sq, 1500, 64,
                               False, dname, dt, timed)
            _decode_row(*args, f"tp whisper cross {h}/{h} D=64 s=1500 "
                        "pos=1499", h, h, 64, 1500, 1499, dname, dt, timed)


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
                t_b, by = bound(nb, decode_flops(b, hq, d, s), dname)
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
                t_b, by = bound(nb, bilinear_flops(side * scale, side * scale),
                                dname)
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
                    t_b, by = bound(nb, rglru_flops(1, s, f), dname)
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


# A tensor-parallel rank's scan widths (phase 18 (b)): mamba2-2.7b's 80 SSD
# heads and recurrentgemma-9b's 4096 RG-LRU features over 2 and 16 model
# ranks.
TP_SSD_HEADS = (40, 5)
TP_RGLRU_FEATURES = (2048, 256)


def scan_tp_checks(record, dtypes, quick: bool):
    """The scans at a tensor-parallel rank's widths, S 4096: ssd at
    ``TP_SSD_HEADS`` (P 64, N 128, the default chunk) and rglru at
    ``TP_RGLRU_FEATURES`` (the default tile). Forward in both dtypes
    (float32 timed beside its plain version and its bound); the backward
    (``_SsdScanFn`` / ``_RglruScanFn``) in float32, each gradient against
    autograd of the plain scan, the backward's kernels timed alone from a
    forward's saved outputs against the plain backward (its forward's graph
    kept). No PyTorch call computes either scan."""
    if quick:
        return
    import torch

    from repro_torch.kernels.rglru import ops as rg_ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    s, p, n = 4096, 64, 128
    for dname, dt in dtypes:
        timed = dname == "float32"
        for h in TP_SSD_HEADS:
            prob = dict(s=s, h=h, p=p, n=n)
            (q,) = ssd_ops.SPEC.default_tile(prob, dname)
            ops_in = _ssd_operands(1, s, h, p, n, dt, seed=200 + h)
            y, hl = ssd_ops.ssd_scan(*ops_in, chunk=q)
            torch.cuda.synchronize()
            yr, hr = ssd_ops.ssd_scan_ref(*ops_in, chunk=q)
            timing = None
            if timed:
                nb = (sum(t.numel() for t in ops_in) + ops_in[1].numel()
                      + ops_in[4].numel()) * ops_in[1].element_size()
                copies = [_ssd_operands(1, s, h, p, n, dt, seed=300 + i)
                          for i in range(copies_for(nb))]
                t_b, by = bound(nb, ssd_ops.flops(q, prob), TC_RATE[dname])
                timing = dict(
                    ms=time_ms([lambda c=c: ssd_ops.ssd_scan(*c, chunk=q)
                                for c in copies]),
                    plain_ms=time_ms([lambda c=c: ssd_ops.ssd_scan_ref(
                        *c, chunk=q) for c in copies], iters=4),
                    library_ms=None, bound_ms=t_b, bound_by=by,
                    shape=dict(b=1, s=s, h=h, p=p, n=n, chunk=q))
                del copies
            case = f"tp s={s} h={h} p={p} n={n}"
            record("ssd", case + " y", dname, y, yr, timing)
            record("ssd", case + " h_last", dname, hl, hr)
            if timed:
                _scan_tp_backward(record, "ssd", dict(h=h, p=p, n=n,
                                                      chunk=q), s, dname, dt)
        for f in TP_RGLRU_FEATURES:
            tile = tuple(rg_ops.SPEC.default_tile(dict(s=s, f=f), dname))

            def operands(seed):
                g = torch.Generator(device="cuda").manual_seed(seed)
                return (torch.rand((1, s, f), generator=g,
                                   device="cuda").to(dt),
                        torch.randn((1, s, f), generator=g,
                                    device="cuda").to(dt),
                        torch.randn((1, f), generator=g, device="cuda").to(dt))

            a, x, h0 = operands(400 + f)
            y, hl = rg_ops.rglru_scan(a, x, h0, tile=tile)
            torch.cuda.synchronize()
            yr, hr = rg_ops.rglru_scan_ref(a, x, h0)
            timing = None
            if timed:
                nb = (3 * s * f + 2 * f) * x.element_size()
                copies = [operands(500 + i) for i in range(copies_for(nb))]
                t_b, by = bound(nb, rglru_flops(1, s, f), dname)
                timing = dict(
                    ms=time_ms([lambda c=c: rg_ops.rglru_scan(*c, tile=tile)
                                for c in copies]),
                    plain_ms=time_ms([lambda c=c: rg_ops.rglru_scan_ref(*c)
                                      for c in copies[:1]], iters=2),
                    library_ms=None, bound_ms=t_b, bound_by=by,
                    shape=dict(b=1, s=s, f=f, tile=list(tile)))
                del copies
            case = f"tp s={s} f={f}"
            record("rglru", case + " y", dname, y, yr, timing)
            record("rglru", case + " h_last", dname, hl, hr)
            if timed:
                _scan_tp_backward(record, "rglru", dict(f=f), s, dname, dt)


def _scan_tp_backward(record, kernel, width, s, dname, dt):
    """One scan's backward at a rank's width (``scan_tp_checks``): each
    gradient of sum(y w_y) + sum(h_last w_h) through the kernel path
    against autograd of the plain scan's, recorded as ``<kernel>_bwd``
    (the first with its times and bound)."""
    import torch

    from repro_torch.kernels.rglru import ops as rg_ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    fn, plain = _scan_fns(kernel, width)
    inputs, weights = _scan_grad_operands(kernel, width, s, dt, "cuda",
                                          seed=600)
    leaves, obj = _scan_objective(fn, inputs, weights)
    got = torch.autograd.grad(obj, leaves)
    p_leaves, p_obj = _scan_objective(plain, inputs, weights)
    want = torch.autograd.grad(p_obj, p_leaves, retain_graph=True)
    dy, dh = (w.to(dt) for w in weights)
    eb = inputs[1].element_size()
    if kernel == "ssd":
        q = width["chunk"]
        prob = dict(s=s, h=width["h"], p=width["p"], n=width["n"])
        y, hl, h_in = ssd_ops._ssd_cuda(*inputs, q)

        def bwd():
            return ssd_ops.ssd_scan_backward(
                *inputs, y, hl, h_in, dy, dh, q, ssd_ops._ssd_rev_cuda,
                ssd_ops._ssd_bwd_cuda)
        nb = (2 * sum(t.numel() for t in inputs) + y.numel() + hl.numel()
              + dy.numel() + dh.numel()) * eb
        t_b, by = bound(nb, ssd_ops.bwd_flops(q, prob), TC_RATE[dname])
        names = ("log_a", "dtx", "B", "C", "h0")
        shape = dict(b=1, s=s, **width)
    else:
        a, _, h0 = inputs
        y, _ = rg_ops._rglru_cuda(*inputs)

        def bwd():
            return rg_ops._rglru_bwd_cuda(a, y, h0, dy, dh)
        f = width["f"]
        t_b, by = bound((5 * s * f + 3 * f) * eb, 4.0 * s * f, dname)
        names = ("a", "x", "h0")
        shape = dict(b=1, s=s, f=f)
    timing = dict(ms=time_ms([bwd], iters=8),
                  plain_ms=eager_ms(lambda: torch.autograd.grad(
                      p_obj, p_leaves, retain_graph=True), iters=2,
                      warmup=1),
                  library_ms=None, bound_ms=t_b, bound_by=by, shape=shape)
    label = ", ".join(f"{k}={v}" for k, v in width.items())
    for i, (name, g, w) in enumerate(zip(names, got, want)):
        record(f"{kernel}_bwd", f"tp s={s} {label} d{name}", dname, g, w,
               timing if i == 0 else None)


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
                    chunking=None, layers=None):
    """Phases 10 and 11: ``arch`` at full width (float32, random weights
    from seed 0) served through the captured engine
    (:func:`serve_counted`), one request's logits held against the plain
    versions, prefill device ms at 600 tokens and at the longest prompt,
    decode ms a step at 1 and 4 slots, with ``chunking = (n, chunk)`` an
    ``n``-token prompt prefilled in chunks against the whole prefill
    (phase 12d), and with ``profile`` where one 600-token request's time
    goes. ``layers`` cuts the model to its first layers (full width)."""
    import torch

    from repro_torch import configs

    cfg = configs.get_arch(arch)
    if layers:
        cfg = _first_layers(cfg, layers)
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
# Phase 17: training on the card
# ---------------------------------------------------------------------------

# 17b-c: full-width qwen2-1.5b at a global batch of 8 x 512 tokens.
TRAIN_BATCH, TRAIN_SEQ = 8, 512
# 17b: each gradient leaf, kernels against the plain versions, relative to
# that leaf's max |plain gradient|: the forward's float32 sums run in
# another order (the simt matmul) or through 3xTF32 (flash_attention,
# ~2e-6 relative), and 28 layers of backward carry that on. Sound runs
# reach ~8e-6; the plain path with TF32 products, run as a control, must
# land above the limit, so a float32 product that lost precision fails.
TRAIN_GRAD_TOL = 1e-4
# 17c: the learning rate's peak (warmup-cosine over the five steps; the
# first step's rate is 0).
TRAIN_PEAK_LR = 3e-4
# 17c: one step's launches with remat: the three FF GEMMs forward, again in
# the recompute and six backward products a layer; the attention forward
# twice and its plain backward once.
TRAIN_STEP_LAUNCHES = {"matmul": 28 * 12, "flash_attention": 28 * 2,
                       "flash_attention_bwd_plain": 28}
# 17d: the 100M example, 20 steps at 8 x 256 tokens (cut from 100 so that
# phase 18 fits the time limit, from 60 when phase 3's tensor-parallel
# rows came, from 40 when phase 18 (b) gained its FSDP steps, and from 30
# when it gained the recurrent mixers; the loss must still fall by more
# than 1.0), checkpoints every 10 (keep 2), a failure injected at step
# 14, so the run restarts from step 10; the
# replayed steps' losses and the final parameters must equal the
# uninterrupted run's bit for bit (a step is deterministic and the
# checkpoint holds params, moments and step).
EXAMPLE_STEPS, EXAMPLE_EVERY, EXAMPLE_FAIL_AT = 20, 10, 14
EXAMPLE_RESTORED = EXAMPLE_FAIL_AT // EXAMPLE_EVERY * EXAMPLE_EVERY
# 17e (a): each scan's gradients at its model's full width: mamba2-2.7b's
# SSD (H 80, P 64, N 128, its float32 chunk 64) and recurrentgemma-9b's
# RG-LRU (F 4096), one batch row of 4096 steps and a ragged 4001 (no
# multiple of the chunk or of the RG-LRU's 32-step tile).
SCAN_GRAD_WIDTHS = {"ssd": dict(h=80, p=64, n=128, chunk=64),
                    "rglru": dict(f=4096)}
SCAN_GRAD_S = (4096, 4001)
# 17e (a): the backwards are timed at one row of 4096 steps and, for the
# ssd, at mamba2-2.7b's train shape too (one layer's call in a 17e (c)
# step: B 8, S 512), each beside the earlier design's time where one was
# kept (the ssd's: the forward kernels on flipped copies and two
# repro_ssd_bwd launches; NVIDIA H100 80GB HBM3 at 700 W).
SCAN_BWD_SHAPES = {"ssd": ((1, 4096), (8, 512)), "rglru": ((1, 4096),)}
SCAN_BWD_EARLIER_MS = {("ssd", "float32", 1, 4096): 2.3325,
                       ("ssd", "bfloat16", 1, 4096): 1.8728}
# 17e (c): the "ssd backward" group of the profiled mamba2 step with that
# earlier design (ms, same card).
SCAN_TRAIN_SSD_BWD_EARLIER_MS = 149.9
# 17e (b): each gradient leaf of full-width mamba2-2.7b (and of 17e (d)'s
# recurrentgemma-9b), kernels against the plain versions, and the loss,
# within this of max(1, max |plain|).
SCAN_TRAIN_GRAD_TOL = 1e-4
# 17e (d): recurrentgemma-9b at full width and this many (rglru, rglru,
# local_attn) units: 6 of its 38 layers, 2.36 B parameters (the tied
# 256,000 x 4096 embedding is 1.05 B of them), 37.8 GB as float32 weights,
# gradients and two moments. All 38 layers (9.4 B, 150 GB) do not fit;
# three units (3.02 B, 48.3 GB) ran out of the card's memory in AdamW,
# whose update of the embedding leaf takes 3.9 GB a temporary.
RG_TRAIN_UNITS = 2


def eager_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Device ms per call of ``fn`` from CUDA events around ``iters`` eager
    calls: for calls a CUDA graph does not take (an autograd backward), at
    sizes whose kernels outlast their launches."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _grad_case(fn, inputs, weight):
    """(output, gradients) of ``sum(fn(*inputs) * weight)``."""
    import torch

    leaves = [t.detach().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    grads = torch.autograd.grad((out.float() * weight).sum(), leaves)
    return out.detach(), grads


def _train_randn(device, seed: int):
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(dtype)
    return randn


def train_grad_checks(device="cuda"):
    """17a: gradients through ``mm`` and ``flash_attention`` against the
    plain versions' on the same inputs, at the train step's shapes, in
    float32 and bf16, with each wrapper's launches (``device="cpu"``
    rehearses the schedule on the plain versions)."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
    )
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.matmul.ops import mm, regime
    from repro_torch.kernels.matmul.ref import matmul_ref

    on_card = torch.device(device).type == "cuda"
    randn = _train_randn(device, 17)
    rows = []

    def hold(kernel, case, dname, pairs, launches, want):
        """Each (name, out, plain) within REL_TOL of max |plain|."""
        errs = {}
        for name, out, ref in pairs:
            err = max_err(out, ref)
            errs[name] = err / max(1.0, float(ref.float().abs().max()))
            check(within(err, ref, dname), f"{kernel} {case} {dname}: {name} "
                  f"differs by {err:.3e} (max {float(ref.abs().max()):.3g})")
        check(launches == (want if on_card else type(want)(0 * w for w in
                                                            want)),
              f"{kernel} {case}: launches {launches}, expected {want}")
        rows.append(dict(kernel=kernel, case=case, dtype=dname,
                         rel_err=errs, launches=launches))
        log(f"  {kernel:16s} {case:40s} {dname:8s} " + ", ".join(
            f"{k} {v:.2e}" for k, v in errs.items()) + f" | {launches}")

    dtypes = (("float32", torch.float32), ("bfloat16", torch.bfloat16))
    for dname, dt in dtypes:
        for m, k, n in ((TRAIN_BATCH * TRAIN_SEQ, D_MODEL, D_FF),
                        (TRAIN_BATCH * TRAIN_SEQ, D_FF, D_MODEL),
                        (37, 70, 33)):
            a, b = randn((m, k), dt), randn((k, n), dt, k ** -0.5)
            w = randn((m, n))
            build.reset_launches()
            out, (da, db) = _grad_case(mm, (a, b), w)
            launches = (build.LAUNCHES["matmul"],)
            ref, (ra, rb) = _grad_case(matmul_ref, (a, b), w)
            hold("matmul", f"grad m={m} k={k} n={n} "
                 f"({regime(m, n, k, dt)})", dname,
                 (("out", out, ref), ("dA", da, ra), ("dB", db, rb)),
                 launches, (3,))
        for b_, hq, hkv, s, skv, d, causal, window, cap in (
                (2, HQ, HKV, TRAIN_SEQ, TRAIN_SEQ, HEAD_DIM, True, None, None),
                (2, HQ, HKV, TRAIN_SEQ, TRAIN_SEQ, HEAD_DIM, True, 128, None),
                (2, HQ, HKV, TRAIN_SEQ, TRAIN_SEQ, HEAD_DIM, True, None, 50.0),
                (2, 32, 8, TRAIN_SEQ, TRAIN_SEQ, 80, True, None, None),
                (1, 32, 32, 64, 1500, 64, False, None, None)):
            q = randn((b_, hq, s, d), dt)
            k_, v = randn((b_, hkv, skv, d), dt), randn((b_, hkv, skv, d), dt)
            w = randn((b_, hq, s, d))
            kw = dict(causal=causal, window=window, softcap=cap)
            build.reset_launches()
            out, grads = _grad_case(
                lambda *t: flash_attention(*t, **kw), (q, k_, v), w)
            launches = (build.LAUNCHES["flash_attention"],
                        build.LAUNCHES["flash_attention_bwd_plain"])
            ref, want = _grad_case(
                lambda *t: flash_attention_ref(*t, **kw), (q, k_, v), w)
            case = (f"grad b={b_} {hq}/{hkv} {s}x{skv} d={d}"
                    + ("" if causal else " non-causal")
                    + (f" window={window}" if window else "")
                    + (f" softcap={cap:g}" if cap else ""))
            hold("flash_attention", case, dname,
                 (("out", out, ref),) + tuple(
                     (name, g, r) for name, g, r in zip(("dq", "dk", "dv"),
                                                         grads, want)),
                 launches, (1, 1))
    return rows


def train_shape_times():
    """17a: the train step's shapes timed, float32 (TF32 off) and bf16:
    each of its four GEMM shapes (the forward's two, the weight gradients'
    two) through the kernel, its plain version and torch.matmul; the
    attention forward at batch 8, and its plain backward beside SDPA's."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
    )
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.matmul.ops import mm, regime
    from repro_torch.kernels.matmul.ref import matmul_ref

    randn = _train_randn("cuda", 18)
    dtypes = (("float32", torch.float32), ("bfloat16", torch.bfloat16))
    timed = []
    m = TRAIN_BATCH * TRAIN_SEQ
    per_layer = {(m, D_MODEL, D_FF): "fwd w1,w3 (x4: +recompute); dA of w2",
                 (m, D_FF, D_MODEL): "fwd w2 (x2: +recompute); dA of w1,w3",
                 (D_MODEL, m, D_FF): "dB of w1, w3",
                 (D_FF, m, D_MODEL): "dB of w2"}
    for dname, dt in dtypes:
        for (mm_, k, n), role in per_layer.items():
            nb = (mm_ * k + k * n + mm_ * n) * (4 if dname == "float32" else 2)
            t_b, by = bound(nb, mm_flops(mm_, n, k), dname)
            copies = [(randn((mm_, k), dt), randn((k, n), dt, k ** -0.5))
                      for _ in range(copies_for(nb))]
            row = dict(kernel="matmul", dtype=dname, role=role,
                       shape=dict(m=mm_, k=k, n=n,
                                  regime=regime(mm_, n, k, dt)),
                       ms=time_ms([lambda x=x, y=y: mm(x, y)
                                   for x, y in copies]),
                       plain_ms=time_ms([lambda x=x, y=y: matmul_ref(x, y)
                                         for x, y in copies]),
                       library_ms=library_ms([lambda x=x, y=y: torch.matmul(
                           x, y) for x, y in copies]),
                       bound_ms=t_b, bound_by=by)
            timed.append(row)
            log(f"  matmul {dname:8s} m={mm_} k={k} n={n} ({role}): "
                f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f}, "
                f"torch.matmul {row['library_ms']}, bound {t_b:.4f} ({by})")
        # The attention forward at the train shape, and its backward: the
        # plain version's gradient (with its recompute, as the autograd
        # Function runs it) beside SDPA's backward (its forward kept).
        shape = (TRAIN_BATCH, HQ, TRAIN_SEQ, HEAD_DIM)
        kv = (TRAIN_BATCH, HKV, TRAIN_SEQ, HEAD_DIM)
        esize = 4 if dname == "float32" else 2
        nb = (2 * TRAIN_BATCH * HQ + 2 * TRAIN_BATCH * HKV) * TRAIN_SEQ \
            * HEAD_DIM * esize
        pairs = TRAIN_BATCH * TRAIN_SEQ * (TRAIN_SEQ + 1) // 2
        t_b, by = bound(nb, 4.0 * HEAD_DIM * HQ * pairs, TC_RATE[dname])
        copies = [(randn(shape, dt), randn(kv, dt), randn(kv, dt))
                  for _ in range(copies_for(nb))]

        def sdpa(x, y, z):
            return F.scaled_dot_product_attention(x, y, z, is_causal=True,
                                                  enable_gqa=True)

        row = dict(kernel="flash_attention", dtype=dname, role="forward",
                   shape=dict(b=TRAIN_BATCH, hq=HQ, hkv=HKV, s=TRAIN_SEQ,
                              d=HEAD_DIM),
                   ms=time_ms([lambda x=x, y=y, z=z: flash_attention(
                       x, y, z, causal=True) for x, y, z in copies]),
                   plain_ms=time_ms([lambda x=x, y=y, z=z: flash_attention_ref(
                       x, y, z, causal=True) for x, y, z in copies]),
                   library_ms=library_ms([lambda x=x, y=y, z=z: sdpa(x, y, z)
                                          for x, y, z in copies]),
                   bound_ms=t_b, bound_by=by)
        timed.append(row)
        log(f"  flash_attention {dname:8s} forward b={TRAIN_BATCH} "
            f"{HQ}/{HKV} s={TRAIN_SEQ}: {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f}, SDPA {row['library_ms']}, bound "
            f"{t_b:.4f} ({by})")
        q, k_, v = (t.detach().requires_grad_(True) for t in copies[0])
        dout = randn(shape, dt)

        def plain_bwd():
            torch.autograd.grad(flash_attention_ref(q, k_, v, causal=True),
                                (q, k_, v), dout)

        # Five products of the forward's size (S, dP, dV, dQ, dK): q, k,
        # v and dout read, dq, dk and dv written.
        t_b, by = bound(2 * nb, 10.0 * HEAD_DIM * HQ * pairs, TC_RATE[dname])
        lib = None
        try:
            out = sdpa(q, k_, v)
            lib = eager_ms(lambda: torch.autograd.grad(
                out, (q, k_, v), dout, retain_graph=True))
        except (TypeError, RuntimeError) as exc:
            log(f"  (SDPA backward not timed: {exc})")
        row = dict(kernel="flash_attention", dtype=dname,
                   role="backward (plain, with its recompute)",
                   shape=dict(b=TRAIN_BATCH, hq=HQ, hkv=HKV, s=TRAIN_SEQ,
                              d=HEAD_DIM),
                   ms=eager_ms(plain_bwd), library_ms=lib, bound_ms=t_b,
                   bound_by=by)
        row["plain_ms"] = row["ms"]
        timed.append(row)
        log(f"  flash_attention {dname:8s} backward (plain, recompute "
            f"included): {row['ms']:.4f} ms, SDPA backward {lib}, bound "
            f"{t_b:.4f} ({by})")
        del copies, q, k_, v
    return timed


def _step_launches(on_card: bool):
    """One train step's launches: TRAIN_STEP_LAUNCHES on the card, none on
    the CPU (the plain versions; the rehearsal)."""
    return {k: v if on_card else 0 for k, v in TRAIN_STEP_LAUNCHES.items()}


def _train_batch(cfg, batch: int, seq: int, step: int = 0):
    from repro_torch.data.pipeline import DataConfig, make_batch

    return make_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                 global_batch=batch), step)


def train_parity(cfg, params):
    """17b: one batch of full-width qwen2-1.5b through ``api.train_loss``
    and its backward, the kernels against ``impl="reference"``: the loss
    within 1e-5, every leaf's gradient set, non-zero and within
    TRAIN_GRAD_TOL of its max |plain gradient|; the launches of one step.
    A control runs the plain path again with TF32 products: its worst leaf
    must exceed TRAIN_GRAD_TOL, or the limit could not tell a float32
    product from a TF32 one."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.models import api

    batch = _train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ)
    leaves = list(_leaves(params))
    on_card = leaves[0].is_cuda
    out = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    for run, impl in (("auto", "auto"), ("reference", "reference"),
                      ("tf32", "reference")):
        for p in leaves:
            p.grad = None
            p.requires_grad_(True)
        build.reset_launches()
        torch.backends.cuda.matmul.allow_tf32 = run == "tf32"
        try:
            t0 = time.perf_counter()
            loss, _ = api.train_loss(params, cfg, batch, impl=impl)
            loss.backward()
            if on_card:
                torch.cuda.synchronize()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        out[run] = dict(loss=float(loss.detach()), s=time.perf_counter() - t0,
                        launches=dict(build.LAUNCHES),
                        grads=[p.grad for p in leaves])
    for p in leaves:
        p.grad = None
        p.requires_grad_(False)
    k, r, c = out["auto"], out["reference"], out.pop("tf32")

    def worst_leaf_rel(grads):
        worst, worst_leaf = 0.0, None
        for i, (g, ref) in enumerate(zip(grads, r["grads"])):
            rel = float((g - ref).abs().max()) / float(ref.abs().max())
            if rel > worst:
                worst, worst_leaf = rel, i
        return worst, worst_leaf

    loss_rel = abs(k["loss"] - r["loss"]) / abs(r["loss"])
    check(loss_rel <= 1e-5, f"train loss {k['loss']} vs plain {r['loss']}")
    for i, g in enumerate(k["grads"]):
        check(g is not None and bool(g.abs().max() > 0),
              f"parameter {i} got no gradient through the kernels")
    worst, worst_leaf = worst_leaf_rel(k["grads"])
    check(worst <= TRAIN_GRAD_TOL, f"gradient leaf {worst_leaf} differs by "
          f"{worst:.3e} x its max (tol {TRAIN_GRAD_TOL:g})")
    control, control_leaf = worst_leaf_rel(c.pop("grads"))
    if on_card:
        check(control > TRAIN_GRAD_TOL, f"the TF32 control's worst leaf "
              f"{control:.3e} x its max is within the limit "
              f"{TRAIN_GRAD_TOL:g}: the limit cannot see lost precision")
    launches = {name: k["launches"][name] for name in TRAIN_STEP_LAUNCHES}
    check(launches == _step_launches(on_card), f"one train step launched "
          f"{launches}, expected {TRAIN_STEP_LAUNCHES}")
    check(all(r["launches"][name] == 0 for name in TRAIN_STEP_LAUNCHES),
          f"the plain path launched kernels: {r['launches']}")
    log(f"  loss {k['loss']:.6f} (plain {r['loss']:.6f}, rel {loss_rel:.2e});"
        f" {len(leaves)} gradient leaves, all non-zero, worst {worst:.3e} x "
        f"max (leaf {worst_leaf}, tol {TRAIN_GRAD_TOL:g}; the TF32 "
        f"control {control:.3e}, leaf {control_leaf}); launches "
        f"{launches}; first call {k['s']:.2f} s, plain {r['s']:.2f} s")
    return dict(loss=k["loss"], plain_loss=r["loss"], loss_rel=loss_rel,
                worst_grad_rel=worst, tf32_control_rel=control,
                launches=launches)


# 17c --profile: the ranges chip_smoke labels on a profiled step (each
# shows on the device's timeline as an annotation spanning its kernels),
# and the group each range's kernels go to.
TRAIN_LABELS = {"train.matmul_forward": "matmul forward (+ recompute)",
                "train.attention_backward": "attention backward (plain)",
                "train.adamw": "adamw",
                "train.head_loss": "head and loss (forward)"}


def _train_groups(prof, labels_by_range=None, by_name=None):
    """Device ms of a profiled train step by group, and the device's busy
    ms (the union of the kernels' intervals). A kernel that ran inside a
    labelled range on the device's timeline (TRAIN_LABELS) goes to that
    range's group; any other goes by its name: a matmul kernel outside a
    forward range is a backward product (dA or dB), the flash-attention
    kernel is the forward (a layer's recompute runs inside the backward,
    so only the labels tell the two matmul passes apart), the rest are
    the projections' and the head's cuBLAS products and other ops, their
    backward included."""
    import bisect

    from torch.autograd import DeviceType

    ranges = TRAIN_LABELS if labels_by_range is None else labels_by_range
    labels, kernels = [], []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        span = (ev.time_range.start, ev.time_range.end, ev.name)
        if ev.name in ranges:
            labels.append(span)
        elif not getattr(ev, "is_user_annotation", False):
            kernels.append(span)
    labels.sort()
    starts = [start for start, _, _ in labels]
    if by_name is None:
        by_name = {"matmul": "matmul backward",
                   "flash_attention": "flash_attention forward (+ recompute)",
                   "torch.matmul (projections, head)":
                       "torch.matmul (projections, head; backward included)",
                   "other torch ops": "other torch ops (backward included)"}
    groups, busy_us, reach = {}, 0.0, None
    for start, end, name in sorted(kernels):
        i = bisect.bisect_right(starts, start) - 1
        if i >= 0 and start < labels[i][1]:
            group = ranges[labels[i][2]]
        else:
            group = by_name.get(_kernel_group(name), _kernel_group(name))
        groups[group] = groups.get(group, 0.0) + (end - start) / 1e3
        if reach is None or start > reach:
            busy_us += end - start
            reach = end
        elif end > reach:
            busy_us += end - reach
            reach = end
    return groups, busy_us / 1e3


def train_steps(cfg, params, profile: bool, steps: int = 5):
    """17c: five steps of ``make_train_step`` (AdamW, weight decay 0.01;
    warmup-cosine to TRAIN_PEAK_LR) on full-width qwen2-1.5b from 17b's parameters:
    host ms a step (median of steps 2-5, each ending with its loss read
    back), tokens/s, peak allocated bytes, model FLOP/s (6 N tokens a
    step) against float32's 67 TFLOP/s, one step's launches; with
    ``profile`` a sixth step's device ms by group and the idle share, and
    the head and loss (forward and backward) timed alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from torch.profiler import record_function

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention as fa_ops
    from repro_torch.kernels.matmul import ops as mm_ops
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import warmup_cosine
    from repro_torch.train.step import make_train_step

    n_params = sum(p.numel() for p in _leaves(params))
    opt_cfg = adamw.AdamWConfig(weight_decay=0.01)
    opt_state = adamw.init_state(params, opt_cfg)
    step_fn = make_train_step(cfg, opt_cfg, lambda s: warmup_cosine(
        s, peak_lr=TRAIN_PEAK_LR, warmup_steps=1, total_steps=steps))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    losses, times, launches = [], [], None
    on_card = next(_leaves(params)).is_cuda
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        batch = _train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, step=i)
        if i == 2:
            build.reset_launches()
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 2:
            launches = {k: build.LAUNCHES[k] for k in TRAIN_STEP_LAUNCHES}
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    check(launches == _step_launches(on_card),
          f"step 3 launched {launches}, expected {TRAIN_STEP_LAUNCHES}")
    step_ms = statistics.median(times[1:])
    flops = 6.0 * n_params * tokens
    out = dict(losses=losses, step_ms=times, median_step_ms=step_ms,
               tokens_per_s=tokens / step_ms * 1e3, peak_allocated=peak,
               model_tflops=flops / step_ms / 1e9,
               model_flops_share=flops / step_ms * 1e3 / PEAK_FLOPS["float32"],
               n_params=n_params, launches=launches)
    log(f"  losses {', '.join(f'{x:.4f}' for x in losses)}; step ms "
        f"{', '.join(f'{x:.1f}' for x in times)}; median (steps 2-5) "
        f"{step_ms:.1f} ms = {out['tokens_per_s']:.0f} tokens/s; peak "
        f"allocated {peak / 2**30:.2f} GiB; model {out['model_tflops']:.2f} "
        f"TFLOP/s (6 N tokens, N = {n_params / 1e9:.3f} B) = "
        f"{out['model_flops_share']:.3f} of float32's 67; launches of step 3 "
        f"{launches}")
    if profile:
        real_update, real_loss = adamw.apply_updates, transformer.fused_lm_loss

        def labelled(name, fn):
            def call(*args, **kwargs):
                with record_function(name):
                    return fn(*args, **kwargs)
            return call

        # The matmul Function's forward and the attention Function's
        # backward, labelled: a checkpointed layer's recompute runs inside
        # the backward, so only the label tells the matmul's two passes
        # apart.
        real_fwd = mm_ops._MatmulFn.forward
        real_bwd = fa_ops._FlashAttentionFn.backward
        adamw.apply_updates = labelled("train.adamw", real_update)
        transformer.fused_lm_loss = labelled("train.head_loss", real_loss)
        mm_ops._MatmulFn.forward = staticmethod(
            labelled("train.matmul_forward", real_fwd))
        fa_ops._FlashAttentionFn.backward = staticmethod(
            labelled("train.attention_backward", real_bwd))
        try:
            batch = _train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, step=steps)
            if on_card:
                torch.cuda.synchronize()
            with torch_profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                params, opt_state, metrics = step_fn(params, opt_state, batch)
                float(metrics["loss"])
                wall = (time.perf_counter() - t0) * 1e3
        finally:
            adamw.apply_updates, transformer.fused_lm_loss = (real_update,
                                                              real_loss)
            mm_ops._MatmulFn.forward = staticmethod(real_fwd)
            fa_ops._FlashAttentionFn.backward = staticmethod(real_bwd)
        groups, busy = _train_groups(prof)
        out["profile"] = dict(wall_ms=wall, by_group_ms=groups,
                              kernel_sum_ms=sum(groups.values()),
                              device_busy_ms=busy,
                              device_idle_share=max(0.0, 1 - busy / wall)
                              if busy else None)
        log(f"  profiled step: wall {wall:.1f} ms, device busy {busy:.1f} ms "
            f"(kernel times summed {sum(groups.values()):.1f} ms), idle "
            f"share {out['profile']['device_idle_share']}")
        for g, t in sorted(groups.items(), key=lambda kv: -kv[1]):
            log(f"    {g:44s} {t:.3f} ms")
        # The head product and cross-entropy, forward and backward, alone.
        dev = params["embed"].device
        hidden = torch.randn((TRAIN_BATCH, TRAIN_SEQ, cfg.d_model),
                             device=dev).requires_grad_(True)
        head = params["embed"].detach().t().requires_grad_(True)
        targets = torch.as_tensor(batch["targets"], device=dev).long()
        out["head_loss_ms"] = eager_ms(lambda: torch.autograd.grad(
            transformer.fused_lm_loss(head, hidden, targets, cfg),
            (head, hidden)), iters=5)
        log(f"  head and loss, forward and backward alone: "
            f"{out['head_loss_ms']:.2f} ms")
    del opt_state
    return out


def train_example(tmp_dir: Path):
    """17d: ``Trainer.run`` on the 100M example config: EXAMPLE_STEPS steps
    at 8 x 256 tokens, checkpoints every EXAMPLE_EVERY (keep 2); the loss
    falls by more than 1.0 (the example's own assertion); a run with a
    failure at EXAMPLE_FAIL_AT restores EXAMPLE_RESTORED and ends at the
    uninterrupted run's loss; then the launcher on the smoke config with a
    failure at step 12."""
    import torch

    from repro_torch.data.pipeline import DataConfig
    from repro_torch.examples.train_lm import make_100m_config, n_params
    from repro_torch.kernels import build
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = make_100m_config()
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=256,
                          global_batch=8)

    def run(name, fail_at=None):
        tcfg = TrainerConfig(steps=EXAMPLE_STEPS,
                             checkpoint_every=EXAMPLE_EVERY,
                             keep=2, checkpoint_dir=str(tmp_dir / name),
                             peak_lr=3e-4, warmup_steps=20, log_every=50)
        trainer = Trainer(cfg, data_cfg, tcfg, device="cuda",
                          opt_cfg=adamw.AdamWConfig(weight_decay=0.01))
        t0 = time.perf_counter()
        res = trainer.run(fail_at=fail_at)
        res["s"] = time.perf_counter() - t0
        res["ckpts"] = trainer.ckpt.all_steps()
        return res

    build.reset_launches()
    clean = run("clean")
    launches = {k: build.LAUNCHES[k] for k in TRAIN_STEP_LAUNCHES}
    first, last = clean["losses"][0], clean["losses"][-1]
    check(last < first - 1.0, f"100M example: loss {first:.3f} -> "
          f"{last:.3f}, not more than 1.0 lower")
    kept = [EXAMPLE_STEPS - EXAMPLE_EVERY, EXAMPLE_STEPS]
    check(clean["ckpts"] == kept, f"kept {clean['ckpts']}, want {kept}")
    check(all(launches[k] > 0 for k in launches), f"launches {launches}")
    torch.cuda.empty_cache()
    failed = run("failed", fail_at=EXAMPLE_FAIL_AT)
    check(failed["restarts"] == 1, f"restarts {failed['restarts']}")
    check(len(failed["losses"]) == (EXAMPLE_STEPS + EXAMPLE_FAIL_AT
                                    - EXAMPLE_RESTORED),
          f"{len(failed['losses'])} steps taken with the restart")
    replayed = EXAMPLE_STEPS - EXAMPLE_RESTORED
    check(failed["losses"][-replayed:] == clean["losses"][-replayed:],
          f"restarted run's losses after step {EXAMPLE_RESTORED} differ from "
          f"the uninterrupted run's (final {failed['losses'][-1]!r} vs "
          f"{last!r})")
    same_params = all(torch.equal(a, b) for a, b in zip(
        _leaves(failed.pop("params")), _leaves(clean.pop("params"))))
    check(same_params, "restarted run's final parameters differ from the "
          "uninterrupted run's")
    log(f"  {cfg.name} ({n_params(cfg) / 1e6:.0f}M parameters): loss "
        f"{first:.3f} -> {last:.3f} over {EXAMPLE_STEPS} steps in "
        f"{clean['s']:.1f} s ({clean['s'] / EXAMPLE_STEPS * 1e3:.1f} ms a "
        f"step with checkpoints); kept {clean['ckpts']}; launches {launches}")
    log(f"  failure at step {EXAMPLE_FAIL_AT}: restarts "
        f"{failed['restarts']}, {len(failed['losses'])} steps, final loss "
        f"{failed['losses'][-1]:.6f} vs {last:.6f}; the {replayed} losses "
        f"after step {EXAMPLE_RESTORED} and the final parameters "
        f"bit-identical; "
        f"stragglers {failed['straggler_events']}")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "qwen2-1.5b", "--steps", "20", "--checkpoint-every", "10",
           "--fail-at", "12", "--checkpoint-dir", str(tmp_dir / "launcher")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=600, cwd=ROOT)
    check(proc.returncode == 0 and "restarts: 1" in proc.stdout,
          f"launcher: rc {proc.returncode}\n{proc.stdout[-2000:]}"
          f"\n{proc.stderr[-2000:]}")
    final = [line for line in proc.stdout.splitlines()
             if line.startswith("final loss")]
    log(f"  launcher ({' '.join(cmd[2:8])} --fail-at 12): "
        f"{final[-1] if final else '?'} in {time.perf_counter() - t0:.1f} s")
    return dict(first_loss=first, last_loss=last, clean_s=clean["s"],
                restart_final_loss=failed["losses"][-1], restart_identical=True,
                launches=launches, launcher=final[-1] if final else None)


def _scan_grad_operands(kernel, width, s, dt, device, seed, b=1):
    """17e (a): ``b`` batch rows of a scan's inputs and of the weights of its
    two outputs (the objective is sum(y w_y) + sum(h_last w_h))."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)

    def rand(shape, lo=0.0, hi=1.0):
        return (torch.rand(shape, generator=gen, device=device) * (hi - lo)
                + lo).to(dt)

    def randn(shape, scale=1.0, dtype=dt):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(dtype)

    if kernel == "ssd":
        h, p, n = width["h"], width["p"], width["n"]
        inputs = (rand((b, h, s), -0.1, 0.0), randn((b, s, h, p), 0.05),
                  randn((b, s, n)), randn((b, s, n)), randn((b, h, n, p)))
        weights = (randn((b, s, h, p), dtype=torch.float32),
                   randn((b, h, n, p), dtype=torch.float32))
    else:
        f = width["f"]
        inputs = (rand((b, s, f), 0.5, 1.0), randn((b, s, f)), randn((b, f)))
        weights = (randn((b, s, f), dtype=torch.float32),
                   randn((b, f), dtype=torch.float32))
    return inputs, weights


def _scan_fns(kernel, width):
    """(kernel path, plain version) of a scan as 17e (a) calls them."""
    from repro_torch.kernels.rglru import ops as rg_ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    if kernel == "ssd":
        q = width["chunk"]
        return (lambda *t: ssd_ops.ssd_scan(*t, chunk=q),
                lambda *t: ssd_ops.ssd_scan_ref(*t, chunk=q))
    return rg_ops.rglru_scan, rg_ops.rglru_scan_ref


def _scan_objective(fn, inputs, weights):
    """(leaves, objective) of sum(y w_y) + sum(h_last w_h) through ``fn``."""
    leaves = [t.detach().requires_grad_(True) for t in inputs]
    outs = fn(*leaves)
    return leaves, sum((o.float() * w).sum() for o, w in zip(outs, weights))


def scan_grad_checks(device="cuda", widths=SCAN_GRAD_WIDTHS,
                     lengths=SCAN_GRAD_S):
    """17e (a): the ssd and rglru gradients through ``_SsdScanFn`` /
    ``_RglruScanFn`` (their backwards on the kernels) against autograd of
    the plain scans on the same inputs, float32 and bf16, at each length;
    each gradient within REL_TOL of max(1, max |plain|), one forward and one
    backward counted. ``device="cpu"`` rehearses the schedule on the plain
    versions (nothing launched)."""
    import torch

    from repro_torch.kernels import build

    on_card = torch.device(device).type == "cuda"
    rows = []
    names = {"ssd": ("dlog_a", "ddtx", "dB", "dC", "dh0"),
             "rglru": ("da", "dx", "dh0")}
    for kernel, width in widths.items():
        fn, plain = _scan_fns(kernel, width)
        for dname, dt in (("float32", torch.float32),
                          ("bfloat16", torch.bfloat16)):
            for s in lengths:
                inputs, weights = _scan_grad_operands(kernel, width, s, dt,
                                                      device, seed=s)
                build.reset_launches()
                leaves, obj = _scan_objective(fn, inputs, weights)
                got = torch.autograd.grad(obj, leaves)
                if on_card:
                    torch.cuda.synchronize()
                launches = (build.LAUNCHES[kernel],
                            build.LAUNCHES[f"{kernel}_bwd"])
                leaves, obj = _scan_objective(plain, inputs, weights)
                want = torch.autograd.grad(obj, leaves)
                errs = {}
                for name, g, w in zip(names[kernel], got, want):
                    check(g.dtype == w.dtype == dt and g.shape == w.shape,
                          f"{kernel} gradient {name}: {g.dtype} {g.shape}")
                    err = max_err(g, w)
                    errs[name] = err / max(1.0, float(w.float().abs().max()))
                    check(within(err, w, dname), f"{kernel} s={s} {dname}: "
                          f"{name} differs by {err:.3e} (max "
                          f"{float(w.float().abs().max()):.3g})")
                check(launches == ((1, 1) if on_card else (0, 0)),
                      f"{kernel} s={s} {dname}: launches {launches}")
                case = f"grad s={s} " + " ".join(
                    f"{k}={v}" for k, v in width.items())
                rows.append(dict(kernel=f"{kernel}_bwd", case=case,
                                 dtype=dname, rel_err=errs,
                                 launches=launches))
                log(f"  {kernel + '_bwd':10s} {case:40s} {dname:8s} "
                    + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                    + f" | {launches}")
                del inputs, weights, leaves, obj, got, want
    return rows


# 17e (a): the copies a bf16 ssd backward makes, all dtype casts of small
# tensors or of its outputs: to float32 log_a[:, :, 0], g0, dh_last and
# h_last (ssd_bwd_tail), to bf16 dh0, d log_a, dB and dC.
SSD_BWD_BF16_CASTS = 8


def _ssd_backward_launches(row, listing, inputs, y, hl, h_in, dy, dh, q, nc):
    """17e (a): every launch of the ssd backward, named and timed. Each of
    its three calls is replayed alone under CUDA events (the reversed
    ``repro_ssd``: chunk states, state pass, outputs with d log_a's dot
    products; ``repro_ssd_bwd``: dB and dC; the PyTorch tail), and must add
    up to the whole backward's time within 10%. ``listing`` (the
    profiler's, by full kernel name) must hold each kernel of the design
    once a call (the reversed scan's state, pass and output kernels,
    ``ssd_bwd_kernel``), no flip and no copy but bf16's SSD_BWD_BF16_CASTS
    dtype casts: no flipped or contiguous copy of an operand is left."""
    from repro_torch.kernels.ssd import ops as ssd_ops

    log_a, dtx, bm, cm, h0 = inputs
    d_dtx, g0, r_h_in, dcum = ssd_ops._ssd_rev_cuda(log_a, dy, cm, bm, dh, y,
                                                    dtx, q)
    pieces = {
        "repro_ssd reversed (states, pass, outputs + d log_a dots)":
            lambda: ssd_ops._ssd_rev_cuda(log_a, dy, cm, bm, dh, y, dtx, q),
        "repro_ssd_bwd (dB and dC, one launch)":
            lambda: ssd_ops._ssd_bwd_cuda(log_a, dtx, bm, cm, dy, h0, dh,
                                          h_in, r_h_in, q),
        "tail (dh0, <dh_last, h_last>, reverse cumsum; torch)":
            lambda: ssd_ops.ssd_bwd_tail(log_a, hl, dh, g0, dcum)}
    row["pieces_ms"] = {k: time_ms([fn], iters=8) for k, fn in pieces.items()}
    total = sum(row["pieces_ms"].values())
    check(abs(total - row["ms"]) <= 0.1 * row["ms"],
          f"ssd backward: its calls add up to {total:.4f} ms, the whole "
          f"to {row['ms']:.4f}")
    want = {"ssd_state_kernel": 1, "ssd_out_kernel": 1, "ssd_bwd_kernel": 1}
    if nc > 1:
        want["ssd_pass_kernel"] = 1
    seen, flips, copies = {}, 0, 0
    for name, (_, n) in listing.items():
        # Kernel names carry their template arguments (ssd_out_kernel<float,
        # true>).
        base = short_kernel_name(name).split("<")[0].strip()
        if base.startswith("ssd_"):
            seen[base] = seen.get(base, 0) + round(n)
        flips += round(n) if "flip" in name else 0
        copies += round(n) if "copy_kernel" in name else 0
    check(seen == want, f"ssd backward: launches a call {seen}, want {want}")
    casts = 0 if row["dtype"] == "float32" else SSD_BWD_BF16_CASTS
    check(flips == 0 and copies == casts,
          f"ssd backward: {flips} flip and {copies} copy launches a call, "
          f"want 0 and {casts} (dtype casts)")
    row["flip_launches"], row["copy_launches"] = flips, copies
    del d_dtx, g0, r_h_in, dcum


def scan_backward_listings():
    """17e (a)'s scan backwards at each of their dtypes and SCAN_BWD_SHAPES,
    on 17e (a)'s operands: {"kernel dtype b s": :func:`device_kernel_launches`
    by full kernel name}. :func:`scan_backward_times` runs it in a process of
    its own, where the card's clock has not yet drifted far from the
    host's (the in-process listings of a full run came out empty)."""
    import torch

    from repro_torch.kernels.rglru import ops as rg_ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    out = {}
    for kernel, width in SCAN_GRAD_WIDTHS.items():
        for (dname, dt), (b, s) in itertools.product(
                (("float32", torch.float32), ("bfloat16", torch.bfloat16)),
                SCAN_BWD_SHAPES[kernel]):
            inputs, weights = _scan_grad_operands(kernel, width, s, dt,
                                                  "cuda", seed=7, b=b)
            dy, dh = (w.to(dt) for w in weights)
            if kernel == "ssd":
                q = width["chunk"]
                y, hl, h_in = ssd_ops._ssd_cuda(*inputs, q)

                def bwd():
                    return ssd_ops.ssd_scan_backward(
                        *inputs, y, hl, h_in, dy, dh, q,
                        ssd_ops._ssd_rev_cuda, ssd_ops._ssd_bwd_cuda)
            else:
                a, x, h0 = inputs
                y, _ = rg_ops._rglru_cuda(a, x, h0)

                def bwd():
                    return rg_ops._rglru_bwd_cuda(a, y, h0, dy, dh)
            out[f"{kernel} {dname} {b} {s}"] = device_kernel_launches(
                bwd, calls=3, full_names=True)
    return out


def _fresh_scan_backward_listings():
    """:func:`scan_backward_listings` in a new Python process (the kernels
    already built), its JSON read from the last line it prints."""
    code = ("import json, sys; sys.path.insert(0, 'src'); "
            "import chip_smoke; "
            "print(json.dumps(chip_smoke.scan_backward_listings()))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, "scan backward listings in a fresh process: "
          f"rc {proc.returncode}: {proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def scan_backward_times():
    """17e (a): each scan's backward alone at its full width
    (SCAN_GRAD_WIDTHS), float32 and bf16, at each of its SCAN_BWD_SHAPES:
    the kernel backward (from a forward's saved outputs:
    ``ssd_scan_backward`` on the kernels, ``repro_rglru_bwd``) as a CUDA
    graph, its launches as a fresh process's profiler lists them
    (:func:`scan_backward_listings`; for the ssd also each call timed alone
    and the listing checked: :func:`_ssd_backward_launches`),
    the plain version's backward (autograd of the plain scan, its forward's
    graph kept), the bound, and the earlier time where one was kept; for
    rglru also the simple version (the forward kernels on time-flipped
    copies) and those copies alone. No PyTorch call computes either scan."""
    import torch

    from repro_torch.kernels.rglru import ops as rg_ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    timed = []
    listings = _fresh_scan_backward_listings()
    for kernel, width in SCAN_GRAD_WIDTHS.items():
        _, plain = _scan_fns(kernel, width)
        for (dname, dt), (b, s) in itertools.product(
                (("float32", torch.float32), ("bfloat16", torch.bfloat16)),
                SCAN_BWD_SHAPES[kernel]):
            inputs, weights = _scan_grad_operands(kernel, width, s, dt,
                                                  "cuda", seed=7, b=b)
            eb = inputs[1].element_size()
            dy, dh = (w.to(dt) for w in weights)
            row = dict(kernel=f"{kernel}_bwd", dtype=dname,
                       shape=dict(b=b, s=s, **width), library_ms=None,
                       earlier_ms=SCAN_BWD_EARLIER_MS.get((kernel, dname, b, s)))
            if kernel == "ssd":
                log_a, dtx, bm, cm, h0 = inputs
                q = width["chunk"]
                prob = dict(s=s, h=width["h"], p=width["p"], n=width["n"])
                y, hl, h_in = ssd_ops._ssd_cuda(*inputs, q)

                def bwd():
                    return ssd_ops.ssd_scan_backward(
                        *inputs, y, hl, h_in, dy, dh, q,
                        ssd_ops._ssd_rev_cuda, ssd_ops._ssd_bwd_cuda)
                # log_a, dtx, B, C, h0, y, h_last, dy and dh_last read once;
                # the five gradients written once.
                nb = (2 * sum(t.numel() for t in inputs) + y.numel()
                      + hl.numel() + dy.numel() + dh.numel()) * eb
                flops = b * ssd_ops.bwd_flops(q, prob)
                row["bound_ms"], row["bound_by"] = bound(nb, flops,
                                                         TC_RATE[dname])
            else:
                a, x, h0 = inputs
                y, _ = rg_ops._rglru_cuda(a, x, h0)

                def bwd():
                    return rg_ops._rglru_bwd_cuda(a, y, h0, dy, dh)

                def by_flips():
                    return rg_ops.rglru_scan_backward(a, y, h0, dy, dh,
                                                      rg_ops._rglru_cuda)
                g = torch.empty_like(y)

                def flips():
                    torch.cat([torch.ones_like(a[:, :1]),
                               torch.flip(a[:, 1:], (1,))], dim=1)
                    torch.flip(dy, (1,)).contiguous()
                    torch.flip(g, (1,))
                    torch.cat([h0[:, None], y[:, :-1]], dim=1)
                # a, y and dy read, dx and da written (h0, dh_last, dh0
                # beside them).
                nb = (5 * s * width["f"] + 3 * width["f"]) * eb * b
                row["bound_ms"], row["bound_by"] = bound(
                    nb, 4.0 * b * s * width["f"], dname)
                # The simple version beside the kernel: the forward kernels
                # on flipped copies, and those copies alone.
                row["by_flips_ms"] = time_ms([by_flips], iters=8)
                row["flips_ms"] = time_ms([flips], iters=8)
            row["ms"] = time_ms([bwd], iters=8)
            listing = listings[f"{kernel} {dname} {b} {s}"]
            row["launches_listed"] = {}
            for k, (ms, n) in listing.items():
                short = short_kernel_name(k)
                was = row["launches_listed"].get(short, dict(ms=0.0,
                                                             launches=0.0))
                row["launches_listed"][short] = dict(
                    ms=was["ms"] + ms, launches=was["launches"] + n)
            if kernel == "ssd":
                _ssd_backward_launches(row, listing, inputs, y, hl, h_in, dy,
                                       dh, q, -(-s // q))
            leaves, obj = _scan_objective(plain, inputs, weights)
            row["plain_ms"] = eager_ms(lambda: torch.autograd.grad(
                obj, leaves, retain_graph=True), iters=3, warmup=1)
            del leaves, obj
            timed.append(row)
            log(f"  {kernel}_bwd {dname:8s} b={b} s={s}: {row['ms']:.4f} ms"
                + (f" (earlier design: {row['earlier_ms']:.4f})"
                   if row["earlier_ms"] else "")
                + (f" (the forward kernels on flipped copies "
                   f"{row['by_flips_ms']:.4f}, the copies alone "
                   f"{row['flips_ms']:.4f})" if "flips_ms" in row else "")
                + f", plain backward {row['plain_ms']:.2f}, bound "
                f"{row['bound_ms']:.4f} ({row['bound_by']})")
            for k, v in row.get("pieces_ms", {}).items():
                log(f"    {k:60s} {v:.4f} ms")
            log("    profiler (a fresh process): " + ", ".join(
                f"{k} x{v['launches']:.0f} {v['ms']:.4f}" for k, v in
                sorted(row["launches_listed"].items(),
                       key=lambda kv: -kv[1]["ms"])))
            del inputs, weights, dy, dh, y
    return timed


def _scan_step_launches(cfg, on_card: bool):
    """One remat train step's scan launches: each scan layer's forward
    twice (the recompute) and its backward once."""
    out = {}
    for scan in ("ssd", "rglru"):
        layers = sum(spec.mixer == scan for spec in cfg.layer_pattern)
        if layers:
            out[scan] = 2 * layers if on_card else 0
            out[f"{scan}_bwd"] = layers if on_card else 0
    return out


def scan_train_parity(cfg, params, batch: int, seq: int):
    """17e (b), (d): one batch through ``api.train_loss`` and its backward,
    the kernels against ``impl="reference"`` (the plain versions; for the
    SSD the reference's chunked jnp form, for the RG-LRU its loop): the
    loss and every leaf's gradient within SCAN_TRAIN_GRAD_TOL of max(1,
    max |plain|), every leaf's gradient set and non-zero, and the scans'
    launches of the step (none on the plain path)."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.models import api

    data = _train_batch(cfg, batch, seq)
    leaves = list(_leaves(params))
    on_card = leaves[0].is_cuda
    out = {}
    for impl in ("auto", "reference"):
        for p in leaves:
            p.grad = None
            p.requires_grad_(True)
        build.reset_launches()
        t0 = time.perf_counter()
        loss, _ = api.train_loss(params, cfg, data, impl=impl)
        loss.backward()
        if on_card:
            torch.cuda.synchronize()
        out[impl] = dict(loss=float(loss.detach()), s=time.perf_counter() - t0,
                         launches=dict(build.LAUNCHES),
                         grads=[p.grad for p in leaves])
        del loss
    for p in leaves:
        p.grad = None
        p.requires_grad_(False)
    k, r = out["auto"], out["reference"]
    loss_err = abs(k["loss"] - r["loss"]) / max(1.0, abs(r["loss"]))
    check(loss_err <= SCAN_TRAIN_GRAD_TOL,
          f"{cfg.name} train loss {k['loss']} vs plain {r['loss']}")
    worst, worst_leaf = 0.0, None
    for i, (g, ref) in enumerate(zip(k["grads"], r["grads"])):
        check(g is not None and bool(g.abs().max() > 0),
              f"{cfg.name}: parameter {i} got no gradient through the kernels")
        rel = float((g - ref).abs().max()) / max(1.0, float(ref.abs().max()))
        if rel > worst:
            worst, worst_leaf = rel, i
    check(worst <= SCAN_TRAIN_GRAD_TOL, f"{cfg.name}: gradient leaf "
          f"{worst_leaf} differs by {worst:.3e} x max(1, its max)")
    want = _scan_step_launches(cfg, on_card)
    launches = {name: k["launches"][name] for name in want}
    check(launches == want, f"{cfg.name}: one train step launched "
          f"{launches}, expected {want}")
    check(all(v == 0 for v in r["launches"].values()),
          f"{cfg.name}: the plain path launched kernels: {r['launches']}")
    log(f"  loss {k['loss']:.6f} (plain {r['loss']:.6f}, error {loss_err:.2e});"
        f" {len(leaves)} gradient leaves, all non-zero, worst {worst:.3e} x "
        f"max(1, max) (leaf {worst_leaf}, tol {SCAN_TRAIN_GRAD_TOL:g}); "
        f"launches {k['launches']}; first call {k['s']:.2f} s, plain "
        f"{r['s']:.2f} s")
    del out
    return dict(loss=k["loss"], plain_loss=r["loss"], loss_err=loss_err,
                worst_grad_rel=worst, worst_leaf=worst_leaf,
                launches=k["launches"])


# 17e (c) --profile: the ranges labelled on a profiled mamba2 step.
SCAN_TRAIN_LABELS = {"train.ssd_forward": "ssd forward (+ recompute)",
                     "train.ssd_backward": "ssd backward",
                     "train.adamw": "adamw",
                     "train.head_loss": "head and loss (forward)"}


def scan_train_steps(cfg, params, profile: bool, batch: int, seq: int,
                     steps: int = 5):
    """17e (c): ``steps`` steps of ``make_train_step`` (AdamW, weight decay
    0.01, warmup-cosine) from ``params``: the losses finite (and falling
    over five steps), host ms a step (median of steps 2 on, each ending
    with its loss read back), tokens/s, peak allocated bytes, model FLOP/s
    (6 N tokens) and the scans' launches of the third step; with
    ``profile`` one more step's device ms by group: the einsum products
    (cuBLAS; the projections and the head's backward), ssd forward (with
    its recompute), ssd backward, head and loss, AdamW, other."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from torch.profiler import record_function

    from repro_torch.kernels import build
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import warmup_cosine
    from repro_torch.train.step import make_train_step

    n_params = sum(p.numel() for p in _leaves(params))
    opt_cfg = adamw.AdamWConfig(weight_decay=0.01)
    opt_state = adamw.init_state(params, opt_cfg)
    step_fn = make_train_step(cfg, opt_cfg, lambda s: warmup_cosine(
        s, peak_lr=TRAIN_PEAK_LR, warmup_steps=1, total_steps=steps))
    tokens = batch * seq
    on_card = next(_leaves(params)).is_cuda
    want = _scan_step_launches(cfg, on_card)
    losses, times, launches = [], [], None
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        data = _train_batch(cfg, batch, seq, step=i)
        if i == min(2, steps - 1):
            build.reset_launches()
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, data)
        losses.append(float(metrics["loss"]))
        times.append((time.perf_counter() - t0) * 1e3)
        if i == min(2, steps - 1):
            launches = {k: build.LAUNCHES[k] for k in want}
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    if steps >= 5:
        check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    check(launches == want, f"{cfg.name}: a step launched {launches}, "
          f"expected {want}")
    step_ms = statistics.median(times[1:])
    flops = 6.0 * n_params * tokens
    out = dict(losses=losses, step_ms=times, median_step_ms=step_ms,
               tokens_per_s=tokens / step_ms * 1e3, peak_allocated=peak,
               model_tflops=flops / step_ms / 1e9, n_params=n_params,
               launches=launches)
    log(f"  losses {', '.join(f'{x:.4f}' for x in losses)}; step ms "
        f"{', '.join(f'{x:.1f}' for x in times)}; median (steps 2-"
        f"{steps}) {step_ms:.1f} ms = {out['tokens_per_s']:.0f} tokens/s; "
        f"peak allocated {peak / 2**30:.2f} GiB; model "
        f"{out['model_tflops']:.2f} TFLOP/s (6 N tokens, N = "
        f"{n_params / 1e9:.3f} B); launches {launches}")
    if profile and on_card:
        real_update, real_loss = adamw.apply_updates, transformer.fused_lm_loss
        real_fwd, real_bwd = ssd_ops._SsdScanFn.forward, ssd_ops._SsdScanFn.backward

        def labelled(name, fn):
            def call(*args, **kwargs):
                with record_function(name):
                    return fn(*args, **kwargs)
            return call

        adamw.apply_updates = labelled("train.adamw", real_update)
        transformer.fused_lm_loss = labelled("train.head_loss", real_loss)
        ssd_ops._SsdScanFn.forward = staticmethod(
            labelled("train.ssd_forward", real_fwd))
        ssd_ops._SsdScanFn.backward = staticmethod(
            labelled("train.ssd_backward", real_bwd))
        try:
            data = _train_batch(cfg, batch, seq, step=steps)
            torch.cuda.synchronize()
            with torch_profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                params, opt_state, metrics = step_fn(params, opt_state, data)
                float(metrics["loss"])
                wall = (time.perf_counter() - t0) * 1e3
        finally:
            adamw.apply_updates, transformer.fused_lm_loss = (real_update,
                                                              real_loss)
            ssd_ops._SsdScanFn.forward = staticmethod(real_fwd)
            ssd_ops._SsdScanFn.backward = staticmethod(real_bwd)
        groups, busy = _train_groups(prof, SCAN_TRAIN_LABELS, {
            "torch.matmul (projections, head)":
                "einsum products (projections, head; backward included)",
            "other torch ops": "other torch ops (backward included)"})
        out["profile"] = dict(wall_ms=wall, by_group_ms=groups,
                              kernel_sum_ms=sum(groups.values()),
                              device_busy_ms=busy,
                              device_idle_share=max(0.0, 1 - busy / wall)
                              if busy else None)
        log(f"  profiled step: wall {wall:.1f} ms, device busy {busy:.1f} ms "
            f"(kernel times summed {sum(groups.values()):.1f} ms), idle "
            f"share {out['profile']['device_idle_share']}")
        for g, t in sorted(groups.items(), key=lambda kv: -kv[1]):
            log(f"    {g:56s} {t:.3f} ms"
                + (f" (earlier design: {SCAN_TRAIN_SSD_BWD_EARLIER_MS})"
                   if g == SCAN_TRAIN_LABELS["train.ssd_backward"] else ""))
    del opt_state
    return out


def recurrent_train_phase(profile: bool, device="cuda", mamba2=None,
                          recurrentgemma=None, batch: int = TRAIN_BATCH,
                          seq: int = TRAIN_SEQ):
    """17e: (a) the scans' gradients and backward times, (b)-(c) full-width
    mamba2-2.7b (64 layers, float32, seed 0) at ``batch`` x ``seq`` tokens:
    one batch's loss and gradients, kernels against the plain versions, and
    five train steps; (d) recurrentgemma-9b at full width and RG_TRAIN_UNITS
    of its units: the same check and three steps. ``device="cpu"`` with
    smoke configs rehearses the schedule on the plain versions."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.models import api

    on_card = torch.device(device).type == "cuda"
    out = {}
    t0 = time.perf_counter()
    if on_card:
        out["grad_checks"] = scan_grad_checks()
        out["times"] = scan_backward_times()
    else:
        out["grad_checks"] = scan_grad_checks(
            device, {"ssd": dict(h=3, p=8, n=16, chunk=8),
                     "rglru": dict(f=16)}, (24, 21))
    log(f"  [17e (a): {time.perf_counter() - t0:.1f} s]")
    if mamba2 is None:
        mamba2 = configs.get_arch("mamba2-2.7b")
    if recurrentgemma is None:
        full = configs.get_arch("recurrentgemma-9b")
        recurrentgemma = dataclasses.replace(
            full, n_layers=3 * RG_TRAIN_UNITS,
            layer_pattern=full.layer_pattern[:3 * RG_TRAIN_UNITS]).validate()
    for key, cfg, steps in (("mamba2", mamba2, 5),
                            ("recurrentgemma", recurrentgemma, 3)):
        if on_card:
            _release()
            params, _ = _init_full(cfg)
        else:
            params = api.init_params(cfg, 0, device=device)
        log(f"== 17e {'(b)-(c)' if key == 'mamba2' else '(d)'}: {cfg.name} "
            f"({cfg.n_layers} layers, d_model {cfg.d_model}), one batch of "
            f"{batch} x {seq}: train_loss and backward, kernels vs plain "
            f"versions; {steps} train steps")
        t0 = time.perf_counter()
        res = out[key] = dict(n_layers=cfg.n_layers)
        res["parity"] = scan_train_parity(cfg, params, batch, seq)
        res["steps"] = scan_train_steps(cfg, params, profile and key == "mamba2",
                                        batch, seq, steps=steps)
        del params
        log(f"  [17e {key}: {time.perf_counter() - t0:.1f} s]")
    if on_card:
        _release()
        out["launcher"] = {arch: scan_launcher(arch) for arch in
                           ("mamba2-2.7b", "recurrentgemma-9b")}
    return out


def scan_launcher(arch: str):
    """17e: the train launcher at ``arch``'s smoke config on the card, 20
    steps with a failure at 12 (one restart from the step-10 checkpoint):
    rc 0, and its scan's forward and backward launched."""
    import re
    import shutil
    import tempfile

    scan = "ssd" if arch.startswith("mamba2") else "rglru"
    tmp_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_launcher_"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
           "--steps", "20", "--checkpoint-every", "10", "--fail-at", "12",
           "--checkpoint-dir", str(tmp_dir)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              env=dict(os.environ, PYTHONPATH=str(SRC)),
                              timeout=600, cwd=ROOT)
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)
    counts = {k: int(v) for k, v in re.findall(
        r"'(\w+)': (\d+)", "".join(line for line in proc.stdout.splitlines()
                                    if line.startswith("kernel launches")))}
    check(proc.returncode == 0 and "restarts: 1" in proc.stdout
          and counts.get(scan, 0) > 0 and counts.get(f"{scan}_bwd", 0) > 0,
          f"launcher {arch}: rc {proc.returncode}, launches {counts}\n"
          f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    final = [line for line in proc.stdout.splitlines()
             if line.startswith("final loss")]
    log(f"  launcher --arch {arch} --steps 20 --fail-at 12: "
        f"{final[-1] if final else '?'}; {scan} {counts[scan]}, {scan}_bwd "
        f"{counts[scan + '_bwd']} launches; {time.perf_counter() - t0:.1f} s")
    return dict(final=final[-1] if final else None, launches=counts)


def train_phase(profile: bool):
    """Phase 17 (after 15d): 17a kernel gradients, 17b-c full-width
    qwen2-1.5b, 17d the 100M example and the launcher, 17e the scans'
    gradients and full-width mamba2-2.7b and recurrentgemma-9b training."""
    import shutil
    import tempfile

    from repro_torch import configs

    out = {}
    log("== 17a: gradients through matmul and flash_attention against the "
        "plain versions")
    t0 = time.perf_counter()
    out["grad_checks"] = train_grad_checks()
    out["times"] = train_shape_times()
    log(f"  [17a: {time.perf_counter() - t0:.1f} s]")
    cfg = configs.get_arch("qwen2-1.5b")
    _release()
    params, _ = _init_full(cfg)
    log(f"== 17b: full-width qwen2-1.5b, one batch of {TRAIN_BATCH} x "
        f"{TRAIN_SEQ}: train_loss and backward, kernels vs plain versions")
    t0 = time.perf_counter()
    out["parity"] = train_parity(cfg, params)
    log("== 17c: 5 train steps of full-width qwen2-1.5b (AdamW, "
        "warmup-cosine)")
    out["steps"] = train_steps(cfg, params, profile)
    del params
    _release()
    log(f"  [17b-c: {time.perf_counter() - t0:.1f} s]")
    log("== 17d: Trainer.run on the 100M example config, a restart, the "
        "launcher")
    t0 = time.perf_counter()
    tmp_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        out["example"] = train_example(tmp_dir)
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)
    log(f"  [17d: {time.perf_counter() - t0:.1f} s]")
    log("== 17e: the ssd and rglru gradients on the kernels, full-width "
        "mamba2-2.7b and recurrentgemma-9b (reduced depth) train steps")
    t0 = time.perf_counter()
    out["recurrent"] = recurrent_train_phase(profile)
    log(f"  [17e: {time.perf_counter() - t0:.1f} s]")
    return out


# ---------------------------------------------------------------------------
# Phase 18: the mesh runtime (DistContext, sharding rules, expert-parallel
# MoE, sequence-sharded decode, GPipe, int8 gradients, elastic restore)
# ---------------------------------------------------------------------------
# Each check is held against the one-process path of the same run.
MESH_DECODE_REL = 1e-3       # decode logits, of max |logit|
MESH_MOE_TOL = 2e-3          # logits, absolute and relative (the reference's)
MESH_LOSS_REL = 1e-6
MESH_GRAD_REL = 1e-5         # of each leaf's max |gradient|
# A train check with a control (mamba2's): a leaf that reordering the
# batch's sums alone moves past MESH_GRAD_REL (A_log, dt_bias and in_dt:
# sums that cancel) is held within this many times that move.
MESH_SPREAD = 2.0
MESH_PIPE_LOSS_REL = 2e-4
MESH_PIPE_GRAD_REL = 1e-4
MESH_COMPRESS_SCALES = 3.0   # running mean within 3 quantization scales
MESH_GATHER_REL = 1e-12      # the FSDP pair's gradient, float64, of its max
MESH_MIXER_REL = 1e-5        # the mixers' collectives and blocks, of max
# Full-width geometry of phase 18: qwen2-1.5b cut to 2 of its 28 layers
# (18a too: each Trainer writes its final checkpoint, 19 GB at 28 layers,
# and one call to the card may write 45 GiB in all; 4 layers put phase 18
# near or over its 130 s once its ranks ran tensor-parallel), an
# even count for GPipe's two stages; deepseek-moe-16b to 3 (layer 0 dense,
# two MoE layers).
MESH_QWEN2_LAYERS = 2
MESH_DEEPSEEK_LAYERS = 3
# The recurrent mixers at full width: mamba2-2.7b at 2 of its 64 layers,
# recurrentgemma-9b at 3 of its 38 (one unit: rglru, rglru, local_attn;
# served only: its 256000 x 4096 embedding's gradients would cross gloo's
# host staging every step).
MESH_MAMBA2_LAYERS = 2
MESH_RGEMMA_LAYERS = 3
# The encoder-decoder at full width: whisper-large-v3 at 2 of its 32
# encoder and 2 of its 32 decoder layers (``_first_layers`` cuts both).
MESH_WHISPER_LAYERS = 2
# 18b's 2 x 2 train step (phase 19 (c) counts the same step).
MESH_TRAIN = dict(mesh=(2, 2), batch=8, seq=256, microbatches=2)
# The kernels a served check counts a rank's launches of.
MESH_SERVE_KERNELS = ("matmul", "flash_attention", "flash_decode", "ssd",
                      "rglru")


def _np32(t):
    return t.detach().float().cpu().numpy()


def _flat(tree):
    from repro_torch.checkpoint.manager import _flatten

    return _flatten(tree)


def _mesh_params(src, cfg, device, ctx=None):
    """A check's parameters: ``{"path"}``, a tree ``torch.save`` wrote (the
    CPU tests' parameters, converted from the JAX package's), or ``{"seed"}``
    (random, made on the device; with ``"stages"`` stacked for the
    pipeline). With a tensor-parallel ``ctx``, the rank's blocks
    (``api.shard_params``)."""
    import torch

    from repro_torch.distributed import pipeline
    from repro_torch.models import api
    from repro_torch.optim.adamw import tree_map

    if src.get("path"):
        tree = torch.load(src["path"])
        return api.shard_params(tree_map(lambda t: t.to(device), tree),
                                cfg, ctx)
    if src.get("stages"):
        # The model's own layers, stacked: init_pipeline_params draws with
        # the reference's fan-in of the stacked shape (the stage count),
        # weights so large at full width that the float32 gradients of
        # stage 0 keep few digits (kernels and plain versions disagree).
        return pipeline.stage_params(
            api.init_params(cfg, src["seed"], device=device), src["stages"])
    return api.init_params(cfg, src["seed"], device=device, ctx=ctx)


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _measured(device, fn):
    """``fn()`` and the bytes it held at its peak above what was allocated
    before it (0 off the card)."""
    import torch

    if torch.device(device).type != "cuda":
        return fn(), 0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def _mesh_tokens(seed: int, shape, vocab: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    return rng.integers(2, vocab, size=shape).astype(np.int64)


def _mesh_frames(seed: int, cfg, rows: int):
    """An encoder-decoder's frame embeddings ``[rows, S_enc, D]`` (the
    conv frontend's output, the reference's stub) from a numpy seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (rows, cfg.encoder.seq_len, cfg.d_model)).astype(np.float32)


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _mesh_decode(rank, device, out_dir, state, *, cfg, mesh, batch,
                 prompt_len, steps, max_len, params, token_seed,
                 teacher=False, sharded=True, ring_local=False, fsdp=True,
                 frames_seed=None, keep_state=False):
    """This rank's rows served on the mesh, tensor-parallel on its blocks
    (with ``fsdp``, its data blocks too, each layer gathered as it runs;
    with ``sharded``, the sequence-sharded decode:
    ``flags.set_perf(decode_sharded=True)``; ``ring_local``, ring caches on
    the windowed layers; ``frames_seed``, an encoder-decoder's frames,
    :func:`_mesh_frames`), then the same rows on the
    whole parameters without the mesh. Each run's logits, tokens, kernel
    launches, parameter bytes and peak bytes above what was held before it
    are written; with ``keep_state``, an encoder-decoder's serve state
    after the mesh run's last step (``state/<key>/<layer>``)."""
    import numpy as np
    import torch

    from repro_torch.distributed import collectives
    from repro_torch.distributed import sharding_rules as rules
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import api, flags

    ctx = rules.make_context(make_local_mesh(*mesh, device=device), fsdp)
    whole = _mesh_params(params, cfg, device)
    blocks = api.shard_params(whole, cfg, ctx)
    toks = torch.from_numpy(rules.local_rows(_mesh_tokens(
        token_seed, (batch, prompt_len + steps), cfg.vocab_size), ctx))
    extra = {} if frames_seed is None else {"frames": rules.local_rows(
        _mesh_frames(frames_seed, cfg, batch), ctx)}
    res = {}

    def run(p, c, on):
        flags.set_perf(decode_sharded=on)
        before = dict(build.LAUNCHES)
        logits, st = api.prefill(p, cfg, {"tokens": toks[:, :prompt_len],
                                          **extra},
                                 max_len, ring_local=ring_local, ctx=c)
        coll[:] = [0.0, 0]                   # the decode steps' collectives
        outs, picked, step_s = [], [], []
        decodes = build.LAUNCHES["flash_decode"]
        for i in range(steps):
            tok = (toks[:, prompt_len + i].to(logits.device) if teacher
                   else logits[:, :cfg.vocab_size].argmax(-1))
            picked.append(tok)
            _sync(device)
            t0 = time.perf_counter()
            logits, st = api.decode_step(p, cfg, tok[:, None], st, ctx=c)
            _sync(device)
            step_s.append(time.perf_counter() - t0)
            outs.append(logits)
        launches = np.array([build.LAUNCHES[k] - before[k]
                             for k in MESH_SERVE_KERNELS])
        return (torch.stack(outs), torch.stack(picked), st,
                build.LAUNCHES["flash_decode"] - decodes, step_s, launches)

    coll = [0.0, 0]
    real = collectives.all_reduce

    def timed_all_reduce(x, op="sum", group=None):
        _sync(device)
        t0 = time.perf_counter()
        y = real(x, op, group)
        _sync(device)
        coll[0] += time.perf_counter() - t0
        coll[1] += 1
        return y

    try:
        with torch.no_grad():
            collectives.all_reduce = timed_all_reduce
            try:
                (logits, picked, st, launches, step_s, kernels), peak = \
                    _measured(device, lambda: run(blocks, ctx, sharded))
            finally:
                collectives.all_reduce = real
                flags.set_perf(decode_sharded=False)
            if isinstance(st, dict):
                # An encoder-decoder's state: the rank's heads of each
                # layer's self and cross caches.
                kv = [{"k": k} for k in st["self_k"]]
                rec = []
                res["state_shapes"] = np.array(json.dumps(
                    {"self_k": list(st["self_k"][0].shape),
                     "self_v": list(st["self_v"][0].shape),
                     "cross_k": list(st["cross"][0][0].shape),
                     "cross_v": list(st["cross"][0][1].shape)}))
                res["state_own"] = np.array(all(
                    t._base is None and t.is_contiguous()
                    for t in st["self_k"] + st["self_v"]
                    + [x for pair in st["cross"] for x in pair]))
                if keep_state:
                    for key in ("self_k", "self_v"):
                        for li, t in enumerate(st[key]):
                            res[f"state/{key}/{li}"] = _np32(t)
                    for li, (ck, cv) in enumerate(st["cross"]):
                        res[f"state/cross_k/{li}"] = _np32(ck)
                        res[f"state/cross_v/{li}"] = _np32(cv)
                    res["state/pos"] = np.array(int(st["pos"]))
            else:
                kv = [c for c in st if "k" in c]
                rec = [c for c in st if "k" not in c]
            res["sliced_layers"] = np.array(
                sum("kv_pos" in c for c in kv))
            res["s_loc"] = np.array(kv[0]["k"].shape[2] if kv else 0)
            res["kv_heads"] = np.array(kv[0]["k"].shape[1] if kv else 0)
            # The rank's SSD heads or RG-LRU features in its first
            # recurrent state, and every recurrent leaf's shape.
            res["state_width"] = np.array(rec[0]["h"].shape[1] if rec
                                          else 0)
            if "state_shapes" not in res:
                res["state_shapes"] = np.array(json.dumps(
                    {k: list(t.shape) for k, t in rec[0].items()} if rec
                    else {}))
            res["logits"] = _np32(logits)
            res["tokens"] = picked.cpu().numpy()
            res["launches"] = np.array(launches)
            res["kernel_launches"] = kernels
            res["param_bytes"] = np.array(_tree_bytes(blocks))
            res["run_peak_bytes"] = np.array(peak)
            res["collective_ms_step"] = np.array(coll[0] * 1e3 / steps)
            res["collectives_step"] = np.array(coll[1] / steps)
            res["step_ms"] = np.array(statistics.median(step_s) * 1e3)
            del st, blocks
            (ref, ref_tok, st, _, _, kernels), peak = _measured(
                device, lambda: run(whole, None, False))
            res["ref_logits"] = _np32(ref)
            res["ref_tokens"] = ref_tok.cpu().numpy()
            res["ref_kernel_launches"] = kernels
            res["ref_param_bytes"] = np.array(_tree_bytes(whole))
            res["ref_run_peak_bytes"] = np.array(peak)
            del st
    finally:
        flags.set_perf(decode_sharded=False)
    return res


def _mesh_moe(rank, device, out_dir, state, *, cfg, mesh, batch, seq,
              params, token_seed, single=True, keep=True):
    """Expert-parallel MoE forward of this rank's rows (the rank's blocks
    of the model split, FSDP off: its experts, its columns of the shared
    experts and of the rest) against the local all-experts forward of the
    same rows."""
    import numpy as np
    import torch

    from repro_torch.distributed import sharding_rules as rules
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import api
    from repro_torch.models import transformer as T

    ctx = rules.make_context(make_local_mesh(*mesh, device=device),
                             fsdp=False)
    whole = _mesh_params(params, cfg, device)
    blocks = api.shard_params(whole, cfg, ctx)
    toks = torch.from_numpy(rules.local_rows(
        _mesh_tokens(token_seed, (batch, seq), cfg.vocab_size), ctx)).to(
        device)
    res = {"param_bytes": np.array(_tree_bytes(blocks)),
           "ref_param_bytes": np.array(_tree_bytes(whole))}
    with torch.no_grad():
        y = T.forward(blocks, cfg, toks, ctx=ctx).logits.float()
        del blocks
        if single:
            ref = T.forward(whole, cfg, toks).logits.float()
            res["err"] = np.array(float((y - ref).abs().max()))
            res["bound"] = np.array(float(
                (MESH_MOE_TOL + MESH_MOE_TOL * ref.abs()).min()))
            res["ok"] = np.array(bool(torch.all(
                (y - ref).abs() <= MESH_MOE_TOL + MESH_MOE_TOL * ref.abs())))
            res["scale"] = np.array(float(ref.abs().max()))
            if keep:
                res["ref_logits"] = _np32(ref)
        if keep:
            res["logits"] = _np32(y)
    return res


def _train_batches(cfg, batch, seq, steps, seed):
    """``steps`` global batches of the data pipeline; an encoder-decoder's
    with ``frames`` beside the tokens (:func:`_mesh_frames`, seeded by the
    data seed and the step)."""
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import api

    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                    global_batch=batch, seed=seed)
    out = [make_batch(dc, s) for s in range(steps)]
    if api.is_encdec(cfg):
        out = [dict(b, frames=_mesh_frames(seed * 1000 + s, cfg, batch))
               for s, b in enumerate(out)]
    return out


def _mesh_train(rank, device, out_dir, state, *, cfg, mesh, batch, seq,
                microbatches, steps, lr, params, data_seed, single=True,
                keep=False, fsdp=True, saved_as=None, control=False):
    """``steps`` mesh train steps on the rank's blocks (this rank's rows;
    with ``fsdp``, the default, its data blocks too, each layer gathered
    as it runs and its gradients reduce-scattered; gradients averaged over
    the batch axes, the clip's norm over each leaf's axes) and, with
    ``single``, rank 0's one-process steps on the global batch from the
    same whole parameters, held against the first step's gradients and
    the last parameters gathered whole (``unshard_tree``, collective), the
    losses and the first step's clip norm. Every rank writes its first
    step's kernel launches; rank 0 also its second step's (and the one
    process's, both) and its peak bytes
    above what it held before the step plus the step's arguments (the dry
    run's count of the same step, phase 19). With ``saved_as``, the
    trained blocks, their shardings and the parameters gathered whole are
    kept in the rank's state under that key for ``_mesh_save``. With
    ``keep``, rank 0's gathered arrays are written. With ``control`` (and
    ``single``), rank 0 also holds the first step's gradients against one
    process that sums them as the batch ranks do
    (:func:`_batch_split_grads`), and that control against the plain
    one-process step, leaf by leaf: what reordering the sums alone moves
    (``mesh_verdicts`` holds each leaf within ``MESH_SPREAD`` times that
    spread where it exceeds the bound)."""
    import numpy as np
    import torch

    from repro_torch.distributed import collectives
    from repro_torch.distributed import sharding_rules as rules
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import api
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.train.step import make_train_step

    ctx = rules.make_context(make_local_mesh(*mesh, device=device), fsdp)
    sh = api.rank_shardings(cfg, ctx)
    opt_cfg = adamw.AdamWConfig()
    need_grads = single or keep

    def lr_fn(step):
        return torch.tensor(lr, dtype=torch.float32)

    batches = _train_batches(cfg, batch, seq, steps, data_seed)
    res = {}

    def run(c, feed, gather):
        p = _mesh_params(params, cfg, device, ctx=c)
        opt = adamw.init_state(p, opt_cfg)
        step = make_train_step(cfg, opt_cfg, lr_fn, microbatches, ctx=c)
        losses, norms, times, grads, second = [], [], [], None, {}
        first, first_peak = {}, 0
        for i, b in enumerate(batches):
            _sync(device)
            t0 = time.perf_counter()
            if i == 0 and need_grads:
                # The step's two halves, to keep its averaged gradients;
                # its peak as the whole step's (the dry run counts that).
                args = (p, opt, feed(b))
                before = dict(build.LAUNCHES)

                def halves():
                    m, g = step.grad_step(args[0], args[2])
                    return m, g, adamw.apply_updates(
                        args[0], g, args[1], opt_cfg,
                        lr_fn(args[1]["step"]), split=step.split,
                        group=step.group)

                (m, g, (p, opt, om)), peak = _measured(device, halves)
                first = {k: build.LAUNCHES[k] - before[k] for k in before
                         if build.LAUNCHES[k] != before[k]}
                first_peak = peak + _storage_bytes(list(args))
                del args
                m = dict(m, **om)
                whole = _flat(gather(g))         # collective: every rank
                if rank == 0:
                    grads = {k: _np32(v) for k, v in whole.items()}
                del g, whole
            else:
                args = (p, opt, feed(b))
                before = dict(build.LAUNCHES)
                (p, opt, m), peak = _measured(device, lambda: step(*args))
                second = dict(
                    peak=peak + _storage_bytes(list(args)),
                    launches={k: build.LAUNCHES[k] - before[k]
                              for k in before
                              if build.LAUNCHES[k] != before[k]})
                del args
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            times.append(time.perf_counter() - t0)
        return (p, grads, np.array(losses), np.array(norms), times,
                (first, first_peak), second)

    p, grads, losses, norms, times, (first, first_peak), second = run(
        ctx, lambda b: rules.local_batch(b, ctx),
        lambda t: rules.unshard_tree(t, sh))
    res["fsdp"] = np.array(fsdp)
    res["step1_launches"] = np.array(json.dumps(first))
    res["step1_peak_bytes"] = np.array(first_peak)
    res["losses"] = losses
    res["grad_norms"] = norms
    res["step_ms"] = np.array(statistics.median(times) * 1e3)
    res["param_bytes"] = np.array(_tree_bytes(p))
    if second:
        res["step2_peak_bytes"] = np.array(second["peak"])
        res["step2_launches"] = np.array(json.dumps(second["launches"]))
    # Ranks of one model coordinate hold the same blocks of every leaf that
    # is whole over the data axis (the model coordinate of each rank beside
    # the sum of those blocks; under FSDP few or no such leaves).
    kept = []
    tree_map(lambda t, s_: kept.append(t) if "data" not in s_.axes else None,
             p, sh)
    total = sum(float(t.double().abs().sum()) for t in kept)
    sums = collectives.all_gather(
        torch.tensor([total, ctx.model_index], dtype=torch.float64), 0)
    res["param_abs_sums"] = sums.numpy().reshape(-1, 2)
    whole = rules.unshard_tree(p, sh)
    if saved_as is not None:
        state[saved_as] = (whole, p, sh)
    del p
    if rank == 0 and keep:
        res.update({f"grads/{k}": v for k, v in grads.items()})
        res.update({f"params/{k}": _np32(v) for k, v in _flat(whole).items()})
    if single and rank == 0:
        q, g1, l1, n1, _, (first1, _), second1 = run(None, lambda b: b,
                                                     lambda t: t)
        res["ref_losses"] = l1
        res["ref_param_bytes"] = np.array(_tree_bytes(q))
        res["ref_step1_launches"] = np.array(json.dumps(first1))
        if second1:
            res["ref_step2_launches"] = np.array(json.dumps(
                second1["launches"]))
        res["loss_rel"] = np.array(float(np.abs(losses - l1).max()
                                         / np.abs(l1).max()))
        # The clip's norm of the first step (the same parameters).
        res["ref_grad_norms"] = n1
        res["norm_rel"] = np.array(abs(norms[0] - n1[0]) / abs(n1[0]))
        rels = {k: _grad_rel(grads[k], g1[k]) for k in g1}
        res["grad_rel"] = np.array(max(rels.values()))
        res["grad_rels"] = np.array(json.dumps(rels))
        res["grad_worst"] = np.array(", ".join(
            f"{k} {rels[k]:.2e}" for k in sorted(rels, key=rels.get)[-6:]))
        mine = _flat(whole)
        res["param_diff"] = np.array(max(float((mine[k] - v).abs().max())
                                         for k, v in _flat(q).items()))
        del q
        if control:
            ctl = _batch_split_grads(cfg, params, device, batches[0],
                                     ctx.axis_size("batch"), microbatches)
            rels = {k: _grad_rel(grads[k], ctl[k]) for k in ctl}
            res["grad_rel_control"] = np.array(max(rels.values()))
            res["control_worst"] = np.array(", ".join(
                f"{k} {rels[k]:.2e}"
                for k in sorted(rels, key=rels.get)[-6:]))
            rels = {k: _grad_rel(ctl[k], g1[k]) for k in g1}
            res["control_rel"] = np.array(max(rels.values()))
            res["control_rels"] = np.array(json.dumps(rels))
            res["control_plain_worst"] = np.array(", ".join(
                f"{k} {rels[k]:.2e}"
                for k in sorted(rels, key=rels.get)[-6:]))
            del ctl
        del g1
    del grads
    return res


def _batch_split_grads(cfg, params, device, batch, ranks: int,
                       microbatches: int):
    """One process's gradients of ``batch`` summed in the order a mesh of
    ``ranks`` batch ranks sums them: each rank's rows one microbatch at a
    time (``make_grad_step`` without a mesh, at the rank's batch), the
    microbatches summed a rank, then the ranks, over their count. A sum
    that cancels (mamba2's ``A_log`` and ``dt_bias`` gradients) moves with
    that order alone; a fault does not hide behind it."""
    import torch

    from repro_torch.optim.adamw import tree_map
    from repro_torch.train.step import make_grad_step

    p = _mesh_params(params, cfg, device)
    step = make_grad_step(cfg, 1)
    rows = len(batch["tokens"]) // ranks
    total = None
    for r in range(ranks):
        mine = {k: v[r * rows:(r + 1) * rows] for k, v in batch.items()}
        part = None
        for m in range(microbatches):
            _, g = step(p, {k: v[m::microbatches] for k, v in mine.items()})
            part = g if part is None else tree_map(torch.add, part, g)
        total = part if total is None else tree_map(torch.add, total, part)
    n = ranks * microbatches
    return {k: _np32(v / n) for k, v in _flat(total).items()}


def _mesh_save(rank, device, out_dir, state, *, step, ckpt, trained):
    """The blocks that the ``_mesh_train`` given ``saved_as=trained``
    trained (its mesh's shardings, FSDP's data blocks among them) saved
    (gathered whole, rank 0 writes); rank 0 holds what was written against
    the parameters gathered whole after training."""
    import numpy as np

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.optim.adamw import tree_leaves

    p, blocks, sh = state.pop(trained)
    held = sum(t.numel() for t in tree_leaves(blocks))
    whole = sum(t.numel() for t in tree_leaves(p))
    cm = CheckpointManager(ckpt, async_save=False)
    _sync(device)
    t0 = time.perf_counter()
    cm.save(step, {"params": blocks}, shardings={"params": sh},
            write=rank == 0)
    save_ms = (time.perf_counter() - t0) * 1e3
    exact = True
    if rank == 0:
        # What was written is what the ranks trained, whole, exactly.
        path = Path(ckpt) / f"step_{step:010d}" / "arrays.npz"
        with np.load(path) as z:
            exact = all(np.array_equal(z[f"params/{k}"], v.cpu().numpy())
                        for k, v in _flat(p).items())
    return {"held": np.array(held), "whole": np.array(whole),
            "written_exact": np.array(exact), "save_ms": np.array(save_ms)}


def _meta_params(cfg):
    import torch

    from repro_torch.models import api
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import ParamDef

    def walk(d):
        if isinstance(d, ParamDef):
            return torch.empty(d.shape, dtype=torch.float32, device="meta")
        if isinstance(d, dict):
            return {k: walk(v) for k, v in d.items()}
        return [walk(v) for v in d]
    assert not api.is_encdec(cfg)
    return walk(T.model_defs(cfg))


def _mesh_restore(rank, device, out_dir, state, *, cfg, mesh, batch, seq,
                  microbatches, lr, data_seed, ckpt):
    """Elastic restore: the checkpoint ``_mesh_save`` wrote from its mesh's
    blocks, read onto this mesh's shardings (``api.rank_shardings``: each
    rank its blocks, equal to the saved arrays' exactly), then one more
    train step on this mesh, on the restored blocks."""
    import numpy as np
    import torch

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.distributed import sharding_rules as rules
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import api
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.step import make_train_step

    ctx = rules.make_context(make_local_mesh(*mesh, device=device))
    template = _meta_params(cfg)
    sh = api.rank_shardings(cfg, ctx)
    cm = CheckpointManager(ckpt)
    _sync(device)
    t0 = time.perf_counter()
    params = cm.restore({"params": template}, shardings={"params": sh},
                        device=device)["params"]
    _sync(device)
    restore_ms = (time.perf_counter() - t0) * 1e3
    # Each block against the saved whole array (which the save checked
    # against the trained parameters).
    got, shs = _flat(params), _flat(sh)
    with np.load(Path(ckpt) / f"step_{cm.latest_step():010d}" /
                 "arrays.npz") as z:
        want = {k: torch.from_numpy(z[f"params/{k}"]) for k in got}
    exact = all(torch.equal(got[k].cpu(), shs[k].local_block(want[k]))
                for k in want)
    shaped = all(tuple(got[k].shape) == shs[k].shard_shape(want[k].shape)
                 for k in want)
    held = sum(t.numel() for t in tree_leaves(params))
    whole = sum(t.numel() for t in want.values())
    del want, got
    opt_cfg = adamw.AdamWConfig()
    opt = adamw.init_state(params, opt_cfg)
    step = make_train_step(cfg, opt_cfg,
                           lambda s: torch.tensor(lr, dtype=torch.float32),
                           microbatches, ctx=ctx)
    b = _train_batches(cfg, batch, seq, 1, data_seed + 1)[0]
    before = [t.clone() for t in tree_leaves(params)]
    params, opt, metrics = step(params, opt, rules.local_batch(b, ctx))
    moved = sum(float((a - t).abs().sum())
                for a, t in zip(before, tree_leaves(params)))
    return {"exact": np.array(exact), "shaped": np.array(shaped),
            "held": np.array(held), "whole": np.array(whole),
            "loss": np.array(float(metrics["loss"])),
            "moved": np.array(moved), "restore_ms": np.array(restore_ms)}


def _mesh_gpipe(rank, device, out_dir, state, *, cfg, n_stages,
                microbatches, batch, seq, params, token_seed, keep=False):
    """The GPipe loss and its gradients on this rank's stage (its block of
    the stacked layers), held here against the sequential loss and
    gradients of the whole parameters (each rank its stage's and the
    replicated leaves'); with ``keep`` the gradients are written too."""
    import numpy as np
    import torch

    from repro_torch.distributed import pipeline
    from repro_torch.distributed import sharding_rules as rules
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.adamw import tree_leaves, tree_map

    m = make_mesh((n_stages,), ("pod",), device=device)
    whole = _mesh_params(dict(params, stages=n_stages), cfg, device)
    local = rules.shard_tree(whole, pipeline.pipeline_shardings(whole, m))
    tok = torch.from_numpy(_mesh_tokens(token_seed, (batch, seq),
                                        cfg.vocab_size)).to(device)
    loss_fn = pipeline.make_pipeline_loss(cfg, m, n_stages, microbatches)
    res = {}

    def grads_of(fn, tree):
        live = tree_map(lambda t: t.detach().requires_grad_(True), tree)
        loss = fn(live)
        g = torch.autograd.grad(loss, tree_leaves(live))
        it = iter(g)
        return float(loss.detach()), tree_map(lambda _: next(it), tree)

    _sync(device)
    t0 = time.perf_counter()
    loss, g = grads_of(lambda t: loss_fn(t, tok, tok), local)
    _sync(device)
    res["ms"] = np.array((time.perf_counter() - t0) * 1e3)
    res["loss"] = np.array(loss)
    ref, rg = grads_of(lambda t: pipeline.sequential_reference_loss(
        cfg, t, tok, tok), whole)
    res["ref_loss"] = np.array(ref)
    got, want = _flat(g), _flat(rg)
    errs = []
    for k, v in got.items():
        w = want[k][rank:rank + 1] if k.startswith("stages/") else want[k]
        errs.append((_grad_rel(_np32(v), _np32(w)), k))
        if not bool(v.abs().max() > 0):
            errs.append((float("inf"), f"{k} (all zeros)"))
    errs.sort(reverse=True)
    res["grad_rel"] = np.array(errs[0][0])
    res["worst"] = np.array([f"{e:.2e} {k}" for e, k in errs[:6]])
    if keep:
        res.update({f"grads/{k}": _np32(v) for k, v in got.items()})
    return res


def _mesh_compress(rank, device, out_dir, state, *, shape, rounds, seed):
    """``compress_psum`` over the group: one round of different gradients
    against the reference's formula in numpy, then ``rounds`` rounds of one
    gradient whose error feedback keeps the running mean near the true."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.optim import compression

    n = dist.get_world_size()

    def grad(r):
        rng = np.random.default_rng(seed + r)
        return (rng.standard_normal(shape) * 1e-3).astype(np.float32)

    g = torch.from_numpy(grad(rank)).to(device)
    out, _ = compression.compress_psum({"w": g},
                                       compression.init_error({"w": g}))
    # The reference's order of operations on every rank's gradient, float32.
    qs, scales = [], []
    for r in range(n):
        x = grad(r)
        s = np.float32(np.abs(x).max()) / np.float32(127.0) + \
            np.float32(1e-12)
        qs.append(np.clip(np.round(x / s), -127, 127).astype(np.int32))
        scales.append(s)
    ssum = np.float32(sum(scales))
    want = (sum(qs).astype(np.float32) * (ssum / np.float32(n))) / \
        np.float32(n)
    one_err = float(np.abs(_np32(out["w"]) - want).max())
    step = float(ssum / n / n)
    # Error feedback over rounds, one gradient on every rank.
    g0 = torch.from_numpy(grad(0)).to(device)
    err = compression.init_error({"w": g0})
    tot_true = np.zeros(shape)
    tot_deq = np.zeros(shape)
    for _ in range(rounds):
        o, err = compression.compress_psum({"w": g0}, err)
        tot_true += grad(0)
        tot_deq += _np32(o["w"])
    scale = float(np.abs(grad(0)).max() / 127.0)
    return {"one_round_err": np.array(one_err), "one_round_step":
            np.array(step), "drift": np.array(float(
                np.abs(tot_true - tot_deq).max())),
            "scale": np.array(scale)}


def _mesh_gather_grad(rank, device, out_dir, state, *, shape, dim, seed):
    """FSDP's collective pair on this group, in float64: each rank's block
    ``x_r`` (``shape``, drawn from ``seed`` and the rank) gathered along
    ``dim`` (``collectives.gather_from_group``), and autograd's gradient of
    ``sum(w_r * gathered)`` (``w_r`` a rank's own weights) against block
    ``r`` of the ranks' summed ``w`` (what its backward's reduce-scatter
    gives); ``collectives.reduce_scatter`` of ``w_r`` against the same.
    Every rank draws every rank's arrays, so each holds the exact sums."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import collectives

    n = dist.get_world_size()

    def draw(r, which, size):
        rng = np.random.default_rng([seed, r, which])
        return torch.from_numpy(rng.standard_normal(size))

    whole = list(shape)
    whole[dim] *= n
    xs = [draw(r, 0, shape) for r in range(n)]
    ws = [draw(r, 1, whole) for r in range(n)]
    x = xs[rank].to(device).requires_grad_(True)
    w = ws[rank].to(device)
    y = collectives.gather_from_group(x, dim, dist.group.WORLD)
    (grad,) = torch.autograd.grad((y * w).sum(), x)
    want = torch.chunk(sum(ws), n, dim)[rank]
    scattered = collectives.reduce_scatter(w, dim, dist.group.WORLD)
    return {
        "gather_err": np.array(float((y.detach().cpu()
                                      - torch.cat(xs, dim)).abs().max())),
        "grad_err": np.array(float((grad.cpu() - want).abs().max())),
        "scatter_err": np.array(float((scattered.cpu() - want).abs().max())),
        "scale": np.array(float(want.abs().max())),
        "shaped": np.array(tuple(grad.shape) == tuple(shape)
                           and tuple(y.shape) == tuple(whole)),
    }


def _mesh_mixer_grads(rank, device, out_dir, state, *, shape, seed,
                      ssm_cfg, rglru_cfg):
    """The recurrent mixers' model-axis collectives on this group (a 1 x n
    mesh), on float64 host tensors (the scan kernels take no float64; the
    norms and the SSD discretisation compute in float32, as the model's
    do), each against one process's arithmetic on every rank's arrays:

    * ``collectives.sum_scatter_from_group`` of each rank's ``x_r``
      (``shape``, [..., 2, F]) along the last dim: forward the rank's block
      of the ranks' sum, and the gradient of ``sum(w_r * y_r)`` the ranks'
      ``w`` gathered; beside it the broken pair, ``sum_from_group`` and a
      slice, whose gradient misses every other rank's block;
    * ``ssm._split_rms_norm`` over the rank's columns of a whole ``x``:
      forward and the gradient of ``sum(c * out)`` against
      ``layers.rms_norm`` of the whole, and the same norm summed with
      ``sum_from_group`` (backward passes each rank's partial cotangent);
    * one SSD block of ``ssm_cfg`` and one RG-LRU block of ``rglru_cfg`` on
      the rank's blocks (``api.rank_shardings``) against the whole block:
      outputs, and every parameter's gradient (the rank's block of the
      whole gradient) and the input's, relative to each one's max; for the
      SSD block also with B and C not entering through ``copy_to_group``
      and with the broken norm."""
    import types
    from unittest import mock

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import collectives
    from repro_torch.distributed import sharding_rules as rules
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import api
    from repro_torch.models import rglru as rglru_mod
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models.layers import rms_norm
    from repro_torch.optim.adamw import tree_leaves, tree_map

    n = dist.get_world_size()
    group = dist.group.WORLD
    res = {}

    def draw(r, which, size):
        rng = np.random.default_rng([seed, r, which])
        return torch.from_numpy(rng.standard_normal(size))

    def err(a, b):
        return float((a - b).abs().max())

    # (a) The reduce-scatter whose backward all-gathers.
    fb = shape[-1] // n
    xs = [draw(r, 0, shape) for r in range(n)]
    ws = [draw(r, 1, shape[:-1] + (fb,)) for r in range(n)]
    x = xs[rank].clone().requires_grad_(True)
    y = collectives.sum_scatter_from_group(x, -1, group)
    (grad,) = torch.autograd.grad((y * ws[rank]).sum(), x)
    want = torch.cat(ws, -1)
    x2 = xs[rank].clone().requires_grad_(True)
    y2 = collectives.sum_from_group(x2, group)[..., rank * fb:
                                              (rank + 1) * fb]
    (broken,) = torch.autograd.grad((y2 * ws[rank]).sum(), x2)
    res.update(
        rs_fwd_err=np.array(err(y.detach(), sum(xs)[..., rank * fb:
                                                   (rank + 1) * fb])),
        rs_grad_err=np.array(err(grad, want)),
        rs_slice_grad_err=np.array(err(broken, want)),
        rs_scale=np.array(float(want.abs().max())))

    # (b) The norm over the whole width, its mean of squares summed.
    d = 4 * n
    xw, ww, cw = draw(n, 2, (3, 5, d)), draw(n, 3, (d,)), draw(n, 4,
                                                                 (3, 5, d))
    whole = xw.clone().requires_grad_(True)
    out = rms_norm(whole, ww, 1e-6)
    (g_whole,) = torch.autograd.grad((out * cw).sum(), whole)
    cols = slice(rank * d // n, (rank + 1) * d // n)

    def split_norm(sums):
        part = xw[..., cols].clone().requires_grad_(True)
        with mock.patch.object(ssm_mod, "collectives", sums):
            o = ssm_mod._split_rms_norm(part, ww[cols], 1e-6, d, group)
        (g,) = torch.autograd.grad((o * cw[..., cols]).sum(), part)
        return o.detach(), g

    o, g = split_norm(collectives)
    _, g_plain = split_norm(types.SimpleNamespace(
        sum_partials=collectives.sum_from_group))
    res.update(
        norm_fwd_err=np.array(err(o, out.detach()[..., cols])),
        norm_grad_err=np.array(err(g, g_whole[..., cols])),
        norm_plain_grad_err=np.array(err(g_plain, g_whole[..., cols])),
        norm_scale=np.array(float(g_whole.abs().max())))

    # (c) Whole blocks on the rank's blocks.
    ctx = rules.make_context(make_local_mesh(1, n, device="cpu"), fsdp=False)

    def block_rels(cfg, key, forward, shim=None):
        mixer = {"ssm": "ssd", "rglru": "rglru"}[key]
        li = next(i for i, s_ in enumerate(cfg.layers()) if s_.mixer == mixer)
        p = tree_map(lambda t: t.double(), api.init_params(
            cfg, seed, device="cpu")["layers"][li][key])
        sh = api.rank_shardings(cfg, ctx)["layers"][li][key]
        xin = draw(n, 5, (2, 8, cfg.d_model))
        c = draw(n, 6, (2, 8, cfg.d_model))

        def grads(params, c_, **kw):
            live = tree_map(lambda t: t.clone().requires_grad_(True), params)
            xl = xin.clone().requires_grad_(True)
            y_, _ = forward(live, cfg, xl, **kw)
            gs = torch.autograd.grad((y_ * c_).sum(),
                                     [xl] + tree_leaves(live))
            it = iter(gs[1:])
            return y_.detach(), gs[0], tree_map(lambda _: next(it), live)

        y_w, gx_w, gp_w = grads(p, c)
        blocks = rules.shard_tree(p, sh)
        with mock.patch.object(ssm_mod, "collectives",
                               shim or collectives):
            y_r, gx_r, gp_r = grads(blocks, c, ctx=ctx)
        want_blocks = rules.shard_tree(gp_w, sh)
        rels = [err(gx_r, gx_w) / float(gx_w.abs().max())]
        rels += [err(a, b) / max(float(b.abs().max()), 1e-300) for a, b in
                 zip(tree_leaves(gp_r), tree_leaves(want_blocks))]
        return err(y_r, y_w) / float(y_w.abs().max()), max(rels)

    res["ssm_fwd_rel"], res["ssm_grad_rel"] = map(np.array, block_rels(
        ssm_cfg, "ssm", ssm_mod.ssm_forward))
    res["rglru_fwd_rel"], res["rglru_grad_rel"] = map(np.array, block_rels(
        rglru_cfg, "rglru", rglru_mod.rglru_forward))
    _, res["ssm_bc_grad_rel"] = map(np.array, block_rels(
        ssm_cfg, "ssm", ssm_mod.ssm_forward, _FirstCopyOnly(collectives)))
    _, res["ssm_norm_grad_rel"] = map(np.array, block_rels(
        ssm_cfg, "ssm", ssm_mod.ssm_forward, types.SimpleNamespace(
            copy_to_group=collectives.copy_to_group,
            sum_from_group=collectives.sum_from_group,
            sum_partials=collectives.sum_from_group)))
    return res


class _FirstCopyOnly:
    """``collectives`` whose ``copy_to_group`` passes only its first call of
    every three through (an SSD block's ``x``), leaving B and C out: the
    broken block of ``_mesh_mixer_grads``."""

    def __init__(self, real):
        self.real, self.calls = real, 0

    def copy_to_group(self, x, group):
        self.calls += 1
        return (self.real.copy_to_group(x, group) if self.calls % 3 == 1
                else x)

    def __getattr__(self, name):
        return getattr(self.real, name)


def _mesh_trainer(rank, device, out_dir, state, *, cfg, mesh, steps, batch,
                  seq, fail_at, ckpt):
    """``Trainer.run`` on a mesh, one Trainer a rank, with an injected
    failure: its losses, restarts and parameters (gathered whole), and the
    checkpoints written (rank 0 alone writes)."""
    import numpy as np
    import torch

    from repro_torch.data.pipeline import DataConfig
    from repro_torch.distributed.sharding_rules import unshard_tree
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train.trainer import Trainer, TrainerConfig

    tcfg = TrainerConfig(steps=steps, checkpoint_every=5,
                         checkpoint_dir=ckpt, peak_lr=1e-3, warmup_steps=2,
                         log_every=10 ** 6)
    t = Trainer(cfg, DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                global_batch=batch), tcfg,
                mesh=make_local_mesh(*mesh, device=device), device=device)
    out = t.run(fail_at=fail_at)
    # The whole parameters (collective): a rank's blocks differ by its
    # data coordinate under FSDP.
    whole = unshard_tree(out["params"], t._shardings["params"])
    flat = torch.cat([p.detach().float().reshape(-1).cpu()
                      for p in _leaves(whole)])
    return {"losses": np.array(out["losses"]),
            "restarts": np.array(out["restarts"]),
            "params": flat.numpy(),
            "steps_written": np.array(t.ckpt.all_steps())}


MESH_CHECKS = {"decode": _mesh_decode, "moe": _mesh_moe,
               "train": _mesh_train, "save": _mesh_save,
               "restore": _mesh_restore, "gpipe": _mesh_gpipe,
               "compress": _mesh_compress, "trainer": _mesh_trainer,
               "gather_grad": _mesh_gather_grad,
               "mixer_grads": _mesh_mixer_grads}


def mesh_rank_program(rank: int, world: int, plan):
    """One rank of a phase-18 group: each check of ``plan["checks"]`` in
    order (``(name, tag, kwargs)``), its arrays written to ``<out>/<tag>.
    rank<r>.npz`` with its wall ms and the rank's peak allocated bytes.
    Then, with ``plan["then"] = (world2, checks2)``, the group is left and
    its first ``world2`` ranks form a new one (a ``FileStore`` beside the
    outputs) for ``checks2``; the others are done."""
    import torch

    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    device = plan["device"]
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    state = {}
    _run_checks(rank, plan["checks"], device, plan["out"], state)
    if plan.get("then"):
        import torch.distributed as dist

        from repro_torch.distributed.process_group import init_process_group

        world2, checks2 = plan["then"]
        dist.barrier()
        backend = dist.get_backend()
        dist.destroy_process_group()
        if rank < world2:
            init_process_group(backend, rank, world2,
                               Path(plan["out"]) / "store2", device=device)
            _run_checks(rank, checks2, device, plan["out"], state)


def _run_checks(rank, checks, device, out, state):
    import numpy as np
    import torch

    for name, tag, kw in checks:
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = MESH_CHECKS[name](rank, device, out, state, **kw)
        _sync(device)
        res["wall_ms"] = np.array((time.perf_counter() - t0) * 1e3)
        res["peak_bytes"] = np.array(
            torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)
        np.savez(Path(out) / f"{tag}.rank{rank}.npz", **res)
        del res
        if torch.device(device).type == "cuda":
            import gc

            gc.collect()
            torch.cuda.empty_cache()


def run_mesh_group(world: int, checks, out_dir, device: str,
                   timeout_s: float = 600.0, then=None):
    """Run ``checks`` on ``world`` new gloo ranks (``mesh_rank_program``), then
    ``then = (world2, checks2)`` on the first ``world2`` of them, and read
    back each check's arrays: ``{tag: [rank 0's, rank 1's, ...]}``."""
    import numpy as np

    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    from repro_torch.distributed.process_group import run_ranks

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    run_ranks(mesh_rank_program, world, out_dir, backend="gloo",
              args=({"device": device, "out": str(out_dir),
                     "checks": list(checks), "then": then},),
              timeout_s=timeout_s, device=device)
    got = {}
    for w, group in [(world, checks)] + ([then] if then else []):
        for _, tag, _ in group:
            got[tag] = []
            for r in range(w):
                with np.load(out_dir / f"{tag}.rank{r}.npz") as z:
                    got[tag].append({k: z[k] for k in z.files})
    return got


def _rank_line(label, ranks) -> str:
    walls = ", ".join(f"{float(r['wall_ms']):.0f}" for r in ranks)
    peaks = ", ".join(f"{float(r['peak_bytes']) / 1e9:.2f}" for r in ranks)
    return f"  {label}: wall ms by rank [{walls}], peak GB by rank [{peaks}]"


def _grad_rel(got, want) -> float:
    import numpy as np

    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# A rank's share of qwen2's parameter bytes at 2 and at 4 model ranks, and
# on a 2 x 2 mesh under FSDP (0.25001 at 2 layers).
MESH_HELD = {2: 0.51, 4: 0.27}
MESH_HELD_FSDP = 0.26


def _serve_verdict(name, ranks, sharded: bool):
    """Hold a served check (``_mesh_decode``) against its one-process run
    on every rank: tokens equal, logits within MESH_DECODE_REL of max
    |logit|, each kernel launched as often; with ``sharded``, every rank
    kept a sequence slice."""
    import numpy as np

    for r, d in enumerate(ranks):
        check(np.array_equal(d["tokens"], d["ref_tokens"]),
              f"{name} tokens differ on rank {r}: "
              f"{d['tokens'].ravel().tolist()} vs "
              f"{d['ref_tokens'].ravel().tolist()}")
        err = float(np.abs(d["logits"] - d["ref_logits"]).max())
        scale = float(np.abs(d["ref_logits"]).max())
        check(err <= MESH_DECODE_REL * scale,
              f"{name} logits off by {err:.3e} on rank {r} "
              f"(max |logit| {scale:.3e})")
        check(np.array_equal(d["kernel_launches"], d["ref_kernel_launches"]),
              f"{name}: rank {r} launched {MESH_SERVE_KERNELS} "
              f"{d['kernel_launches'].tolist()} times, the one-process path "
              f"{d['ref_kernel_launches'].tolist()}")
        if sharded:
            check(int(d["sliced_layers"]) > 0,
                  f"rank {r} kept no sequence slice")
    held = [float(d["param_bytes"]) / float(d["ref_param_bytes"])
            for d in ranks]
    d0 = ranks[0]
    out = dict(
        err=max(float(np.abs(d["logits"] - d["ref_logits"]).max())
                for d in ranks),
        scale=max(float(np.abs(d["ref_logits"]).max()) for d in ranks),
        launches=[int(d["launches"]) for d in ranks],
        kernel_launches=[dict(zip(MESH_SERVE_KERNELS,
                                  d["kernel_launches"].tolist()))
                         for d in ranks],
        ref_kernel_launches=dict(zip(MESH_SERVE_KERNELS,
                                     d0["ref_kernel_launches"].tolist())),
        kv_heads=int(d0["kv_heads"]), s_loc=int(d0["s_loc"]),
        held_fraction=held,
        param_bytes=[int(d["param_bytes"]) for d in ranks],
        ref_param_bytes=int(d0["ref_param_bytes"]),
        run_peak_bytes=[int(d["run_peak_bytes"]) for d in ranks],
        ref_run_peak_bytes=[int(d["ref_run_peak_bytes"]) for d in ranks],
        collective_ms_step=[float(d["collective_ms_step"]) for d in ranks],
        collectives_step=float(d0["collectives_step"]),
        step_ms=[float(d["step_ms"]) for d in ranks],
        wall_ms=[float(d["wall_ms"]) for d in ranks],
        peak_bytes=[int(d["peak_bytes"]) for d in ranks])
    log(f"  {name}: tokens equal on {len(ranks)} ranks, logits within "
        f"{out['err']:.3e} (max |logit| {out['scale']:.3e}); a rank's "
        f"{MESH_SERVE_KERNELS} launches {d0['kernel_launches'].tolist()} = the "
        f"one-process path's {d0['ref_kernel_launches'].tolist()}; KV heads "
        f"a rank {out['kv_heads']}, cache rows {out['s_loc']}; collectives "
        f"{out['collectives_step']:.0f} a step taking "
        f"{[round(x, 2) for x in out['collective_ms_step']]} ms, step ms "
        f"{[round(x, 2) for x in out['step_ms']]}")
    log(f"  {name}: parameter GB by rank "
        f"{[round(x / 1e9, 3) for x in out['param_bytes']]} of "
        f"{out['ref_param_bytes'] / 1e9:.3f} whole ({[round(h, 4) for h in held]});"
        f" run peak GB above what was held by rank "
        f"{[round(x / 1e9, 3) for x in out['run_peak_bytes']]} vs one process "
        f"{[round(x / 1e9, 3) for x in out['ref_run_peak_bytes']]}")
    log(_rank_line(name, ranks))
    return out


def _check_held(name, fractions, model_ranks: int):
    limit = MESH_HELD.get(model_ranks)
    if limit is not None:
        check(all(f <= limit for f in fractions),
              f"{name}: a rank holds {fractions} of the parameter bytes at "
              f"{model_ranks} model ranks (limit {limit})")


def mesh_verdicts(res, lr: float):
    """Hold phase 18 (b)'s results (``run_mesh_group``'s, both groups)
    against the one-process paths computed in the same ranks; returns the
    figures it printed. Raises on the first check that fails."""
    import numpy as np

    out = {}
    if "decode" in res:
        out["decode"] = _serve_verdict("sharded decode", res["decode"], True)
    for tag in sorted(t for t in res if t.startswith("serve")):
        out[tag] = _serve_verdict(f"tensor-parallel {tag}", res[tag], False)
    if "moe" in res:
        ranks = res["moe"]
        for r, d in enumerate(ranks):
            check(bool(d["ok"]), f"EP MoE logits off by {float(d['err']):.3e}"
                  f" on rank {r}")
        out["moe"] = dict(err=max(float(d["err"]) for d in ranks),
                          param_bytes=[int(d["param_bytes"]) for d in ranks],
                          ref_param_bytes=int(ranks[0]["ref_param_bytes"]),
                          wall_ms=[float(d["wall_ms"]) for d in ranks],
                          peak_bytes=[int(d["peak_bytes"]) for d in ranks])
        log(f"  EP MoE: logits within {out['moe']['err']:.3e} of the local "
            f"all-experts forward (max |logit| "
            f"{max(float(d['scale']) for d in ranks):.3e}); parameter GB by "
            f"rank {[round(x / 1e9, 3) for x in out['moe']['param_bytes']]} "
            f"of {out['moe']['ref_param_bytes'] / 1e9:.3f} whole")
        log(_rank_line("moe", ranks))
    # Each train check held against one process (``single``): qwen2's
    # ("train", phase 19 (c) counts it) and the mixers'.
    for tag in sorted(t for t in res if t.startswith("train")
                      and "loss_rel" in res[t][0]):
        ranks = res[tag]
        d = ranks[0]
        sums = d["param_abs_sums"]            # [rank, (sum, model index)]
        for mi in set(sums[:, 1].tolist()):
            same = sums[sums[:, 1] == mi, 0]
            check(np.all(same == same[0]), f"the ranks of model coordinate "
                  f"{int(mi)} hold different blocks: {sums.tolist()}")
        lrel, grel = float(d["loss_rel"]), float(d["grad_rel"])
        pdiff = float(d["param_diff"])
        held = [float(r["param_bytes"]) / float(d["ref_param_bytes"])
                for r in ranks]
        fsdp = bool(d["fsdp"])
        # The second step's launches, or the first's in a one-step check.
        which = "step2" if "step2_launches" in d else "step1"
        launches = json.loads(str(d[f"{which}_launches"]))
        ref_launches = json.loads(str(d[f"ref_{which}_launches"]))
        out[tag] = dict(fsdp=fsdp, losses=d["losses"].tolist(),
                        ref_losses=d["ref_losses"].tolist(),
                        grad_norms=d["grad_norms"].tolist(),
                        ref_grad_norms=d["ref_grad_norms"].tolist(),
                        norm_rel=float(d["norm_rel"]),
                        loss_rel=lrel, grad_rel=grel, param_diff=pdiff,
                        held_fraction=held,
                        step1_peak_bytes=int(d.get("step1_peak_bytes", 0)),
                        step2_peak_bytes=int(d.get("step2_peak_bytes", 0)),
                        **{f"{which}_launches": launches,
                           f"ref_{which}_launches": ref_launches},
                        step_ms=[float(r["step_ms"]) for r in ranks],
                        wall_ms=[float(r["wall_ms"]) for r in ranks],
                        peak_bytes=[int(r["peak_bytes"]) for r in ranks])
        log(f"  {tag} ({'FSDP and ' if fsdp else ''}tensor-parallel): "
            f"losses {d['losses'].tolist()} "
            f"vs one process {d['ref_losses'].tolist()} (relative "
            f"{lrel:.3e}), gathered gradients within {grel:.3e} of a leaf's "
            f"max (worst: {d['grad_worst']}), gathered parameters within "
            f"{pdiff:.3e}, the first clip norm "
            f"{float(d['grad_norms'][0]):.6f} vs "
            f"{float(d['ref_grad_norms'][0]):.6f} (relative "
            f"{float(d['norm_rel']):.3e}), blocks equal by "
            f"model coordinate, step ms {out[tag]['step_ms']}; a rank "
            f"holds {[round(h, 5) for h in held]} of the parameter bytes "
            f"({float(d['ref_param_bytes']) / 1e9:.3f} GB whole); "
            f"rank 0's {which}: launches {launches} (one process "
            f"{ref_launches})" + (f", peak {int(d['step2_peak_bytes']) / 1e9:.3f}"
                                  " GB" if which == "step2" else ""))
        log(_rank_line(tag, ranks))
        check(lrel <= MESH_LOSS_REL, f"mesh train losses {d['losses']} vs "
              f"{d['ref_losses']} (relative {lrel:.3e})")
        if "control_rels" in d:
            # Each leaf within the bound of one process, or, where
            # reordering the batch's sums alone (the control) moves the
            # leaf further, within MESH_SPREAD times that move.
            rels = json.loads(str(d["grad_rels"]))
            spread = json.loads(str(d["control_rels"]))
            limit = {k: max(MESH_GRAD_REL, MESH_SPREAD * spread[k])
                     for k in rels}
            wide = sorted(k for k in rels if limit[k] > MESH_GRAD_REL)
            over = {k: (rels[k], spread[k]) for k in rels
                    if rels[k] > limit[k]}
            out[tag].update(grad_rel_control=float(d["grad_rel_control"]),
                            control_rel=float(d["control_rel"]),
                            spread_leaves={k: (rels[k], spread[k])
                                           for k in wide})
            log(f"  {tag}: one process summing as the batch ranks do lies "
                f"{float(d['control_rel']):.3e} of a leaf's max from the "
                f"plain step (worst: {d['control_plain_worst']}), the mesh "
                f"{float(d['grad_rel_control']):.3e} from it (worst: "
                f"{d['control_worst']}); {len(wide)} of {len(rels)} leaves "
                f"move past {MESH_GRAD_REL:g} by the reorder alone, held "
                f"within {MESH_SPREAD:g}x their move: " + ", ".join(
                    f"{k} {rels[k]:.2e} (move {spread[k]:.2e})"
                    for k in wide))
            check(not over, f"{tag} gradients off one process past the "
                  f"bound and past {MESH_SPREAD:g}x the reorder's move "
                  f"(leaf: mesh, move): {over}")
        else:
            check(grel <= MESH_GRAD_REL, f"mesh gradients off by {grel:.3e} "
                  "of a leaf's max")
        nrel = float(d["norm_rel"])
        check(nrel <= MESH_GRAD_REL, f"mesh clip norm {d['grad_norms'][0]} "
              f"vs one process {d['ref_grad_norms'][0]} (relative "
              f"{nrel:.3e})")
        check(pdiff <= 2 * lr, f"mesh parameters off by {pdiff:.3e} "
              f"(2 x lr = {2 * lr:.1e})")
        check(launches == ref_launches, f"a rank's step launched {launches};"
              f" the one process's {ref_launches}")
        if fsdp:
            check(all(h <= MESH_HELD_FSDP for h in held), f"under FSDP a "
                  f"rank holds {held} of the parameter bytes (limit "
                  f"{MESH_HELD_FSDP})")
    if "train_tp" in res:
        # One step on the model split alone (FSDP off), from the same
        # parameters and batch as the train check's first.
        t, d = res["train_tp"][0], res["train"][0]
        lrel = abs(float(t["losses"][0]) - float(d["losses"][0])) / abs(
            float(d["losses"][0]))
        nrel = abs(float(t["grad_norms"][0]) - float(d["grad_norms"][0])) \
            / abs(float(d["grad_norms"][0]))
        held = [float(r["param_bytes"]) / float(d["ref_param_bytes"])
                for r in res["train_tp"]]
        out["train_tp"] = dict(loss=float(t["losses"][0]), loss_rel=lrel,
                               norm_rel=nrel, held_fraction=held,
                               step_ms=[float(r["step_ms"])
                                        for r in res["train_tp"]])
        log(f"  mesh train, model split alone: first loss "
            f"{float(t['losses'][0])} (relative {lrel:.3e} to the train "
            f"check's), clip norm relative {nrel:.3e}; a rank holds "
            f"{[round(h, 5) for h in held]}; step ms "
            f"{out['train_tp']['step_ms']}")
        log(_rank_line("train_tp", res["train_tp"]))
        check(not bool(t["fsdp"]) and lrel <= MESH_LOSS_REL,
              f"the model-split step's loss {float(t['losses'][0])} vs "
              f"{float(d['losses'][0])} (relative {lrel:.3e})")
        check(nrel <= MESH_GRAD_REL, f"the model-split step's clip norm "
              f"off by {nrel:.3e}")
    if "restore" in res:
        ranks = res["restore"]
        saved = res["save"]
        check(bool(saved[0]["written_exact"]), "the checkpoint written from "
              "the 2 x 2 blocks is not the trained parameters")
        for r, d in enumerate(ranks):
            check(bool(d["exact"]) and bool(d["shaped"]),
                  f"rank {r}'s restored blocks are not the saved arrays' "
                  "blocks")
            check(np.isfinite(float(d["loss"])) and float(d["moved"]) > 0,
                  f"the step after the restore failed on rank {r}")
        out["elastic"] = dict(
            held_fraction_saved=[float(s["held"]) / float(s["whole"])
                                 for s in saved],
            held_fraction_restored=[float(d["held"]) / float(d["whole"])
                                    for d in ranks],
            loss=float(ranks[0]["loss"]),
            save_ms=[float(s["save_ms"]) for s in saved],
            restore_ms=[float(d["restore_ms"]) for d in ranks],
            save_wall_ms=[float(s["wall_ms"]) for s in saved],
            wall_ms=[float(d["wall_ms"]) for d in ranks],
            peak_bytes=[int(d["peak_bytes"]) for d in ranks])
        check(all(f < 1.0 for f in out["elastic"]["held_fraction_restored"]),
              "a restored rank holds the whole parameters")
        log(f"  elastic restore: blocks exact on {len(ranks)} ranks, each "
            f"holding {out['elastic']['held_fraction_restored']} of the "
            f"parameters (saved from blocks of "
            f"{out['elastic']['held_fraction_saved']}); one more step, loss "
            f"{out['elastic']['loss']:.6f}; save ms by rank "
            f"{[round(x) for x in out['elastic']['save_ms']]}, restore ms "
            f"{[round(x) for x in out['elastic']['restore_ms']]}")
        log(_rank_line("save", saved))
        log(_rank_line("restore", ranks))
    if "gather_grad" in res:
        ranks = res["gather_grad"]
        for r, d in enumerate(ranks):
            check(bool(d["shaped"]) and float(d["gather_err"]) == 0.0,
                  f"the FSDP gather on rank {r} is not the ranks' blocks "
                  f"(off by {float(d['gather_err']):.3e})")
            for key in ("grad_err", "scatter_err"):
                check(float(d[key]) <= MESH_GATHER_REL * float(d["scale"]),
                      f"the FSDP gather's gradient on rank {r}: {key} "
                      f"{float(d[key]):.3e} of a scale {float(d['scale']):.3e}")
        out["gather_grad"] = dict(
            grad_err=max(float(d["grad_err"]) for d in ranks),
            scatter_err=max(float(d["scatter_err"]) for d in ranks),
            wall_ms=[float(d["wall_ms"]) for d in ranks])
        log(f"  FSDP gather / reduce-scatter: gathered exactly; gradient "
            f"within {out['gather_grad']['grad_err']:.3e}, reduce-scatter "
            f"within {out['gather_grad']['scatter_err']:.3e} of the ranks' "
            f"summed cotangent's block (float64)")
    if "mixer_grads" in res:
        ranks = res["mixer_grads"]
        worst = {k: max(float(d[k]) / float(d[scale]) if scale else
                        float(d[k]) for d in ranks)
                 for k, scale in (("rs_grad_err", "rs_scale"),
                                  ("norm_grad_err", "norm_scale"),
                                  ("ssm_grad_rel", None),
                                  ("rglru_grad_rel", None))}
        for k, v in worst.items():
            check(v <= MESH_MIXER_REL, f"the mixers' collectives: {k} "
                  f"{v:.3e} (limit {MESH_MIXER_REL:g})")
        out["mixer_grads"] = worst
        log("  mixer collectives: " + ", ".join(
            f"{k} {v:.3e}" for k, v in worst.items()))
    if "gpipe" in res:
        ranks = res["gpipe"]
        d0 = ranks[0]
        ref = float(d0["ref_loss"])
        for r, d in enumerate(ranks):
            rel = abs(float(d["loss"]) - ref) / abs(ref)
            check(rel <= MESH_PIPE_LOSS_REL, f"GPipe loss {float(d['loss'])}"
                  f" vs sequential {ref} on rank {r}")
            check(float(d["grad_rel"]) <= MESH_PIPE_GRAD_REL,
                  f"GPipe gradients on rank {r} off the sequential ones "
                  f"(error of a leaf's max, leaf): {d['worst'].tolist()}")
        worst = max(float(d["grad_rel"]) for d in ranks)
        out["gpipe"] = dict(loss=float(d0["loss"]), ref_loss=ref,
                            grad_rel=worst,
                            ms=[float(d["ms"]) for d in ranks],
                            wall_ms=[float(d["wall_ms"]) for d in ranks],
                            peak_bytes=[int(d["peak_bytes"]) for d in ranks])
        log(f"  GPipe: loss {float(d0['loss']):.6f} vs sequential {ref:.6f}, "
            f"gradients within {worst:.3e} of a leaf's max, loss+backward ms "
            f"{out['gpipe']['ms']}")
        log(_rank_line("gpipe", ranks))
    if "compress" in res:
        ranks = res["compress"]
        for r, d in enumerate(ranks):
            check(float(d["one_round_err"]) <= float(d["one_round_step"]),
                  f"compress_psum off the reference's formula by "
                  f"{float(d['one_round_err']):.3e} on rank {r}")
            check(float(d["drift"]) <= MESH_COMPRESS_SCALES
                  * float(d["scale"]), f"error feedback drifted "
                  f"{float(d['drift']):.3e} (scale {float(d['scale']):.3e})")
        d = ranks[0]
        out["compress"] = dict(one_round_err=float(d["one_round_err"]),
                               drift=float(d["drift"]),
                               scale=float(d["scale"]),
                               wall_ms=[float(r["wall_ms"]) for r in ranks])
        log(f"  compress_psum: one round within {float(d['one_round_err']):.3e}"
            f" of the reference's formula, 20-round drift "
            f"{float(d['drift']):.3e} against a scale of "
            f"{float(d['scale']):.3e}")
        log(_rank_line("compress", ranks))
    return out


def mesh_nccl_trainer(tmp_dir: Path, cfg):
    """Phase 18 (a): ``Trainer(mesh=make_local_mesh(1, 1))`` over a
    one-rank NCCL group against the mesh-less Trainer, ``cfg`` at full
    width, 3 steps of the train batch, the same seed and data: losses and
    final parameters."""
    import torch
    import torch.distributed as dist

    from repro_torch.data.pipeline import DataConfig
    from repro_torch.distributed.process_group import init_process_group
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train.trainer import Trainer, TrainerConfig

    device, backend = "cuda", "nccl"
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                          global_batch=TRAIN_BATCH)

    def run(name, mesh):
        tcfg = TrainerConfig(steps=3, checkpoint_every=10 ** 6,
                             checkpoint_dir=str(tmp_dir / name),
                             log_every=10 ** 6, warmup_steps=1, keep=1)
        _sync(device)
        t0 = time.perf_counter()
        trainer = Trainer(cfg, data_cfg, tcfg, mesh=mesh, device=device)
        saving = [0.0]
        save, wait = trainer.ckpt.save, trainer.ckpt.wait

        def timed(fn):
            def call(*a, **kw):
                t = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    saving[0] += time.perf_counter() - t
            return call

        trainer.ckpt.save, trainer.ckpt.wait = timed(save), timed(wait)
        out = trainer.run()
        _sync(device)
        wall = time.perf_counter() - t0
        log(f"  {name}: {wall:.1f} s, of which {saving[0]:.1f} s saving the "
            "final checkpoint")
        host = [t.detach().cpu() for t in _leaves(out["params"])]
        peak = torch.cuda.max_memory_allocated()
        del out["params"]
        _release()
        return out["losses"], host, wall, peak

    losses0, p0, wall0, peak0 = run("plain", None)
    init_process_group(backend, 0, 1, tmp_dir / f"{backend}_store",
                       device=device)
    try:
        mesh = make_local_mesh(1, 1, device=device)
        check(dist.get_backend() == backend, f"the group is not {backend}")
        losses1, p1, wall1, peak1 = run("mesh", mesh)
    finally:
        dist.destroy_process_group()
    diff = max(float((a - b).abs().max()) for a, b in zip(p0, p1))
    same = losses0 == losses1 and diff == 0.0
    log(f"  {backend} 1 x 1 mesh Trainer: losses {losses1} vs mesh-less "
        f"{losses0}; max parameter difference {diff:.3e} "
        f"({'bit for bit' if same else 'NOT bit for bit'}); wall s "
        f"{wall1:.1f} vs {wall0:.1f}; peak GB {peak1 / 1e9:.2f} vs "
        f"{peak0 / 1e9:.2f}")
    check(same, f"the {backend} mesh Trainer differs from the mesh-less one:"
          f" losses {losses1} vs {losses0}, parameters by {diff:.3e}")
    return dict(losses=losses1, plain_losses=losses0, param_diff=diff,
                wall_s=wall1, plain_wall_s=wall0, peak_bytes=peak1)


def _first_layers(cfg, n: int):
    """``cfg`` cut to its first ``n`` layers (full width); an
    encoder-decoder's encoder to ``n`` layers too."""
    import dataclasses

    kw = {}
    if cfg.encoder is not None and cfg.encoder.kind == "audio":
        kw["encoder"] = dataclasses.replace(cfg.encoder, n_layers=n)
    return dataclasses.replace(
        cfg, n_layers=n, layer_pattern=cfg.layer_pattern[:n]
        if cfg.layer_pattern else cfg.layer_pattern, **kw).validate()


def mesh_phase():
    """Phase 18: (a) the NCCL Trainer, (b) four gloo ranks on the card at
    full width, then two of them."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch import configs

    out = {}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    try:
        _release()
        qwen2 = _first_layers(configs.get_arch("qwen2-1.5b"),
                              MESH_QWEN2_LAYERS)
        log("== 18a: Trainer(mesh=make_local_mesh(1, 1)) over a one-rank "
            f"NCCL group, full-width qwen2-1.5b at {MESH_QWEN2_LAYERS} "
            f"layers, 3 steps of {TRAIN_BATCH} x {TRAIN_SEQ}, against the "
            "mesh-less Trainer")
        t0 = time.perf_counter()
        out["nccl"] = mesh_nccl_trainer(tmp, qwen2)
        log(f"  [18a: {time.perf_counter() - t0:.1f} s]")
        _release()
        ds = _first_layers(configs.get_arch("deepseek-moe-16b"),
                           MESH_DEEPSEEK_LAYERS)
        deepseek = dataclasses.replace(
            ds, moe=dataclasses.replace(ds.moe, capacity_factor=32.0))
        lr = 1e-3
        # The serving checks hold the model split alone (FSDP off): a
        # decode step would gather every layer through host memory.
        four = dict(
            decode=dict(mesh=(1, 4), batch=1, prompt_len=511, steps=8,
                        max_len=1024, params={"seed": 0}, token_seed=11),
            serve=dict(mesh=(2, 2), batch=2, prompt_len=511, steps=8,
                       max_len=1024, params={"seed": 0}, token_seed=16,
                       sharded=False, fsdp=False),
            moe=dict(mesh=(2, 2), batch=4, seq=64, params={"seed": 0},
                     token_seed=12, keep=False),
            train=dict(MESH_TRAIN, steps=2, params={"seed": 0},
                       data_seed=13))
        two = dict(
            restore=dict(mesh=(1, 2), batch=8, seq=256, microbatches=2,
                         data_seed=13),
            gpipe=dict(n_stages=2, microbatches=2, batch=4, seq=256,
                       params={"seed": 0}, token_seed=14),
            compress=dict(shape=(1536, 1536), rounds=20, seed=15),
            gather_grad=dict(shape=(768, 1536), dim=0, seed=17))
        ckpt = str(tmp / "elastic")
        g4 = [("decode", "decode", dict(cfg=qwen2, **four["decode"])),
              ("decode", "serve", dict(cfg=qwen2, **four["serve"])),
              ("moe", "moe", dict(cfg=deepseek, **four["moe"])),
              ("train", "train_tp", dict(cfg=qwen2, lr=lr, **dict(
                  four["train"], steps=1, single=False, fsdp=False))),
              ("train", "train", dict(cfg=qwen2, lr=lr, saved_as="train",
                                      **four["train"])),
              ("save", "save", dict(step=1, ckpt=ckpt, trained="train"))]
        # The recurrent mixers on their blocks (after the save, which frees
        # the qwen2 train check's parameters): the serves on the model split
        # alone, mamba2's train step under FSDP.
        mamba2 = _first_layers(configs.get_arch("mamba2-2.7b"),
                               MESH_MAMBA2_LAYERS)
        rgemma = _first_layers(configs.get_arch("recurrentgemma-9b"),
                               MESH_RGEMMA_LAYERS)
        g4 += [("decode", "serve_mamba2", dict(
                   cfg=mamba2, **dict(four["serve"], token_seed=18))),
               ("train", "train_mamba2", dict(
                   cfg=mamba2, lr=lr, control=True,
                   **dict(four["train"], steps=1, data_seed=19))),
               ("decode", "serve_rglru", dict(
                   cfg=rgemma, **dict(four["serve"], token_seed=20)))]
        # The encoder-decoder on its blocks: served on the model split
        # alone (one row a data rank, 1500 frames), one FSDP train step.
        whisper = _first_layers(configs.get_arch("whisper-large-v3"),
                                MESH_WHISPER_LAYERS)
        g4 += [("decode", "serve_whisper", dict(
                   cfg=whisper, **dict(four["serve"], prompt_len=64,
                                       max_len=448, token_seed=23,
                                       frames_seed=0))),
               ("train", "train_whisper", dict(
                   cfg=whisper, lr=lr,
                   **dict(four["train"], steps=1, data_seed=24)))]
        g2 = [("restore", "restore", dict(cfg=qwen2, lr=lr, ckpt=ckpt,
                                          **two["restore"])),
              ("gpipe", "gpipe", dict(cfg=qwen2, **two["gpipe"])),
              ("compress", "compress", dict(**two["compress"])),
              ("gather_grad", "gather_grad", dict(**two["gather_grad"]))]
        log("== 18b: four gloo ranks on cuda:0, each on its blocks — "
            f"sequence-sharded decode (qwen2-1.5b, "
            f"{MESH_QWEN2_LAYERS} layers, 1 x 4: "
            "4 query heads a rank, KV replicated), tensor-parallel serve "
            f"(qwen2-1.5b, {MESH_QWEN2_LAYERS} layers, 2 x 2: KV heads "
            "split; 511-token "
            "prompts, 8 greedy steps), EP MoE (deepseek-moe-16b, 3 layers, "
            f"2 x 2), mesh train steps (qwen2-1.5b, {MESH_QWEN2_LAYERS} "
            "layers, 2 x 2: one on the model split alone, two under FSDP), "
            "the save of the FSDP blocks, the recurrent mixers on their "
            f"blocks (mamba2-2.7b, {MESH_MAMBA2_LAYERS} layers, 2 x 2: a "
            "serve as qwen2's and one FSDP train step; recurrentgemma-9b, "
            f"{MESH_RGEMMA_LAYERS} layers, 2 x 2: a serve), the "
            f"encoder-decoder (whisper-large-v3, {MESH_WHISPER_LAYERS} + "
            f"{MESH_WHISPER_LAYERS} layers, 2 x 2: a serve of 64-token "
            "prompts over 1500 frames and one FSDP train step); then two of "
            "them — elastic restore onto 1 x 2 and one step, GPipe over two "
            "stages, compress_psum")
        t0 = time.perf_counter()
        res = run_mesh_group(4, g4, tmp / "ranks", "cuda", then=(2, g2))
        log(f"  [18b ranks: {time.perf_counter() - t0:.1f} s]; slowest rank "
            "s by check: " + ", ".join(
                f"{tag} {max(float(r['wall_ms']) for r in ranks) / 1e3:.1f}"
                for tag, ranks in res.items()))
        out["checks"] = mesh_verdicts(res, lr)
        want = MESH_QWEN2_LAYERS * four["decode"]["steps"]
        got = out["checks"]["decode"]["launches"]
        check(all(n == want for n in got), f"the sharded decode launched "
              f"flash_decode {got} times by rank; {want} expected")
        for name, model in (("decode", 4), ("serve", 2), ("train_tp", 2),
                            ("serve_mamba2", 2), ("serve_rglru", 2),
                            ("serve_whisper", 2)):
            _check_held(f"18b {name}", out["checks"][name]["held_fraction"],
                        model)
        # The mixers' kernels ran on every rank, as often as one process.
        for tag, kernel in (("serve_mamba2", "ssd"), ("serve_rglru", "rglru"),
                            ("train_mamba2", "ssd"),
                            ("serve_whisper", "flash_attention"),
                            ("serve_whisper", "flash_decode"),
                            ("train_whisper", "flash_attention")):
            c = out["checks"][tag]
            got = ([r[kernel] for r in c["kernel_launches"]]
                   if "kernel_launches" in c else [c["step1_launches"].get(
                       kernel, 0)])
            check(all(n > 0 for n in got), f"18b {tag}: {kernel} launched "
                  f"{got} times by rank")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
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
# Phase 10 serves mamba2-2.7b at 8 of its 64 layers and phase 11
# recurrentgemma-9b at 11 of its 38 (full width): cut (from 64, then 32,
# then 16; from 38, then 20) so that phase 18 fits the run's time, the
# second time when 18 (b) gained its FSDP steps, the third when it gained
# the recurrent mixers' checks (17e trains mamba2 at all 64).
MAMBA2_SERVE_LAYERS = 8
RECURRENTGEMMA_SERVE_LAYERS = 11
RECURRENTGEMMA_LENGTHS = (2100, 2040, 64, 500)


# ---------------------------------------------------------------------------
# Phase 19: the dry run, and its count against the card
# ---------------------------------------------------------------------------

# The counted peak against torch.cuda.max_memory_allocated: relative.
PEAK_REL_TOL = 0.10
DRYRUN_ARCH = "qwen2-1.5b"


def start_host_dryrun():
    """Phase 19 (a) on the host, beside the card's work: the dry run's CLI
    over qwen2-1.5b's single-pod cells, in a process of its own."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         DRYRUN_ARCH, "--single-pod", "--force"], cwd=str(ROOT), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _storage_bytes(tree) -> int:
    seen, total = set(), 0
    for t in _leaves(tree):
        if hasattr(t, "untyped_storage"):
            st = t.untyped_storage()
            if st.data_ptr() not in seen:
                seen.add(st.data_ptr())
                total += st.nbytes()
    return total


def _calibrate(label, count, run, make_args, runs: int = 3):
    """Run a counted step ``runs`` times on the card and hold it to its
    count: launches, peak bytes, time against the roofline's total_s."""
    import torch
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.kernels import build
    from repro_torch.roofline import analysis as RA

    terms = RA.analyze(count, H100_SXM)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    args = make_args()
    torch.cuda.synchronize()
    times, peaks, launches, outs = [], [], None, []
    for i in range(runs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = dict(build.LAUNCHES)
        t0 = time.perf_counter()
        outs.append(run(*args))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated() - base)
        if launches is None:
            launches = {k: build.LAUNCHES[k] - before[k] for k in before
                        if build.LAUNCHES[k] != before[k]}
    median = statistics.median(times)
    counted_peak = float(count.peak_bytes)
    peak = max(peaks)
    rec = dict(launches=launches, counted_launches=dict(count.launches),
               peak_bytes=peaks, counted_peak_bytes=counted_peak,
               argument_bytes=_storage_bytes(list(args)),
               ms=[t * 1e3 for t in times], median_ms=median * 1e3,
               flops=count.flops, hbm_bytes=count.hbm_bytes,
               total_s=terms.total_s, compute_s=terms.compute_s,
               memory_s=terms.memory_s, dominant=terms.dominant,
               over_total=median / terms.total_s)
    log(f"  {label}: launches {launches} (counted {dict(count.launches)}); "
        f"peak {peak / 1e9:.3f} GB (counted {counted_peak / 1e9:.3f} GB, "
        f"{(counted_peak - peak) / peak:+.2%}); step ms "
        f"{', '.join(f'{t * 1e3:.1f}' for t in times)} (median "
        f"{median * 1e3:.1f}); roofline total_s {terms.total_s * 1e3:.3f} "
        f"ms ({terms.dominant}; {count.flops:.4e} FLOPs, "
        f"{count.hbm_bytes:.4e} B); measured / total_s "
        f"{rec['over_total']:.2f}")
    check(launches == dict(count.launches),
          f"{label}: counted launches {dict(count.launches)} differ from the "
          f"card's {launches}")
    check(abs(counted_peak - peak) <= PEAK_REL_TOL * peak,
          f"{label}: counted peak {counted_peak:.4e} B is not within "
          f"{PEAK_REL_TOL:.0%} of the card's {peak:.4e} B")
    check(median >= terms.total_s,
          f"{label}: {median:.6f} s a step is faster than the roofline's "
          f"{terms.total_s:.6f} s")
    return rec, outs


def dryrun_phase(host, mesh_checks):
    """Phase 19: (a) the host's count of qwen2-1.5b's single-pod cells
    (``host``, the process ``start_host_dryrun`` started), (b) the count of
    a bf16 train and decode step held against the same steps on the
    card, (c) the counts of phase 18 (b)'s FSDP train steps (qwen2-1.5b's
    and whisper-large-v3's; float32, their layers, 2 x 2, their batch) on a
    fake 2 x 2 group held against rank 0's steps there (``mesh_checks``,
    ``mesh_verdicts``' figures: launches and peak)."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.models import api
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_serve_steps, make_train_step

    out = {}
    # (a) The host's dry run.
    text, _ = host.communicate(timeout=600)
    lines = [x for x in text.splitlines() if x.startswith(DRYRUN_ARCH)]
    for x in lines:
        log(f"  {x}")
    check(host.returncode == 0, f"the dry run exited {host.returncode}:\n"
          f"{text[-2000:]}")
    cells = {}
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        res = json.loads(Path(dryrun.cell_path(DRYRUN_ARCH, shape, False))
                         .read_text())
        want = "skipped" if shape == "long_500k" else "ok"
        check(res["status"] == want, f"dry run {shape}: {res['status']} "
              f"{res.get('error', res.get('reason', ''))}")
        cells[shape] = res
    out["cells"] = cells

    # (b) The count against the card.
    cfg = configs.get_arch(DRYRUN_ARCH)
    train_shape = ShapeSpec("calibration_train", 512, 8, "train")
    decode_shape = ShapeSpec("calibration_decode", 1024, 4, "decode")
    t0 = time.perf_counter()
    with dryrun.cell_mesh(local=(1, 1)) as mesh:
        train_count, _ = dryrun._compile_step(cfg, train_shape, mesh)
        decode_count, _ = dryrun._compile_step(cfg, decode_shape, mesh)
    log(f"  counted the train and decode steps on meta in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(19)

    def params():
        return api.init_params(cfg, 0, dtype=torch.bfloat16, device="cuda")

    def train_args():
        p = params()
        opt = adamw.init_state(p, dryrun.OPT_CFG)
        batch = {k: torch.from_numpy(rng.integers(
            2, cfg.vocab_size, (8, 512)).astype(np.int32)).cuda()
            for k in ("tokens", "targets")}
        return p, opt, batch

    step = make_train_step(cfg, dryrun.OPT_CFG, microbatches=1,
                           accum_dtype=torch.float32)
    out["train"], steps = _calibrate("train step (bf16, 8 x 512, remat)",
                                     train_count, step, train_args)
    losses = [float(m["loss"]) for _, _, m in steps]
    log(f"  losses {', '.join(f'{x:.4f}' for x in losses)}")
    check(all(math.isfinite(x) for x in losses),
          f"bf16 train losses not finite: {losses}")
    out["train"]["losses"] = losses
    del steps
    torch.cuda.empty_cache()

    _, decode = make_serve_steps(cfg, None, max_len=1024,
                                 dtype=torch.bfloat16)

    def decode_args():
        state = api.make_serve_state(cfg, 4, 1024, torch.bfloat16,
                                     device="cuda")
        tok = torch.from_numpy(rng.integers(
            2, cfg.vocab_size, (4, 1)).astype(np.int32)).cuda()
        return params(), tok, state

    out["decode"], steps = _calibrate(
        "decode step (bf16, 4 rows, cache 1024, eager)", decode_count,
        decode, decode_args)
    logits = steps[-1][0]
    check(bool(torch.isfinite(logits.float()).all()),
          "bf16 decode logits not finite")
    del steps
    torch.cuda.empty_cache()

    # (c) Phase 18 (b)'s FSDP steps, counted as rank 0 of 2 x 2.
    out["mesh_train"] = mesh_train_counts(mesh_checks)
    return out


def mesh_train_count(cfg, mesh_train):
    """Phase 19 (c): a phase 18 (b) train step (``cfg``, cut as 18b cuts
    it, float32, ``MESH_TRAIN``; FSDP over the data axis, tensor-parallel
    over the model axis) counted as rank 0 of a fake 2 x 2 group, held
    against rank 0's last step there (``mesh_train``: its launches and its
    peak, arguments included; the second step's, or the first's in a
    one-step check): launches equal, peak within ``PEAK_REL_TOL``."""
    import torch
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.optim import adamw

    mesh_shape = ShapeSpec("mesh_train", MESH_TRAIN["seq"],
                           MESH_TRAIN["batch"], "train")
    with dryrun.cell_mesh(local=MESH_TRAIN["mesh"]) as mesh:
        count, _ = dryrun._compile_step(
            cfg, mesh_shape, mesh, microbatches=MESH_TRAIN["microbatches"],
            dtype=torch.float32, opt_cfg=adamw.AdamWConfig())
    which = "step2" if "step2_launches" in mesh_train else "step1"
    counted, card = dict(count.launches), mesh_train[f"{which}_launches"]
    peak, counted_peak = mesh_train[f"{which}_peak_bytes"], float(
        count.peak_bytes)
    out = dict(step=which, launches=card, counted_launches=counted,
               peak_bytes=peak, counted_peak_bytes=counted_peak,
               flops=count.flops, hbm_bytes=count.hbm_bytes,
               collective_bytes=count.totals()[2])
    kinds = {}
    for kind, _ in count.collectives:
        kinds[kind] = kinds.get(kind, 0) + 1
    out["collectives"] = kinds
    label = f"{cfg.name} at {cfg.n_layers} layers"
    log(f"  FSDP train step ({label}, float32, 2 x 2, rank 0's {which}): "
        f"launches {card} (counted {counted}); peak {peak / 1e9:.3f} GB "
        f"(counted {counted_peak / 1e9:.3f} GB, "
        f"{(counted_peak - peak) / peak:+.2%}); counted {count.flops:.4e} "
        f"FLOPs, {count.totals()[2]:.4e} collective bytes in {kinds}")
    check(card == counted, f"{label}: the 2 x 2 step's counted launches "
          f"{counted} differ from rank 0's {card}")
    check(abs(counted_peak - peak) <= PEAK_REL_TOL * peak,
          f"{label}: the 2 x 2 step's counted peak {counted_peak:.4e} B is "
          f"not within {PEAK_REL_TOL:.0%} of rank 0's {peak:.4e} B")
    return out


def mesh_train_counts(checks):
    """Phase 19 (c) for each of phase 18 (b)'s counted train steps
    (``checks``, ``mesh_verdicts``' figures): qwen2-1.5b's and
    whisper-large-v3's."""
    from repro_torch import configs

    return {"qwen2": mesh_train_count(
                _first_layers(configs.get_arch("qwen2-1.5b"),
                              MESH_QWEN2_LAYERS), checks["train"]),
            "whisper": mesh_train_count(
                _first_layers(configs.get_arch("whisper-large-v3"),
                              MESH_WHISPER_LAYERS), checks["train_whisper"])}


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
    host_dryrun = None
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
            log(f"== serve full-width mamba2-2.7b ({MAMBA2_SERVE_LAYERS} of "
                "its 64 layers, float32; SSD states)")
            t0 = time.perf_counter()
            result["mamba2"] = recurrent_phase(
                "mamba2-2.7b", 1024, MAMBA2_LENGTHS, seed=7,
                prefill_kernels=("ssd",), decode_kernels=("ssd",),
                profile=args.profile, chunking=(1000, 256),
                layers=MAMBA2_SERVE_LAYERS)
            phase_done("mamba2", t0)

            # 11. Full-width recurrentgemma-9b.
            log("== serve full-width recurrentgemma-9b "
                f"({RECURRENTGEMMA_SERVE_LAYERS} of its 38 layers, float32; "
                "RG-LRU states, 2048-slot rings)")
            t0 = time.perf_counter()
            result["recurrentgemma"] = recurrent_phase(
                "recurrentgemma-9b", 2304, RECURRENTGEMMA_LENGTHS, seed=8,
                prefill_kernels=("matmul", "flash_attention", "rglru"),
                decode_kernels=("matmul", "flash_decode", "rglru"),
                profile=args.profile, chunking=(2100, 512),
                layers=RECURRENTGEMMA_SERVE_LAYERS)
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

            # 19 (a) runs on the host beside phases 17 and 18.
            host_dryrun = start_host_dryrun()

            # 17. Training (last: its full-width state needs the card's
            # memory to itself).
            log("== 17: training on the card: kernel gradients, full-width "
                "qwen2-1.5b train steps, the 100M example and the launcher")
            t0 = time.perf_counter()
            result["train"] = train_phase(args.profile)
            phase_done("17 train", t0)

            # 18. The mesh runtime (last: its ranks share the card).
            log("== 18: the mesh runtime — a one-rank NCCL Trainer, then "
                "four and two gloo ranks on cuda:0")
            t0 = time.perf_counter()
            result["mesh"] = mesh_phase()
            phase_done("18 mesh", t0)

            # 19. The dry run, and its count against the card.
            log("== 19: the dry run — qwen2-1.5b's single-pod cells counted "
                "on the host; a bf16 train and decode step counted, then run "
                "on the card")
            t0 = time.perf_counter()
            result["dryrun"] = dryrun_phase(host_dryrun,
                                            result["mesh"]["checks"])
            phase_done("19 dryrun", t0)

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
            # One full-width qwen2-1.5b train step (phase 17c), forward,
            # recompute and backward.
            for name in ("matmul", "flash_attention"):
                by_path[name]["qwen2 train step (phase 17c)"] = \
                    result["train"]["steps"]["launches"][name]
            # One remat train step of full-width mamba2-2.7b and of 17e
            # (d)'s recurrentgemma-9b: forward (with the recompute) and
            # backward calls.
            recurrent = result["train"]["recurrent"]
            by_path["ssd"] = {"mamba2 serve (phase 10)": launches["ssd"],
                              "train": recurrent["mamba2"]["steps"]["launches"]}
            by_path["rglru"] = {
                "recurrentgemma serve (phase 11)": launches["rglru"],
                "train": recurrent["recurrentgemma"]["steps"]["launches"]}
            # Phase 18 (b)'s sequence-sharded decode (its decode steps) and
            # tensor-parallel serve (prefill and decode steps), by rank.
            by_path["flash_decode"]["sharded decode (phase 18b), by rank"] = \
                result["mesh"]["checks"]["decode"]["launches"]
            for name in SERVE_KERNELS:
                by_path[name]["tensor-parallel serve (phase 18b), by rank"] = [
                    r[name] for r in
                    result["mesh"]["checks"]["serve"]["kernel_launches"]]
            # Phase 18 (b)'s FSDP train step, rank 0's second step.
            fsdp_step = result["mesh"]["checks"]["train"]["step2_launches"]
            for name in ("matmul", "flash_attention"):
                by_path[name]["FSDP train step (phase 18b), rank 0"] = \
                    fsdp_step[name]
            # The mixers on their blocks in phase 18 (b): each serve by
            # rank, mamba2's FSDP train step (forward and backward calls).
            mesh_checks = result["mesh"]["checks"]
            for tag, name in (("serve_mamba2", "ssd"),
                              ("serve_rglru", "rglru")):
                by_path[name]["tensor-parallel serve (phase 18b), by rank"] \
                    = [r[name] for r in mesh_checks[tag]["kernel_launches"]]
            by_path["ssd"]["FSDP train step (phase 18b), rank 0"] = {
                k: v for k, v in
                mesh_checks["train_mamba2"]["step1_launches"].items()
                if k.startswith("ssd")}
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
    finally:
        if host_dryrun is not None and host_dryrun.poll() is None:
            host_dryrun.kill()
            host_dryrun.wait()
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
