"""Serving launcher of the port: batched greedy requests on the reduced config.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-moe-16b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-235b-a22b
    PYTHONPATH=src python -m repro_torch.launch.compile_plans \
        --measure analytic --archs qwen2-1.5b --dtypes float32 \
        --serve-buckets 16,32 --serve-smoke --serve-max-len 128 --out p.json
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --tile-plans p.json --scheduler bucket --bucket-policy plan
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --chunk-prefill --step-token-budget 40 --scheduler bucket
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --pack-prefill --step-token-budget 40 --scheduler bucket
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --paged
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --tile-plans p.json --hardware gtx260 --refine --shadow-fraction 1 \
        --refine-out refined.json --trace-out trace.jsonl
    PYTHONPATH=src python -m repro_torch.launch.trace_report trace.jsonl

Mirrors the single-engine path of ``repro/launch/serve.py``: it serves
``configs.get_smoke(arch)`` with random parameters from a fixed seed, the
FIFO or the shape-bucketed scheduler, and prints the tokens of every
request, the throughput and the engine's metrics, whose plan-hit line
counts where each kernel's tile came from. ``--tile-plans`` loads a plan
artifact for ``--hardware`` (default ``h100_sxm``); ``--bucket-policy
plan`` takes the bucket edges from its prefill cells, so every prefill
resolves exactly. The windowed archs (gemma2-9b, h2o-danube-1.8b,
recurrentgemma-9b) keep ring caches on their local layers; mamba2-2.7b and
recurrentgemma-9b carry their SSD and RG-LRU states per slot;
deepseek-moe-16b and qwen3-moe-235b-a22b route through their experts
(``models/moe.py``); internvl2-1b serves its text, and whisper-large-v3,
whose requests need encoder frames, is refused. It runs on
``cuda`` unless given ``--device cpu``; on the card the model's prefill and
decode go through the Hopper kernels, each decode slot replaying its
captured CUDA graph. ``--chunk-prefill`` serves mixed steps (one prompt
chunk beside the decode batch under ``--step-token-budget``, up to
``--prefill-slots`` prefills in flight) and ``--pack-prefill`` packs
several chunks a step; both admit a prompt longer than the largest bucket
edge by chunking it, and print the chunk metrics. ``--paged`` serves from
the paged KV pool (page from the plan's ``kv_page`` cell, else the
default; shared prompt prefixes mapped copy-on-write unless
``--no-prefix-sharing``; admission by the pool's headroom), every prefill
as chunks, and prints the pool counters under ``kv pool`` (``pool`` in
``--metrics-json``). ``--refine`` (with ``--tile-plans``) diverts
``--shadow-fraction`` of the steps to shadow-measuring candidate tiles from
the plan's sensitivity curves (on the card for ``h100_sxm``, by the cost
model for the paper's GPUs), and at exit re-ranks the plan
(``PlanRefiner.refine``), prints the drift report, writes the refined
artifact to ``--refine-out`` and swaps the engine onto it.
``--trace-out`` writes the request-lifecycle and plan-audit trace (JSONL
for a ``.jsonl`` path, else Chrome/Perfetto JSON) for ``python -m
repro_torch.launch.trace_report``. The fleet (``--fleet``,
``--autoscale``, ``roll_plans``) comes with a later slice.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import HARDWARE_REGISTRY, TilePlan
from repro_torch.kernels import build
from repro_torch.models import api
from repro_torch.obs import Tracer, write_jsonl, write_trace
from repro_torch.serve import BucketPolicy, ServeEngine, make_scheduler
from repro_torch.serve.refine import PlanRefiner, drift_report

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_policy(spec: str, plans, hardware_name: str,
                 max_queue: int, allow_overflow: bool = False) -> BucketPolicy:
    """The bucket policy: parsed edges, or with ``"plan"`` the edges of the
    plan's prefill cells on ``hardware_name``; ``allow_overflow`` admits a
    prompt past the largest edge (chunked serving)."""
    if spec == "plan":
        if plans is None:
            raise SystemExit("--bucket-policy plan requires --tile-plans")
        return BucketPolicy.from_plan(plans, hardware=hardware_name,
                                      max_queue=max_queue,
                                      allow_overflow=allow_overflow)
    return BucketPolicy.parse(spec, max_queue=max_queue,
                              allow_overflow=allow_overflow)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b",
                    choices=configs.list_archs())
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--dtype", default="float32", choices=sorted(_DTYPES))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the Hopper kernels) or cpu (their plain "
                         "PyTorch versions)")
    ap.add_argument("--scheduler", default="fifo", choices=("fifo", "bucket"),
                    help="admission policy: naive FIFO or shape-bucketed")
    ap.add_argument("--bucket-policy", default="pow2:16:128",
                    help='bucket edges: "64,128", "pow2:lo:hi", or "plan" '
                         "(the prefill cells of --tile-plans)")
    ap.add_argument("--max-queue", type=int, default=256,
                    help="admission bound for the bucketed scheduler")
    ap.add_argument("--tile-plans", default=None,
                    help="AOT tile-plan artifact (compile_plans); the engine "
                         "resolves every kernel's tile from it")
    ap.add_argument("--hardware", default="h100_sxm",
                    choices=sorted(HARDWARE_REGISTRY),
                    help="the hardware model the plan is resolved for")
    ap.add_argument("--chunk-prefill", action="store_true",
                    help="split prompts into plan-sized chunks and build "
                         "mixed prefill/decode steps (admits over-length "
                         "prompts via chunking)")
    ap.add_argument("--step-token-budget", type=int, default=0,
                    help="max tokens one mixed step may process (prefill "
                         "chunk + decode batch); 0 = plan chunk unclamped")
    ap.add_argument("--prefill-slots", type=int, default=2,
                    help="concurrent partially-prefilled requests (chunked "
                         "mode; lets short prompts overtake long ones)")
    ap.add_argument("--pack-prefill", action="store_true",
                    help="pack several prefill chunks (plus the decode "
                         "batch) into each step under --step-token-budget "
                         "and the plan's pack width (implies "
                         "--chunk-prefill)")
    ap.add_argument("--paged", action="store_true",
                    help="serve from the paged KV pool (page size from the "
                         "plan's kv_page cell; shared-prefix copy-on-write "
                         "reuse; admission by pool headroom — implies "
                         "--chunk-prefill)")
    ap.add_argument("--no-prefix-sharing", action="store_true",
                    help="disable shared-prefix page reuse in --paged mode")
    ap.add_argument("--refine", action="store_true",
                    help="shadow-measure candidate tiles during service and "
                         "emit a refined (re-ranked) plan artifact at exit; "
                         "requires --tile-plans")
    ap.add_argument("--shadow-fraction", type=float, default=1 / 32,
                    help="fraction of steps diverted to shadow measurement "
                         "when --refine is on (deterministic counter-based "
                         "sampling; default 1/32)")
    ap.add_argument("--refine-out", default=None,
                    help="write the refined plan artifact here (with "
                         "--refine; default: print the drift summary only)")
    ap.add_argument("--metrics-json", action="store_true",
                    help="dump full metrics as JSON instead of the summary")
    ap.add_argument("--trace-out", default=None,
                    help="write a request-lifecycle / plan-audit trace here "
                         "(.jsonl for JSONL, else Chrome/Perfetto JSON; "
                         "inspect with python -m "
                         "repro_torch.launch.trace_report)")
    args = ap.parse_args(argv)

    cfg = configs.get_smoke(args.arch)
    dtype = _DTYPES[args.dtype]
    params = api.init_params(cfg, 0, dtype=dtype, device=args.device)
    plans = TilePlan.load_or_none(args.tile_plans)
    refiner = None
    if args.refine:
        if plans is None:
            raise SystemExit("--refine requires a loadable --tile-plans "
                             "artifact (shadow candidates come from its "
                             "sensitivity curves)")
        refiner = PlanRefiner()
    # Wall clock, the launcher's timing.
    tracer = Tracer() if args.trace_out else None
    policy = None
    if args.scheduler == "bucket":
        policy = build_policy(
            args.bucket_policy, plans, args.hardware, args.max_queue,
            allow_overflow=(args.chunk_prefill or args.pack_prefill
                            or args.paged))
    engine = ServeEngine(cfg, params, max_len=args.max_len, slots=args.slots,
                         dtype=dtype, plans=plans,
                         hardware=HARDWARE_REGISTRY[args.hardware],
                         scheduler=make_scheduler(args.scheduler, policy),
                         chunk_prefill=args.chunk_prefill,
                         step_token_budget=args.step_token_budget,
                         prefill_slots=args.prefill_slots,
                         pack_prefill=args.pack_prefill,
                         paged=args.paged,
                         prefix_sharing=not args.no_prefix_sharing,
                         shadow_fraction=(args.shadow_fraction if args.refine
                                          else 0.0),
                         refiner=refiner, tracer=tracer,
                         instance=args.hardware, device=args.device)

    build.reset_launches()
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    rejected = 0
    for _ in range(args.requests):
        prompt = rng.integers(2, cfg.vocab_size, size=rng.integers(4, 12))
        rejected += engine.add_request(
            prompt, max_new_tokens=args.new_tokens) is None
    done = engine.run_until_done()
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    dt = time.perf_counter() - t0
    for r in done:
        print(f"req {r.rid}: {r.out_tokens}")
    toks = sum(len(r.out_tokens) for r in done)
    print(f"{len(done)} requests ({rejected} rejected), {toks} tokens in "
          f"{dt:.2f}s ({toks / dt:.1f} tok/s) on {engine.device}")
    print(f"kernel launches: {dict(build.LAUNCHES)}")
    if refiner is not None:
        refine_trace = (tracer.attach("refiner", kind="refiner")
                        if tracer is not None else None)
        refined = refiner.refine(plans, trace=refine_trace)
        report = drift_report(refined)
        print(f"refined {report['n_refined']} cell(s) from "
              f"{report['shadow_samples']} shadow sample(s)")
        for cell in report["cells"]:
            print(f"  {cell['cell']}: {cell['incumbent']} -> "
                  f"{cell['refined']} ({cell['speedup']:.2f}x, "
                  f"{cell['samples']} samples)")
        if args.refine_out:
            refined.save(args.refine_out)
            print(f"refined plan artifact -> {args.refine_out}")
        engine.set_plans(refined)
        print("engine rolled onto the refined artifact")
    if tracer is not None:
        if args.trace_out.endswith(".jsonl"):
            write_jsonl(tracer, args.trace_out)
        else:
            write_trace(tracer, args.trace_out)
        print(f"trace -> {args.trace_out} ({len(tracer.events)} events; "
              f"open in ui.perfetto.dev or run python -m "
              f"repro_torch.launch.trace_report {args.trace_out})")
    if args.metrics_json:
        print(json.dumps(engine.metrics.as_dict(), indent=1, sort_keys=True,
                         default=str))
    else:
        print(engine.metrics.render())


if __name__ == "__main__":
    main()
