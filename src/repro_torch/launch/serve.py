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
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --fleet h100_sxm,gtx260 --scheduler bucket
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --fleet h100_sxm --scheduler bucket --autoscale

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
repro_torch.launch.trace_report``.

``--fleet h100_sxm,gtx260`` (with ``--scheduler bucket``) serves through
the hardware-aware :class:`~repro_torch.serve.fleet.FleetRouter`: one
engine per listed hardware model, all on this process's device and
sharing one parameter set, each request placed on the instance the cost
model prices cheapest for its bucket (each engine's tiles resolve for its
own hardware; a tile the card cannot launch falls back to the kernel's
default and counts as ``tile_fallback``, printed per instance). The
watchdog (``--watchdog-threshold``) and the retry budget
(``--retry-budget``) are the router's. ``--autoscale`` starts from
``--min-instances`` of the listed models and lets the
:class:`~repro_torch.serve.autoscale.AutoscalePolicy` join and drain
instances up to ``--max-instances``, every listed model a candidate; its
decisions print at exit. A fleet that does not drain prints
``FleetExhausted`` as a warning and reports what finished; with
``--refine`` the refined artifact rolls across the fleet one instance at
a time (``roll_plans``).
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import HARDWARE_REGISTRY, TilePlan
from repro_torch.kernels import build
from repro_torch.models import api
from repro_torch.obs import Tracer, write_jsonl, write_trace
from repro_torch.serve import (AutoscalePolicy, BucketPolicy,
                               FleetExhausted, FleetRouter, ScaleCandidate,
                               ServeEngine, make_scheduler)
from repro_torch.serve.refine import PlanRefiner, drift_report

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_policy(spec: str, plans, hardware_name: Optional[str],
                 max_queue: int, allow_overflow: bool = False) -> BucketPolicy:
    """The bucket policy: parsed edges, or with ``"plan"`` the edges of the
    plan's prefill cells on ``hardware_name`` (None: on every hardware, the
    union a fleet shares); ``allow_overflow`` admits a prompt past the
    largest edge (chunked serving)."""
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
    ap.add_argument("--fleet", default="",
                    help="comma list of hardware models; serve through the "
                         "fleet router with one engine per model "
                         "(overrides --hardware; needs --scheduler bucket)")
    ap.add_argument("--watchdog-threshold", type=int, default=8,
                    help="fleet: consecutive no-progress steps before an "
                         "instance is declared stalled and its work "
                         "recovered onto survivors")
    ap.add_argument("--retry-budget", type=int, default=2,
                    help="fleet: recovery attempts per request before it "
                         "is declared lost")
    ap.add_argument("--autoscale", action="store_true",
                    help="fleet: start with --min-instances of the --fleet "
                         "models and let the telemetry-driven policy join/"
                         "drain instances; every --fleet model is a scale "
                         "candidate, priced by the live traffic mix")
    ap.add_argument("--min-instances", type=int, default=1,
                    help="autoscale: never drain below this many instances")
    ap.add_argument("--max-instances", type=int, default=4,
                    help="autoscale: never join above this many instances")
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
    fleet_names = [h for h in args.fleet.split(",") if h]
    if fleet_names and args.scheduler != "bucket":
        raise SystemExit("--fleet requires --scheduler bucket (routing is "
                         "per shape bucket)")
    if args.autoscale and not fleet_names:
        raise SystemExit("--autoscale requires --fleet (the candidates come "
                         "from its hardware list)")
    policy = None
    if args.scheduler == "bucket":
        # A fleet shares one bucketing: "plan" edges from every hardware.
        policy = build_policy(
            args.bucket_policy, plans,
            None if fleet_names else args.hardware, args.max_queue,
            allow_overflow=(args.chunk_prefill or args.pack_prefill
                            or args.paged))

    def make_engine(hw_name: str, instance: Optional[str] = None):
        return ServeEngine(
            cfg, params, max_len=args.max_len, slots=args.slots, dtype=dtype,
            plans=plans, hardware=HARDWARE_REGISTRY[hw_name],
            scheduler=make_scheduler(args.scheduler, policy),
            chunk_prefill=args.chunk_prefill,
            step_token_budget=args.step_token_budget,
            prefill_slots=args.prefill_slots, pack_prefill=args.pack_prefill,
            paged=args.paged, prefix_sharing=not args.no_prefix_sharing,
            shadow_fraction=args.shadow_fraction if args.refine else 0.0,
            refiner=refiner, tracer=tracer, instance=instance or hw_name,
            device=args.device)

    router = engine = None
    if fleet_names:
        autoscaler = None
        seed_names = fleet_names
        if args.autoscale:
            # Start small; every --fleet model is a candidate the policy
            # may join (under its own name, suffixed on a re-join).
            autoscaler = AutoscalePolicy(
                tuple(ScaleCandidate(name=h, hardware=h,
                                     make_engine=lambda name, hw=h:
                                     make_engine(hw, instance=name))
                      for h in fleet_names),
                min_instances=args.min_instances,
                max_instances=args.max_instances)
            seed_names = fleet_names[:max(1, args.min_instances)]
        router = FleetRouter({h: make_engine(h) for h in seed_names}, policy,
                             tracer=tracer,
                             watchdog_threshold=args.watchdog_threshold,
                             retry_budget=args.retry_budget,
                             autoscaler=autoscaler)
    else:
        engine = make_engine(args.hardware)

    build.reset_launches()
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    rejected = 0
    for _ in range(args.requests):
        prompt = rng.integers(2, cfg.vocab_size, size=rng.integers(4, 12))
        if router is not None:
            ok = router.route(prompt, max_new_tokens=args.new_tokens)
        else:
            ok = engine.add_request(prompt, max_new_tokens=args.new_tokens)
        rejected += ok is None
    if router is not None:
        try:
            done_by = router.run_until_done()
        except FleetExhausted as exc:
            # Loud, never silent: a partial result set must not read as a
            # complete run, but what did finish is still reported.
            print(f"WARNING: {exc}")
            done_by = {name: list(eng._finished)
                       for name, eng in router.engines.items()}
        done = [r for _, rs in sorted(done_by.items()) for r in rs]
    else:
        done = engine.run_until_done()
    if torch.device(args.device).type == "cuda":
        torch.cuda.synchronize(args.device)
    dt = time.perf_counter() - t0
    if router is not None:
        for name, rs in sorted(done_by.items()):
            for r in rs:
                print(f"req {r.rid}@{name}: {r.out_tokens}")
        print("placements:", {str(b): p for b, p in
                              sorted(router.placements().items())})
        for name, eng in sorted(router.engines.items()):
            counts = eng.metrics.as_dict()["plan"]["counts"]
            print(f"instance {name} ({eng.hardware.name}, "
                  f"{router.status[name]}): "
                  f"{len(eng._finished)} finished, tile_fallback "
                  f"{counts.get('tile_fallback', 0)}")
        metrics = router.metrics()
        scale = metrics.get("autoscale")
        if scale is not None:
            print(f"autoscale: {scale['joins']} join(s), "
                  f"{scale['drains']} drain(s) over "
                  f"{scale['evaluations']} evaluation(s); final fleet: "
                  f"{router.live_instances()}")
            for entry in scale["log"]:
                print(f"  step {entry['step']}: {entry['action']} "
                      f"{entry['instance']} ({entry['reason']})")
        where = f"{len(router.engines)} instance(s) on {args.device}"
    else:
        for r in done:
            print(f"req {r.rid}: {r.out_tokens}")
        metrics = engine.metrics.as_dict()
        where = str(engine.device)
    toks = sum(len(r.out_tokens) for r in done)
    print(f"{len(done)} requests ({rejected} rejected), {toks} tokens in "
          f"{dt:.2f}s ({toks / dt:.1f} tok/s) on {where}")
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
        if router is not None:
            # One instance at a time behind the p95-TTFT guard (unguarded
            # here: the demo has no probe traffic).
            for decision in router.roll_plans(refined):
                print(f"rolled {decision.instance}: "
                      f"rolled_back={decision.rolled_back}")
        else:
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
        print(json.dumps(metrics, indent=1, sort_keys=True, default=str))
    elif router is not None:
        for name, eng in sorted(router.engines.items()):
            print(f"--- {name}")
            print(eng.metrics.render())
    else:
        print(engine.metrics.render())


if __name__ == "__main__":
    main()
