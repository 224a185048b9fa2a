"""Serving launcher of the port: batched greedy requests on the reduced config.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b

Mirrors the single-engine path of ``repro/launch/serve.py``: it serves
``configs.get_smoke(arch)`` with random parameters from a fixed seed, the
FIFO or the shape-bucketed scheduler, and prints the tokens of every
request, the throughput and the engine's metrics. The windowed archs
(gemma2-9b, h2o-danube-1.8b) keep ring caches on their local layers. It
runs on ``cuda`` unless given ``--device cpu``; on the card the model's
prefill and decode go through the Hopper kernels, each decode slot
replaying its captured CUDA graph. The fleet, tile plans, chunked, packed
and paged serving, plan refinement and tracing come with later slices.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.kernels import build
from repro_torch.models import api
from repro_torch.serve import BucketPolicy, ServeEngine, make_scheduler

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
                    help='bucket edges: "64,128" or "pow2:lo:hi"')
    ap.add_argument("--max-queue", type=int, default=256,
                    help="admission bound for the bucketed scheduler")
    ap.add_argument("--metrics-json", action="store_true",
                    help="dump full metrics as JSON instead of the summary")
    args = ap.parse_args(argv)

    cfg = configs.get_smoke(args.arch)
    dtype = _DTYPES[args.dtype]
    params = api.init_params(cfg, 0, dtype=dtype, device=args.device)
    policy = (BucketPolicy.parse(args.bucket_policy, max_queue=args.max_queue)
              if args.scheduler == "bucket" else None)
    engine = ServeEngine(cfg, params, max_len=args.max_len, slots=args.slots,
                         dtype=dtype,
                         scheduler=make_scheduler(args.scheduler, policy),
                         device=args.device)

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
    if args.metrics_json:
        print(json.dumps(engine.metrics.as_dict(), indent=1, sort_keys=True,
                         default=str))
    else:
        print(engine.metrics.render())


if __name__ == "__main__":
    main()
