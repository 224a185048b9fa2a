#!/usr/bin/env python3
"""Time the port's eager serving steps of full-width qwen2-1.5b, in the
source tree named by ``--src``, on one NVIDIA card.

    python3 tools/time_eager_serve.py --src OLD/src --label old
    python3 tools/time_eager_serve.py --src src --label new

It compares two versions of the model's host path in one call: run it once
per tree (old, new, new, old) and read the JSON lines. Three host-clock
times, each the median of ``--reps`` runs of ``--steps`` calls from a
synchronised start to a synchronised end, and beside each the least of
those runs (``*_min_ms``: the one least disturbed by other work on the
host):

* ``prefill_ms``: ``api.prefill`` of one 600-token prompt (float32);
* ``decode_ms``: ``api.decode_step`` of one row after that prompt
  (float32), reading its token back each step, as ``chip_smoke.py``'s
  eager decode (phase 4) does;
* ``decode_bf16_ms``: ``make_serve_steps``' decode of four rows into a
  1024-slot bf16 cache, as ``chip_smoke.py``'s phase 19 (b) times it.

Weights are random, drawn from seed 0; prompts from seed 3.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path


def _per_call_ms(fn, steps: int) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", required=True,
                    help="the src directory whose repro_torch to time")
    ap.add_argument("--label", default="",
                    help="a name for the tree, echoed in the JSON line")
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_eager_serve: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch import configs
    from repro_torch.models import api
    from repro_torch.train.step import make_serve_steps

    cfg = configs.get_arch("qwen2-1.5b")
    v = cfg.vocab_size
    rng = np.random.default_rng(3)
    out = {"label": args.label, "src": args.src}

    def timed(key, fn):
        fn()
        runs = [_per_call_ms(fn, args.steps) for _ in range(args.reps)]
        out[f"{key}_ms"] = statistics.median(runs)
        out[f"{key}_min_ms"] = min(runs)

    with torch.inference_mode():
        params = api.init_params(cfg, 0, dtype=torch.float32, device="cuda")
        prompt = {"tokens": rng.integers(2, v, size=(1, 600))}
        logits, state = api.prefill(params, cfg, prompt, max_len=1024)
        timed("prefill",
              lambda: api.prefill(params, cfg, prompt, max_len=1024))
        tok = [int(torch.argmax(logits[0, :v]))]

        def decode():
            t = torch.tensor([[tok[0]]], device="cuda")
            lg, _ = api.decode_step(params, cfg, t, state)
            tok[0] = int(torch.argmax(lg[0, :v]))

        timed("decode", decode)
        del params, state
        torch.cuda.empty_cache()

        params = api.init_params(cfg, 0, dtype=torch.bfloat16, device="cuda")
        _, step = make_serve_steps(cfg, None, max_len=1024,
                                   dtype=torch.bfloat16)
        state = api.make_serve_state(cfg, 4, 1024, torch.bfloat16,
                                     device="cuda")
        toks = torch.from_numpy(rng.integers(2, v, (4, 1)).astype(
            np.int32)).cuda()
        timed("decode_bf16", lambda: step(params, toks, state))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
