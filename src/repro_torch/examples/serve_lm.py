"""Batched serving example on the port: the continuous-batching engine over
a small LM (the arch's reduced config, random weights from a seed).

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lm --requests 8
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models import api
from repro_torch.serve import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-9b",
                    choices=configs.list_archs())
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the Hopper kernels) or cpu (their plain "
                         "versions)")
    args = ap.parse_args(argv)

    cfg = configs.get_smoke(args.arch)
    params = api.init_params(cfg, 0, device=args.device)
    engine = ServeEngine(cfg, params, max_len=128, slots=args.slots,
                         device=args.device)

    rng = np.random.default_rng(1)
    lengths = rng.integers(4, 16, size=args.requests)
    t0 = time.perf_counter()
    for n in lengths:
        engine.add_request(rng.integers(2, cfg.vocab_size, size=n),
                           max_new_tokens=args.new_tokens)
    done = engine.run_until_done()
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    dt = time.perf_counter() - t0

    total = sum(len(r.out_tokens) for r in done)
    print(f"arch={cfg.name} slots={args.slots} device={engine.device}")
    for r in sorted(done, key=lambda r: r.rid):
        print(f"  req {r.rid} (prompt {len(r.prompt)} tok) "
              f"-> {len(r.out_tokens)} new tokens")
    print(f"{len(done)} requests, {total} tokens, {dt:.2f}s "
          f"({total / dt:.1f} tok/s on {engine.device.type})")


if __name__ == "__main__":
    main()
