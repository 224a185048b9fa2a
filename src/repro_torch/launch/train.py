"""Training launcher of the port: the reduced config by default, a real
training loop with checkpoints.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --steps 20 --checkpoint-every 10 --fail-at 12

Mirrors ``repro/launch/train.py`` on one device: ``--smoke`` (the default)
trains ``configs.get_smoke(arch)``, ``--full`` the full config, with random
parameters from seed 0, the synthetic data pipeline, AdamW (weight decay
0.01) and warmup-cosine, checkpoints every ``--checkpoint-every`` steps
into ``--checkpoint-dir`` (a run resumes from the newest one there), and
``--fail-at`` injects one worker failure, after which the loop restores
the last checkpoint and goes on. ``--tile-plans`` / ``--hardware`` resolve
the train cell's kernel tiles from a compiled plan. It runs on ``cuda``
unless given ``--device cpu``; on the card the FF GEMMs, the attention and
the SSD and RG-LRU scans launch their kernels, forward and backward
(``--arch mamba2-2.7b`` and ``recurrentgemma-9b`` train there). The
reference's docstring names a ``--mesh`` flag, but its argument parser has
none, so neither has this one: a mesh Trainer is built in code
(``Trainer(mesh=launch.mesh.make_local_mesh(...))``, one process a rank).
"""
from __future__ import annotations

import argparse
import logging

from repro_torch import configs
from repro_torch.data.pipeline import DataConfig
from repro_torch.kernels import build
from repro_torch.optim import adamw
from repro_torch.train.trainer import (
    Trainer, TrainerConfig, default_checkpoint_dir,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b",
                    choices=configs.list_archs())
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="use the reduced config (the default)")
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default=default_checkpoint_dir())
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--peak-lr", type=float, default=1e-3)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure at this step (fault-tolerance "
                         "demo)")
    ap.add_argument("--tile-plans", default=None,
                    help="compiled TilePlan artifact (JSON); corrupt/missing "
                         "degrades to the kernels' default tiles")
    ap.add_argument("--hardware", default="",
                    help="hardware model to resolve tiles for "
                         "(default: the production target, h100_sxm)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the Hopper kernels) or cpu (their plain "
                         "versions)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get_arch(args.arch))
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                          global_batch=args.global_batch)
    tcfg = TrainerConfig(
        steps=args.steps, checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir, peak_lr=args.peak_lr,
        microbatches=args.microbatches, log_every=10,
        tile_plans=args.tile_plans, hardware=args.hardware,
    )
    trainer = Trainer(cfg, data_cfg, tcfg,
                      opt_cfg=adamw.AdamWConfig(weight_decay=0.01),
                      device=args.device)
    out = trainer.run(fail_at=args.fail_at)
    final = (f"{out['losses'][-1]:.4f}" if out["losses"]
             else "none (restored at the last step)")
    print(f"final loss: {final}  restarts: {out['restarts']}  "
          f"stragglers: {out['straggler_events']}")
    if trainer.device.type == "cuda":
        print(f"kernel launches: {dict(build.LAUNCHES)}")
    return out


if __name__ == "__main__":
    main()
