"""End-to-end example on the port: train a ~100M-parameter LM for a few
hundred steps (``examples/train_lm.py`` of the repository).

A mid-size config, not the tiny smoke config: 12 layers, d_model 640, GQA
10/2, vocab 50304 — about 100M parameters counted with the embeddings.
Synthetic Zipf data, AdamW + warmup-cosine, async checkpoints, the
straggler monitor. The loss should drop by more than 1.0 within 100 steps.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200
      PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu \
          --steps 2 --seq-len 16
"""
import argparse
import logging
import math
import os
import tempfile

from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.models import transformer
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train.trainer import Trainer, TrainerConfig


def make_100m_config() -> ArchConfig:
    return ArchConfig(
        name="demo-100m", family="dense",
        n_layers=12, d_model=640, n_heads=10, n_kv_heads=2, head_dim=64,
        d_ff=2560, vocab_size=50304, tie_embeddings=True,
    ).validate()


def n_params(cfg: ArchConfig) -> int:
    """Parameters of the model, from its definitions (nothing allocated)."""
    return sum(math.prod(d.shape)
               for d in tree_leaves(transformer.model_defs(cfg)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--checkpoint-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_100m"))
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the Hopper kernels) or cpu (their plain "
                         "versions)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    cfg = make_100m_config()
    print(f"config {cfg.name}: {n_params(cfg) / 1e6:.0f}M params")

    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                          global_batch=args.global_batch)
    tcfg = TrainerConfig(
        steps=args.steps, checkpoint_every=100,
        checkpoint_dir=args.checkpoint_dir,
        peak_lr=3e-4, warmup_steps=20, log_every=10,
    )
    trainer = Trainer(cfg, data_cfg, tcfg,
                      opt_cfg=adamw.AdamWConfig(weight_decay=0.01),
                      device=args.device)
    out = trainer.run(fail_at=args.fail_at)
    first, last = out["losses"][0], out["losses"][-1]
    print(f"loss {first:.3f} -> {last:.3f} over {args.steps} steps "
          f"(restarts={out['restarts']})")
    if args.steps >= 100:
        assert last < first - 1.0, "training did not make progress"
    return out


if __name__ == "__main__":
    main()
