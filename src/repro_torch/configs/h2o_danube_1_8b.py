"""h2o-danube-1.8b [dense] — llama+mistral mix with sliding-window attention.

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000 [arXiv:2401.16818].
SWA window 4096 on every layer => subquadratic, long_500k runs (ring cache).
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab_size=32000,
    layer_pattern=tuple(LayerSpec("local_attn", "dense") for _ in range(24)),
    attn_window=4096,
    rope_theta=10000.0,
    subquadratic=True,
).validate()


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=192, vocab_size=256, attn_window=16,
        layer_pattern=tuple(LayerSpec("local_attn", "dense") for _ in range(2)),
    ).validate()
