"""internvl2-1b [vlm] — Qwen2-0.5B LM backbone + InternViT frontend stub.

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655 [arXiv:2404.16821].
The vision frontend is a STUB per the task spec: input_specs provide
precomputed patch embeddings [B, 256, 1024] that a linear projector maps
into the LM embedding space. Heads pad 14 -> 16 for TP=16 (DESIGN.md §5).
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, EncoderConfig

CONFIG = ArchConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1000000.0,
    encoder=EncoderConfig(n_layers=0, n_heads=0, seq_len=256, kind="vision"),
).validate()


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=192, vocab_size=256,
        encoder=EncoderConfig(n_layers=0, n_heads=0, seq_len=8, kind="vision"),
    ).validate()
