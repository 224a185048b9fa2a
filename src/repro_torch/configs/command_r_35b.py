"""command-r-35b [dense] — GQA, no bias, parallel attn+FF block, LayerNorm.

40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000
[hf:CohereForAI/c4ai-command-r-v01]. Tied embeddings, rope theta 8e6.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256000,
    norm_kind="layernorm",
    norm_eps=1e-5,
    parallel_block=True,
    tie_embeddings=True,
    rope_theta=8000000.0,
).validate()


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=192, vocab_size=256,
    ).validate()
