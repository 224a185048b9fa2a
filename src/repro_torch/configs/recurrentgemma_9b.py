"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, Griffin 1:2 pattern.

38L d_model=4096 16H (GQA kv=1) d_ff=12288 vocab=256000 [arXiv:2402.19427].
Pattern unit (rglru, rglru, local_attn); 38 layers = 12 full units + 2
trailing rglru layers. Local attention window 2048. Gemma-family details:
GeGLU MLP, RMSNorm, tied + scaled embeddings. subquadratic => long_500k runs.
"""
import dataclasses

from repro_torch.configs.base import (
    ArchConfig, LayerSpec, RecurrentConfig, repeat_pattern,
)

_UNIT = (
    LayerSpec("rglru", "dense"),
    LayerSpec("rglru", "dense"),
    LayerSpec("local_attn", "dense"),
)

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    layer_pattern=repeat_pattern(_UNIT, 38),
    attn_window=2048,
    act="gelu_tanh",
    tie_embeddings=True,
    scale_embeddings=True,
    rope_theta=10000.0,
    recurrent=RecurrentConfig(lru_width=4096, conv_width=4, c=8.0),
    subquadratic=True,
).validate()


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=256, attn_window=16,
        layer_pattern=repeat_pattern(_UNIT, 5),
        recurrent=RecurrentConfig(lru_width=64, conv_width=4, c=8.0),
    ).validate()
