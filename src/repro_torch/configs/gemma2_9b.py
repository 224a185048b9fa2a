"""gemma2-9b [dense] — local/global alternating attention with logit softcaps.

42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000 [arXiv:2408.00118].
Window 4096 on local layers; attn softcap 50, final softcap 30; sandwich
(post) norms; GeGLU; tied + scaled embeddings; head_dim 256. Global layers
are full attention => long_500k skipped.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, LayerSpec, repeat_pattern

_UNIT = (LayerSpec("local_attn", "dense"), LayerSpec("attn", "dense"))

CONFIG = ArchConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    layer_pattern=repeat_pattern(_UNIT, 42),
    attn_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    post_norms=True,
    act="gelu_tanh",
    tie_embeddings=True,
    scale_embeddings=True,
    rope_theta=10000.0,
).validate()


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=192, vocab_size=256, attn_window=16,
        layer_pattern=repeat_pattern(_UNIT, 4),
    ).validate()
