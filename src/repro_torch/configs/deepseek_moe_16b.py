"""deepseek-moe-16b [moe] — fine-grained experts: 2 shared + 64 routed top-6.

28L d_model=2048 16H (MHA kv=16) expert d_ff=1408 vocab=102400
[arXiv:2401.06066]. Layer 0 uses a dense FF (width 10944); layers 1..27 are
MoE with 2 shared experts (width 2x1408) and 64 routed, top-6, gates not
renormalized (softmax-then-topk).
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, LayerSpec, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=10944,  # dense layer-0 FF width
    vocab_size=102400,
    layer_pattern=(LayerSpec("attn", "dense"),)
    + tuple(LayerSpec("attn", "moe") for _ in range(27)),
    rope_theta=10000.0,
    moe=MoEConfig(
        n_experts=64, top_k=6, d_expert=1408,
        n_shared_experts=2, d_shared=2816, renorm_gates=False,
    ),
).validate()


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=192, vocab_size=256,
        layer_pattern=(LayerSpec("attn", "dense"),)
        + tuple(LayerSpec("attn", "moe") for _ in range(2)),
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=32,
                      n_shared_experts=2, d_shared=64, renorm_gates=False,
                      capacity_factor=2.0),
    ).validate()
