"""qwen3-moe-235b-a22b [moe] — 128 experts, top-8, q/k norms.

94L d_model=4096 64H (GQA kv=4) expert d_ff=1536 vocab=151936
[hf:Qwen/Qwen3-30B-A3B scaled family]. All layers MoE, no shared experts,
normalized top-k gates, head_dim 128, RoPE theta 1e6.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, LayerSpec, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=0,
    vocab_size=151936,
    layer_pattern=tuple(LayerSpec("attn", "moe") for _ in range(94)),
    use_qk_norm=True,
    rope_theta=1000000.0,
    moe=MoEConfig(n_experts=128, top_k=8, d_expert=1536, renorm_gates=True),
).validate()


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        vocab_size=256,
        layer_pattern=tuple(LayerSpec("attn", "moe") for _ in range(3)),
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=32, renorm_gates=True,
                      capacity_factor=2.0),
    ).validate()
