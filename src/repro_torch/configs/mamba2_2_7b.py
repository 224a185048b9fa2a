"""mamba2-2.7b [ssm] — SSD (state-space duality), attention-free.

64L d_model=2560 (attn-free) vocab=50280, ssm_state=128 [arXiv:2405.21060].
d_inner = 2*2560 = 5120, head_dim 64 => 80 SSD heads. No FF (the SSD block
is the whole layer). subquadratic => long_500k runs (constant state).
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, LayerSpec, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    layer_pattern=tuple(LayerSpec("ssd", None) for _ in range(64)),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4),
    subquadratic=True,
).validate()


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=3, d_model=64, vocab_size=256,
        layer_pattern=tuple(LayerSpec("ssd", None) for _ in range(3)),
        ssm=SSMConfig(d_state=16, head_dim=16, expand=2, conv_width=4),
    ).validate()
