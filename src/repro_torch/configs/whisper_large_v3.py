"""whisper-large-v3 [audio] — encoder-decoder backbone, conv frontend stub.

32L (decoder; +32 encoder) d_model=1280 20H (MHA kv=20) d_ff=5120
vocab=51866 [arXiv:2212.04356]. The conv1d audio frontend is a STUB:
input_specs provide precomputed frame embeddings [B, 1500, 1280]. Decoder
positions are configurable (the assigned decode shapes exercise the decoder
beyond whisper's 448-token deployment limit; backbone-only per spec).
Heads pad 20 -> 32 for TP=16 (DESIGN.md §5). long_500k skipped (full attn).
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, EncoderConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    norm_kind="layernorm",
    norm_eps=1e-5,
    act="gelu",
    tie_embeddings=True,
    encoder=EncoderConfig(n_layers=32, n_heads=20, seq_len=1500, kind="audio"),
).validate()


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256,
        encoder=EncoderConfig(n_layers=2, n_heads=4, seq_len=24, kind="audio"),
    ).validate()
