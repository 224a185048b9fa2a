"""Architecture configuration schema.

One :class:`ArchConfig` describes any of the ten registered architectures; the
generic decoder stack in ``models/transformer.py`` consumes it. Layers are a
sequence of :class:`LayerSpec` (mixer + feed-forward choice); consecutive
identical specs are grouped (``transformer.decompose``): the JAX reference
scans each group, and the port runs every layer in a Python loop.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.tiling import round_up

# Vocab is padded to lcm(model-shards, lanes) so the embedding shards evenly.
VOCAB_PAD_MULTIPLE = 2048
# Head counts pad up to the TP degree where needed (masked, see DESIGN.md).
TP_DEGREE = 16


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer: a sequence mixer plus an optional feed-forward."""

    mixer: str          # "attn" | "local_attn" | "rglru" | "ssd"
    ff: Optional[str]   # "dense" | "moe" | None (mamba2 has no FF)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int               # per-expert FF width
    n_shared_experts: int = 0   # deepseek: always-on shared experts
    d_shared: int = 0           # shared-expert FF width (total)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    renorm_gates: bool = True


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class RecurrentConfig:
    lru_width: int = 0          # 0 => d_model
    conv_width: int = 4
    c: float = 8.0              # RG-LRU decay sharpness


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec (whisper) or a frontend stub (internvl).

    The modality frontend (conv / ViT patching) is a STUB per the task spec:
    ``input_specs`` provides precomputed frame/patch embeddings.
    """

    n_layers: int
    n_heads: int
    seq_len: int                # e.g. 1500 whisper frames, 256 vit patches
    kind: str                   # "audio" | "vision"


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 => d_model // n_heads
    layer_pattern: Tuple[LayerSpec, ...] = ()
    # Attention options -----------------------------------------------------
    attn_window: int = 0        # sliding window for "local_attn" (0 = none)
    attn_softcap: float = 0.0   # gemma2 logit softcap (0 = off)
    final_softcap: float = 0.0  # gemma2 final-logit softcap
    qkv_bias: bool = False      # qwen2 QKV bias
    use_qk_norm: bool = False   # qwen3 per-head q/k RMSNorm
    query_scale: float = 0.0    # 0 => 1/sqrt(head_dim)
    rope_theta: float = 10000.0
    # Embedding / head ------------------------------------------------------
    tie_embeddings: bool = False
    scale_embeddings: bool = False  # gemma: embed * sqrt(d_model)
    norm_eps: float = 1e-6
    norm_kind: str = "rms"      # rms | layernorm (command-r, whisper)
    parallel_block: bool = False  # command-r: attn and ff in parallel
    act: str = "silu"           # silu | gelu | gelu_tanh
    post_norms: bool = False    # gemma2 post-attention/post-ffw norms
    # Substructures ---------------------------------------------------------
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    recurrent: Optional[RecurrentConfig] = None
    encoder: Optional[EncoderConfig] = None
    # Long-context capability (drives long_500k applicability).
    subquadratic: bool = False

    # ----- derived ---------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // max(self.n_heads, 1)

    @property
    def padded_vocab(self) -> int:
        return round_up(self.vocab_size, VOCAB_PAD_MULTIPLE)

    @property
    def padded_heads(self) -> int:
        """Query heads padded so TP_DEGREE divides them (masked heads)."""
        if self.n_heads == 0:
            return 0
        if self.n_heads % TP_DEGREE == 0:
            return self.n_heads
        if self.n_heads < TP_DEGREE:
            return TP_DEGREE
        return round_up(self.n_heads, TP_DEGREE)

    @property
    def padded_kv_heads(self) -> int:
        """KV heads: pad to TP degree when shardable, else replicate as-is.

        kv < TP stays unpadded (replicated across model shards); kv >= TP
        pads up so the cache shards evenly.
        """
        if self.n_kv_heads >= TP_DEGREE and self.n_kv_heads % TP_DEGREE:
            return round_up(self.n_kv_heads, TP_DEGREE)
        return self.n_kv_heads

    @property
    def gqa_ratio(self) -> int:
        return max(1, self.padded_heads // max(self.padded_kv_heads, 1))

    def layers(self) -> Tuple[LayerSpec, ...]:
        if self.layer_pattern:
            if len(self.layer_pattern) != self.n_layers:
                raise ValueError(
                    f"{self.name}: pattern length {len(self.layer_pattern)} "
                    f"!= n_layers {self.n_layers}"
                )
            return self.layer_pattern
        return tuple(LayerSpec("attn", "dense") for _ in range(self.n_layers))

    def validate(self) -> "ArchConfig":
        if self.n_heads and self.n_kv_heads and self.n_heads % self.n_kv_heads:
            raise ValueError(f"{self.name}: heads {self.n_heads} % kv {self.n_kv_heads}")
        for spec in self.layers():
            if spec.mixer in ("rglru",) and self.recurrent is None:
                raise ValueError(f"{self.name}: rglru layer without recurrent cfg")
            if spec.mixer == "ssd" and self.ssm is None:
                raise ValueError(f"{self.name}: ssd layer without ssm cfg")
            if spec.ff == "moe" and self.moe is None:
                raise ValueError(f"{self.name}: moe layer without moe cfg")
            if spec.mixer == "local_attn" and not self.attn_window:
                raise ValueError(f"{self.name}: local_attn without attn_window")
        return self


def repeat_pattern(unit: Tuple[LayerSpec, ...], n_layers: int) -> Tuple[LayerSpec, ...]:
    """Tile ``unit`` to ``n_layers``, truncating the last repeat if needed."""
    reps = (n_layers + len(unit) - 1) // len(unit)
    return (unit * reps)[:n_layers]
