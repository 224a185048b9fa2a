"""Roofline terms from a dry run's count — the port's
``repro/roofline/analysis.py``.

Three terms per (arch x shape x mesh), the reference's:

    compute    = FLOPs_per_chip / peak_FLOP/s
    memory     = HBM_bytes_per_chip / HBM_bw
    collective = collective_bytes_per_chip / (links x link_bw)

The reference reads FLOPs and bytes from XLA's ``cost_analysis()`` of the
compiled per-chip module and parses collective bytes out of the HLO text.
PyTorch has neither, so the port counts for itself (``roofline/count.py``):
one rank's step run on ``meta`` tensors, every kernel launch, torch op and
collective call recorded as it runs. :func:`collective_stats` is
``parse_collectives``'s counterpart over that record: every all-reduce /
all-gather / reduce-scatter / all-to-all / collective-permute contributes
its result's bytes x the kind's wire multiplier (ring algorithms):
all-reduce 2x (reduce-scatter + all-gather phase), the others 1x.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch

from repro_torch.core.hardware import HardwareModel

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1,
}

# torch dtype -> the table's name (HLO's).
_TORCH_NAMES = {
    torch.float64: "f64", torch.float32: "f32", torch.bfloat16: "bf16",
    torch.float16: "f16", torch.float8_e4m3fn: "f8e4m3",
    torch.float8_e5m2: "f8e5m2", torch.int64: "s64", torch.uint64: "u64",
    torch.int32: "s32", torch.uint32: "u32", torch.int16: "s16",
    torch.uint16: "u16", torch.int8: "s8", torch.uint8: "u8",
    torch.bool: "pred",
}

_COLLECTIVES = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
    "ragged-all-to-all": 1.0,
}


def dtype_bytes(dtype) -> int:
    """Bytes of one element of ``dtype`` (a torch dtype or the table's
    name); 0 for a type the table does not hold."""
    name = _TORCH_NAMES.get(dtype, dtype)
    return _DTYPE_BYTES.get(name, 0) if isinstance(name, str) else 0


def result_bytes(shapes: Iterable[Tuple[Sequence[int], object]]) -> int:
    """Total bytes of a (possibly tuple) result: ``(shape, dtype)`` pairs,
    the counterpart of the reference's ``_shape_bytes`` of an HLO shape."""
    total = 0
    for shape, dtype in shapes:
        n = 1
        for d in shape:
            n *= int(d)
        total += n * dtype_bytes(dtype)
    return total


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, float]
    count_by_kind: Dict[str, int]

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())


def collective_stats(calls: Iterable[Tuple[str, int]]) -> CollectiveStats:
    """The counterpart of ``parse_collectives``: ``calls`` are the port's
    collective calls, ``(kind, result bytes)`` one a call (the count's
    record); each adds its bytes x the kind's multiplier."""
    bytes_by: Dict[str, float] = {}
    count_by: Dict[str, int] = {}
    for kind, nbytes in calls:
        if kind not in _COLLECTIVES:
            raise ValueError(f"unknown collective kind {kind!r}")
        bytes_by[kind] = bytes_by.get(kind, 0.0) + nbytes * _COLLECTIVES[kind]
        count_by[kind] = count_by.get(kind, 0) + 1
    return CollectiveStats(bytes_by, count_by)


@dataclasses.dataclass
class RooflineTerms:
    flops: float
    hbm_bytes: float
    collective_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    peak_bytes_per_device: Optional[float] = None

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def total_s(self) -> float:
        # Optimistic (fully-overlapped) step time: max of the three.
        return max(self.compute_s, self.memory_s, self.collective_s)

    def roofline_fraction(self) -> float:
        """compute_s / total_s — 1.0 means compute-bound (at the roofline)."""
        return self.compute_s / self.total_s if self.total_s else 0.0


def terms(flops: float, hbm_bytes: float, collective_bytes: float,
          hw: HardwareModel, ici_links: Optional[int] = None,
          peak_bytes: Optional[float] = None) -> RooflineTerms:
    """The three terms of given totals, with the reference's formulas."""
    links = ici_links if ici_links is not None else hw.ici_links
    link_bw = links * hw.ici_bw_per_link
    return RooflineTerms(
        flops=flops,
        hbm_bytes=hbm_bytes,
        collective_bytes=collective_bytes,
        compute_s=flops / hw.peak_flops_bf16,
        memory_s=hbm_bytes / hw.hbm_bw,
        collective_s=collective_bytes / link_bw if link_bw else 0.0,
        peak_bytes_per_device=peak_bytes,
    )


def analyze(counts, hw: HardwareModel,
            ici_links: Optional[int] = None) -> RooflineTerms:
    """:class:`RooflineTerms` of one rank's counted step (a
    ``roofline.count.Count``): its FLOPs and bytes, its collectives through
    :func:`collective_stats`, and its peak of live bytes (the reference's
    ``argument + temp``)."""
    coll = collective_stats(counts.collectives)
    return terms(counts.flops, counts.hbm_bytes, coll.total_bytes, hw,
                 ici_links, float(counts.peak_bytes))


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE), per step, global."""
    n = active_param_count(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


def active_param_count(cfg) -> float:
    """Parameters touched per token (MoE counts top_k + shared experts)."""
    d, v = cfg.d_model, cfg.padded_vocab
    total = v * d * (1 if cfg.tie_embeddings else 2)
    for spec in cfg.layers():
        if spec.mixer in ("attn", "local_attn"):
            hd = cfg.head_dim_
            total += d * hd * (cfg.padded_heads * 2 + cfg.padded_kv_heads * 2)
        elif spec.mixer == "rglru":
            f = cfg.recurrent.lru_width or d
            total += 2 * d * f + 2 * f * f + f * d
        elif spec.mixer == "ssd":
            s = cfg.ssm
            di = s.d_inner(d)
            total += d * (2 * di + 2 * s.d_state + s.n_heads(d)) + di * d
        if spec.ff == "dense":
            total += 3 * d * cfg.d_ff
        elif spec.ff == "moe":
            m = cfg.moe
            total += 3 * d * m.d_expert * m.top_k + d * m.n_experts
            if m.n_shared_experts:
                total += 3 * d * (m.d_shared or m.n_shared_experts * m.d_expert)
    if cfg.encoder is not None and cfg.encoder.kind == "audio":
        hd = cfg.head_dim_
        enc_layer = d * hd * cfg.padded_heads * 4 + 2 * d * cfg.d_ff
        total += cfg.encoder.n_layers * enc_layer
        total += cfg.n_layers * d * hd * cfg.padded_heads * 4  # cross-attn
    return float(total)
