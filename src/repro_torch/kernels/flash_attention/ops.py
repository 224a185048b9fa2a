"""Hopper KernelSpecs of the attention kernels (``flash_attention``,
``flash_decode``) — the tile spaces the wrappers resolve their default from.

``flash_attention`` (whole-prompt prefill):
    problem dims {"sq", "skv", "d", "hq", "hkv", "window"(0=none)};
    tile rank 2 = (bq, bkv). One thread block owns (b, h, q-block) and
    loops over KV blocks, so a tile's shared memory is the float32 q block,
    the padded K and the V blocks, the [bq, bkv] logits and three per-row
    statistics. The TPU default (512, 1024) would need 3.4 MB of it; the
    Hopper default (64, 32) needs 75 KB at D = 128.
``flash_decode`` (one query over the KV cache):
    problem dims {"b", "skv", "d", "hq", "hkv", "window"(0=none)};
    tile rank 1 = (bkv,), the KV rows one loop step streams. Shared memory:
    the grouped queries, the padded K and the V blocks, the [n_rep, bkv]
    logits and statistics — 140 KB at bkv = 128, D = 128, n_rep = 8.

The chunked_prefill, packed_prefill and kv_page specs of the reference come
with the chunked, packed and paged serving paths.
"""
from __future__ import annotations

from typing import Mapping

from repro_torch.core import registry
from repro_torch.core.tiling import TileConstraints, TileShape, round_up
from repro_torch.kernels.flash_attention import decode as _decode
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.flash_attention.decode import flash_decode
from repro_torch.kernels.flash_attention.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import (
    attention_dense_ref, flash_attention_ref,
)


def _constraints(problem: Mapping[str, int]) -> TileConstraints:
    return TileConstraints(rank=2, max_dims=(problem["sq"], problem["skv"]),
                           lane_dim=1, sublane_dim=0)


def _vmem_bytes(tile: TileShape, problem: Mapping[str, int], dtype: str) -> float:
    bq, bkv = tile
    return float(_flash.smem_bytes(bq, bkv, problem["d"]))


def _default_tile(problem: Mapping[str, int], dtype: str) -> TileShape:
    return TileShape((min(64, round_up(problem["sq"], 4)),
                      min(32, round_up(problem["skv"], 4))))


FLASH_SPEC = registry.register(registry.KernelSpec(
    name="flash_attention",
    constraints=_constraints,
    vmem_bytes=_vmem_bytes,
    default_tile=_default_tile,
))


def _group_rows(problem: Mapping[str, int]) -> int:
    return max(problem["hq"] // max(problem["hkv"], 1), 1)


def _decode_constraints(problem: Mapping[str, int]) -> TileConstraints:
    return TileConstraints(rank=1, max_dims=(problem["skv"],), lane_dim=0)


def _decode_vmem_bytes(tile: TileShape, problem: Mapping[str, int],
                       dtype: str) -> float:
    return float(_decode.smem_bytes(_group_rows(problem), tile[0], problem["d"]))


def _decode_default_tile(problem: Mapping[str, int], dtype: str) -> TileShape:
    return TileShape((min(128, problem["skv"]),))


DECODE_SPEC = registry.register(registry.KernelSpec(
    name="flash_decode",
    constraints=_decode_constraints,
    vmem_bytes=_decode_vmem_bytes,
    default_tile=_decode_default_tile,
))


__all__ = ["DECODE_SPEC", "FLASH_SPEC", "attention_dense_ref", "flash_attention",
           "flash_attention_ref", "flash_decode"]
