"""Hopper KernelSpecs of the attention kernels (``flash_attention``,
``flash_decode``): the tile spaces the wrappers resolve their default from
and the plan compiler sweeps.

``flash_attention`` (whole-prompt prefill):
    problem dims {"sq", "skv", "d", "hq", "hkv", "window"(0=none)}, one
    batch element; tile rank 2 = (bq, bkv). One 256-thread block owns
    (b, h, q-block) and loops over KV blocks, so a tile's shared memory is
    the float32 q block, the padded K and the V blocks, the [bq, bkv]
    logits and three per-row statistics. The TPU default (512, 1024) would
    need 3.4 MB of it; the Hopper default (64, 32) needs 75 KB at D = 128
    and 140 KB at D = 256.
``flash_decode`` (one query over the KV cache):
    problem dims {"b", "skv", "d", "hq", "hkv", "window"(0=none)};
    tile rank 1 = (bkv,), the KV rows one loop step streams. One 256-thread
    block per (split, kv-head, b), the splits derived from the grid
    (``decode.split_count``). Shared memory: the grouped queries, the padded
    K and the V blocks, the [n_rep, bkv] logits and statistics — 140 KB at
    bkv = 128, D = 128, n_rep = 8. The default bkv is the largest (up to
    64) whose key blocks give the card a wave of blocks.

A tile the kernel cannot launch (``launch_tile`` / ``launch_bkv`` raise) has
an infinite working set, so no sweep ranks it. The workloads count what the
kernels do: every loaded KV block is computed in full (masked keys too),
and the causal and window block skips leave blocks out.

The chunked_prefill, packed_prefill and kv_page specs of the reference come
with the chunked, packed and paged serving paths.
"""
from __future__ import annotations

import math
from typing import Mapping

from repro_torch.core import registry
from repro_torch.core.cost_model import TileWorkload
from repro_torch.core.hardware import H100_SXM
from repro_torch.core.tiling import (
    TileConstraints, TileShape, cdiv, dtype_bytes, round_up,
)
from repro_torch.kernels.flash_attention import decode as _decode
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.flash_attention.decode import flash_decode
from repro_torch.kernels.flash_attention.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import (
    attention_dense_ref, flash_attention_ref,
)


THREADS = 256   # threads per block of both attention kernels


def _constraints(problem: Mapping[str, int]) -> TileConstraints:
    return TileConstraints(rank=2, max_dims=(problem["sq"], problem["skv"]),
                           lane_dim=1, sublane_dim=0, vmem_fraction=1.0)


def _vmem_bytes(tile: TileShape, problem: Mapping[str, int], dtype: str) -> float:
    try:
        bq, bkv = _flash.launch_tile(tile, problem["sq"], problem["skv"],
                                     problem["d"])
    except ValueError:
        return math.inf
    return float(_flash.smem_bytes(bq, bkv, problem["d"]))


def _keys_loaded(sq: int, skv: int, bq: int, bkv: int, window: int) -> int:
    """KV rows the kernel loads over all q-blocks of one head (causal)."""
    total = 0
    for q0 in range(0, sq, bq):
        hi = min(skv, q0 + min(bq, sq - q0))
        lo = max(0, q0 - window + 1) if window > 0 else 0
        total += (cdiv(hi, bkv) - lo // bkv) * bkv
    return total


def _workload(tile: TileShape, problem: Mapping[str, int], dtype: str) -> TileWorkload:
    bq, bkv = _flash.launch_tile(tile, problem["sq"], problem["skv"],
                                 problem["d"])
    sq, d = problem["sq"], problem["d"]
    n_q = cdiv(sq, bq)
    keys = _keys_loaded(sq, problem["skv"], bq, bkv, problem["window"]) / n_q
    b = dtype_bytes(dtype)
    return TileWorkload(
        flops=4.0 * d * bq * keys,                 # q.k and p.v per key
        hbm_bytes=float((2 * bq * d + 2 * keys * d) * b),   # q, out; k, v
        row_segments=bq,
        row_stride_bytes=float(d * b),
        threads=THREADS,
    )


def _n_tiles(tile: TileShape, problem: Mapping[str, int]) -> int:
    bq, _ = _flash.launch_tile(tile, problem["sq"], problem["skv"],
                               problem["d"])
    return cdiv(problem["sq"], bq) * problem["hq"]


def _default_tile(problem: Mapping[str, int], dtype: str) -> TileShape:
    return TileShape((min(64, round_up(problem["sq"], 4)),
                      min(32, round_up(problem["skv"], 4))))


FLASH_SPEC = registry.register(registry.KernelSpec(
    name="flash_attention",
    constraints=_constraints,
    vmem_bytes=_vmem_bytes,
    workload=_workload,
    n_tiles=_n_tiles,
    default_tile=_default_tile,
))


def _group_rows(problem: Mapping[str, int]) -> int:
    return max(problem["hq"] // max(problem["hkv"], 1), 1)


def _decode_constraints(problem: Mapping[str, int]) -> TileConstraints:
    return TileConstraints(rank=1, max_dims=(problem["skv"],), lane_dim=0,
                           vmem_fraction=1.0)


def _decode_vmem_bytes(tile: TileShape, problem: Mapping[str, int],
                       dtype: str) -> float:
    n_rep, d = _group_rows(problem), problem["d"]
    try:
        bkv = _decode.launch_bkv(tile[0], problem["skv"], d, n_rep)
    except ValueError:
        return math.inf
    return float(_decode.smem_bytes(n_rep, bkv, d))


def _decode_splits(bkv: int, problem: Mapping[str, int]):
    # Steady state: the query at the last slot of a full linear cache.
    s = problem["skv"]
    return _decode.decode_splits(problem["b"], max(problem["hkv"], 1), s,
                                 bkv, s - 1, True, problem["window"] or None)


def _decode_workload(tile: TileShape, problem: Mapping[str, int],
                     dtype: str) -> TileWorkload:
    n_rep, d, s = _group_rows(problem), problem["d"], problem["skv"]
    bkv = _decode.launch_bkv(tile[0], s, d, n_rep)
    sp = _decode_splits(bkv, problem)
    keys = cdiv(sp.n_blk, sp.splits) * bkv    # one block's run of keys
    b = dtype_bytes(dtype)
    return TileWorkload(
        flops=4.0 * d * n_rep * keys,
        hbm_bytes=float((2 * keys * d + 2 * n_rep * d) * b),
        row_segments=1,
        row_stride_bytes=float(d * b),
        threads=THREADS,
    )


def _decode_n_tiles(tile: TileShape, problem: Mapping[str, int]) -> int:
    bkv = _decode.launch_bkv(tile[0], problem["skv"], problem["d"],
                             _group_rows(problem))
    return (problem["b"] * max(problem["hkv"], 1)
            * _decode_splits(bkv, problem).splits)


def _decode_default_tile(problem: Mapping[str, int], dtype: str) -> TileShape:
    # The largest of 64 ... 8 KV rows whose block fits in shared memory and
    # whose visible key blocks, one or more a split, make a wave of blocks
    # over the card; the smallest that fits if none does. (128 rows lost
    # to 64 by 1.4x at B = 128 on the H100, PERF.md.)
    groups = problem["b"] * max(problem["hkv"], 1)
    window = problem["window"]
    visible = min(problem["skv"], window) if window > 0 else problem["skv"]
    fits = [TileShape((min(bkv, problem["skv"]),)) for bkv in
            (64, 32, 16, 8)]
    fits = [t for t in fits
            if math.isfinite(_decode_vmem_bytes(t, problem, dtype))]
    for tile in fits:
        if groups * cdiv(visible, tile[0]) >= H100_SXM.num_sm \
                or groups >= H100_SXM.num_sm:
            return tile
    return fits[-1]


DECODE_SPEC = registry.register(registry.KernelSpec(
    name="flash_decode",
    constraints=_decode_constraints,
    vmem_bytes=_decode_vmem_bytes,
    workload=_decode_workload,
    n_tiles=_decode_n_tiles,
    default_tile=_decode_default_tile,
))


__all__ = ["DECODE_SPEC", "FLASH_SPEC", "attention_dense_ref", "flash_attention",
           "flash_attention_ref", "flash_decode"]
