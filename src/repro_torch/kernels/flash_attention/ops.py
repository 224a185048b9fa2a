"""Hopper KernelSpecs of the attention kernels (``flash_attention``,
``flash_decode``): the tile spaces the wrappers resolve their default from
and the plan compiler sweeps.

``flash_attention`` (whole-prompt prefill):
    problem dims {"sq", "skv", "d", "hq", "hkv", "window"(0=none)}, one
    batch element; tile rank 2 = (bq, bkv). One block owns (b, h, q-block)
    and loops over KV blocks. The dtype picks the regime
    (``flash_attention.regime``): ``mma`` (float32, 3xTF32 on mma.sync, 2
    threads a query row; the float32 q block and a two-stage K/V ring,
    rows padded by 4 floats: 203 KB at (128, 64), D = 128) or ``wgmma``
    (bfloat16, a TMA producer warpgroup and one consumer warpgroup per
    64 rows; the bf16 q block and a two-stage K/V ring in 64-column panels:
    165 KB at (128, 128), D = 128, 198 KB at (128, 64), D = 256). Each
    regime launches bq 64 or 128 and the bkv its source compiles for the
    head dim (``regime_tiles``); the TPU default (512, 1024) launches in
    neither. The default is the tile the H100 measured fastest at qwen2's
    prefill widths (PERF.md).
``flash_decode`` (one query over the KV cache):
    problem dims {"b", "skv", "d", "hq", "hkv", "window"(0=none)};
    tile rank 1 = (bkv,), the KV rows one loop step streams. One block of
    256 threads (320 at D = 80) per (split, kv-head, b), the split count
    derived from B * Hkv and the cache's key blocks, not from the position
    (``decode.split_count``). Shared memory: the grouped queries, the padded
    K and the V blocks, the [n_rep, bkv] logits and statistics — 140 KB at
    bkv = 128, D = 128, n_rep = 8. The default bkv is the largest (up to
    64) whose key blocks give the card a wave of blocks.

A tile the kernel cannot launch (``launch_tile`` / ``launch_bkv`` raise) has
an infinite working set, so no sweep ranks it. The workloads count what the
kernels do: every loaded KV block is computed in full (masked keys too, and
the wgmma regime's zero columns up to whole 64-column panels), and the
causal and window block skips leave blocks out.

``chunked_prefill`` (one chunk of a multi-step prefill over the live cache):
    the reference's problem dims (one admitted prompt, ``sq = skv``) and
    tile rank 2 = (chunk, bkv), so plans stay schema v3. On a TPU the chunk
    is the resident query block and VMEM bounds it per hardware model. On
    the H100 it is not resident: every chunk launches ``flash_attention`` at
    its ``q_offset``, which tiles the chunk's queries into blocks of ``bq``
    = 64 or 128 rows (:func:`chunk_launch_tile`, the default's rule at the
    chunk's length). So shared memory bounds (bq, bkv) alone, and nothing
    on the card bounds the chunk: a longer chunk only saves launches and
    engine steps, so a cost model of them would always pick the longest,
    and a chunk as long as the prompt splits nothing. The chunk is held at
    the reference's default, min(512, sq), and the sweep ranks the bkv
    values the regime compiles at the head dim, each scored as the
    prompt's last chunk's launch with ``FLASH_SPEC``'s workload. The
    engine's ``step_token_budget`` (chunk + decode batch) cuts the chunk
    further when serving.
``packed_prefill`` (the chunks of several requests in one step): the
    reference's dims and tile (pack, bkv). A pack runs one
    ``flash_attention`` launch per segment (its prefix plus its chunk, at
    its ``q_offset``) and the projections, norms and FF once over the
    pack, so the width, held at the reference's min(1024, 8 sq), sets how
    many tokens share those, and the sweep ranks bkv as for a chunk,
    scored as one segment's launch.

A default tile's bkv of 512 is the reference's; where the regime does not
compile it, the launch snaps it (:func:`chunk_launch_tile`) and the call
site reports a ``fallback`` tile event, as the plain version's KV split
does where a bkv does not divide the keys. The sweep never picks such a
bkv.

``kv_page`` (the page size of the paged KV pool, ``serve/pool.py``): the
    reference's problem dims {"skv", "d", "hkv"} and tile rank 1 =
    (page,), repriced for the H100. On a TPU a step stages one K and one V
    page in VMEM, which bounds the page per chip. Here no launch stages a
    page in shared memory: decode gathers the table's pages into a linear
    view and ``flash_decode`` streams that, a chunk gathers its prefix
    pages for ``flash_attention``. So shared memory bounds nothing, and the
    page is bounded by the cache length alone. What a page costs is
    charged in bytes of one decode step's gather, per layer
    (:func:`page_bytes`): the K and V pages read and the view written
    (``n_pt * page`` rows, so a page that does not divide the cache pays
    its rounding every step), a DRAM page opened per contiguous
    (page, head) run, and the ``n_pt`` int32 table entries, which favour
    large pages; a copy-on-write split's page copy once per request
    spread over its ``skv`` steps, and the pool's tail waste (page/2 rows
    a request on average that hold no token, the pool's capacity scaled
    by ``1 + page / (2 skv)``), which favour small ones. The default
    stays the reference's min(512, skv).
"""
from __future__ import annotations

import math
from typing import Mapping

from repro_torch.core import registry
from repro_torch.core.cost_model import (
    BF16_TENSOR, DRAM_PAGE_BYTES, TF32X3, TileWorkload,
)
from repro_torch.core.hardware import H100_SXM
from repro_torch.core.tiling import (
    TileConstraints, TileShape, cdiv, dtype_bytes,
)
from repro_torch.kernels.flash_attention import decode as _decode
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.flash_attention.decode import flash_decode
from repro_torch.kernels.flash_attention.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import (
    attention_dense_ref, flash_attention_ref,
)


def _constraints(problem: Mapping[str, int]) -> TileConstraints:
    # Ragged edges are masked, so a tile may exceed the problem: the axes
    # reach the compiled tiles however short the prompt.
    reach = max(_flash.BQS)
    return TileConstraints(rank=2, max_dims=(max(problem["sq"], reach),
                                             max(problem["skv"], reach)),
                           lane_dim=1, sublane_dim=0, vmem_fraction=1.0)


def _vmem_bytes(tile: TileShape, problem: Mapping[str, int], dtype: str) -> float:
    try:
        bq, bkv = _flash.launch_tile(tile, problem["d"], dtype)
    except ValueError:
        return math.inf
    return float(_flash.smem_bytes(bq, bkv, problem["d"], dtype))


def _keys_loaded(sq: int, skv: int, bq: int, bkv: int, window: int,
                 q_offset: int = 0) -> int:
    """KV rows the kernel loads over all q-blocks of one head (causal, the
    queries at ``q_offset ..``)."""
    total = 0
    for q0 in range(q_offset, q_offset + sq, bq):
        hi = min(skv, q0 + min(bq, q_offset + sq - q0))
        lo = max(0, q0 - window + 1) if window > 0 else 0
        total += (cdiv(hi, bkv) - lo // bkv) * bkv
    return total


def _workload(tile: TileShape, problem: Mapping[str, int], dtype: str) -> TileWorkload:
    bq, bkv = _flash.launch_tile(tile, problem["d"], dtype)
    sq, d = problem["sq"], problem["d"]
    n_q = cdiv(sq, bq)
    keys = _keys_loaded(sq, problem["skv"], bq, bkv, problem["window"],
                        problem.get("q_offset", 0)) / n_q
    b = dtype_bytes(dtype)
    wgmma = _flash.regime(dtype, d) == "wgmma"
    d_math = _flash.panel_dim(d) if wgmma else d
    return TileWorkload(
        flops=4.0 * d_math * bq * keys,            # q.k and p.v per key
        hbm_bytes=float((2 * bq * d + 2 * keys * d) * b),   # q, out; k, v
        row_segments=bq,
        row_stride_bytes=float(d * b),
        threads=_flash.threads(bq, dtype),
        unit=BF16_TENSOR if wgmma else TF32X3,
        bulk_copies=True,              # TMA (wgmma), a cp.async ring (mma)
    )


def _n_tiles(tile: TileShape, problem: Mapping[str, int]) -> int:
    return cdiv(problem["sq"], int(tile[0])) * problem["hq"]


def _default_tile(problem: Mapping[str, int], dtype: str) -> TileShape:
    """The tile the H100 measured fastest (PERF.md), in both regimes:
    128 query rows with the regime's largest bkv once 128-row blocks alone
    fill the card (qwen2-1.5b at S = 4096, recurrentgemma-9b's D = 256
    cells), else (64, 64) (qwen2 at S = 600); the regime's first tile where
    that one does not launch (float32 at D = 256: (64, 32))."""
    d = problem["d"]
    legal = _flash.regime_tiles(dtype, d)
    tile = (64, 64)
    if cdiv(problem["sq"], 128) * problem["hq"] >= H100_SXM.num_sm:
        tile = max((t for t in legal if t[0] == 128), default=tile)
    return TileShape(tile if tile in legal else legal[0])


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
    keys = cdiv(sp.n_blk, sp.used) * bkv      # one block's run of keys
    b = dtype_bytes(dtype)
    # Split KV: each block writes a float32 partial (acc, max, sum) in
    # place of the output, and the combine launch reads every partial and
    # writes the output.
    partial = n_rep * (d + 2) * 4
    out = n_rep * d * b
    groups = problem["b"] * max(problem["hkv"], 1)
    split = sp.splits > 1
    return TileWorkload(
        flops=4.0 * d * n_rep * keys,
        hbm_bytes=float(2 * keys * d * b + n_rep * d * b
                        + (partial if split else out)),
        row_segments=1,
        row_stride_bytes=float(d * b),
        threads=_decode.threads(d),
        extra_launches=int(split),
        extra_bytes=float(groups * (sp.splits * partial + out)) if split
        else 0.0,
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


# ---------------------------------------------------------------------------
# chunked_prefill: one chunk of a multi-step prefill over the live cache.
# ---------------------------------------------------------------------------

def chunk_bq(chunk: int, hq: int) -> int:
    """The query rows a block of a ``chunk``-token launch takes first: 128
    once 128-row blocks alone fill the card, else 64 (``FLASH_SPEC``'s
    default rule at the chunk's length)."""
    return 128 if cdiv(chunk, 128) * hq >= H100_SXM.num_sm else 64


def chunk_launch_tile(tile, chunk: int, hq: int, d: int, dtype):
    """The ``flash_attention`` tile a ``chunked_prefill`` or
    ``packed_prefill`` tile ``(chunk | pack, bkv)`` launches for a chunk of
    ``chunk`` queries: ``(chunk_bq, bkv)``, or the other bq where the
    regime has only that one at this bkv. A bkv the regime does not compile
    at head dim ``d`` snaps to the largest it compiles below it (else its
    smallest), as the plain version's KV split snaps to a divisor
    (``fit_bkv``); the caller tells a snapped launch by its bkv."""
    legal = _flash.regime_tiles(dtype, d)
    bkvs = sorted({b for _, b in legal})
    bkv = max((b for b in bkvs if b <= int(tile[-1])), default=bkvs[0])
    first = chunk_bq(chunk, hq)
    return next((bq, bkv) for bq in (first,) + tuple(
        b for b in _flash.BQS if b != first) if (bq, bkv) in legal)


def _serve_constraints(rows: int, problem: Mapping[str, int]) -> TileConstraints:
    # dim 0 = chunk (or pack) tokens, held at the reference's default: the
    # H100 charges nothing for its length (module docstring); dim 1 = bkv,
    # reaching the compiled values however short the prompt.
    reach = max(_flash.BQS)
    return TileConstraints(rank=2, max_dims=(rows, max(problem["skv"], reach)),
                           lane_dim=1, sublane_dim=0, vmem_fraction=1.0,
                           min_dims=(rows, 1))


def _serve_vmem_bytes(tile: TileShape, problem: Mapping[str, int],
                      dtype: str) -> float:
    # A bkv that would snap at launch is not a candidate.
    rows = min(int(tile[0]), problem["sq"])
    try:
        bq, bkv = chunk_launch_tile(tile, rows, problem["hq"], problem["d"],
                                    dtype)
    except ValueError:
        return math.inf
    if bkv != int(tile[1]):
        return math.inf
    return float(_flash.smem_bytes(bq, bkv, problem["d"], dtype))


def _chunked_workload(tile: TileShape, problem: Mapping[str, int],
                      dtype: str) -> TileWorkload:
    # The prompt's last chunk: its queries over every key before them.
    sq = problem["sq"]
    chunk = min(int(tile[0]), sq)
    launch = chunk_launch_tile(tile, chunk, problem["hq"], problem["d"], dtype)
    return _workload(launch, dict(problem, sq=chunk, q_offset=sq - chunk),
                     dtype)


def _chunked_n_tiles(tile: TileShape, problem: Mapping[str, int]) -> int:
    chunk = min(int(tile[0]), problem["sq"])
    return problem["hq"] * cdiv(chunk, chunk_bq(chunk, problem["hq"]))


def _chunked_default_tile(problem: Mapping[str, int], dtype: str) -> TileShape:
    """The reference's: chunk min(512, sq), bkv min(512, skv), the bkv
    snapped at launch where the regime does not compile it."""
    return TileShape((min(512, problem["sq"]), min(512, problem["skv"])))


CHUNKED_SPEC = registry.register(registry.KernelSpec(
    name="chunked_prefill",
    constraints=lambda problem: _serve_constraints(
        min(512, problem["sq"]), problem),
    vmem_bytes=_serve_vmem_bytes,
    workload=_chunked_workload,
    n_tiles=_chunked_n_tiles,
    default_tile=_chunked_default_tile,
))


# ---------------------------------------------------------------------------
# packed_prefill: several requests' chunks in one engine step.
# ---------------------------------------------------------------------------

# The reference's default round of sq-token segments a pack is sized for.
PACK_ROUND_SEGS = 8


def _packed_width(problem: Mapping[str, int]) -> int:
    return min(1024, PACK_ROUND_SEGS * problem["sq"])


def _packed_workload(tile: TileShape, problem: Mapping[str, int],
                     dtype: str) -> TileWorkload:
    # One segment's launch: its sq queries over its own keys.
    launch = chunk_launch_tile(tile, problem["sq"], problem["hq"],
                               problem["d"], dtype)
    return _workload(launch, problem, dtype)


def _packed_n_tiles(tile: TileShape, problem: Mapping[str, int]) -> int:
    sq = problem["sq"]
    return problem["hq"] * cdiv(sq, chunk_bq(sq, problem["hq"]))


def _packed_default_tile(problem: Mapping[str, int], dtype: str) -> TileShape:
    """The reference's: width min(1024, 8 sq), bkv min(512, skv), the bkv
    snapped at launch where the regime does not compile it."""
    return TileShape((_packed_width(problem), min(512, problem["skv"])))


PACKED_SPEC = registry.register(registry.KernelSpec(
    name="packed_prefill",
    constraints=lambda problem: _serve_constraints(_packed_width(problem),
                                                   problem),
    vmem_bytes=_serve_vmem_bytes,
    workload=_packed_workload,
    n_tiles=_packed_n_tiles,
    default_tile=_packed_default_tile,
))


# ---------------------------------------------------------------------------
# kv_page: the page size of the paged KV pool.
# ---------------------------------------------------------------------------

# Threads of a block of the gather (PyTorch's index_select copy).
GATHER_THREADS = 256


def page_bytes(page: int, problem: Mapping[str, int], dtype: str) -> float:
    """Device-memory bytes one layer's decode step moves because of the
    page size (module docstring): the gathered K and V view read and
    written, a DRAM page per contiguous (page, head) run, the table, a
    copy-on-write page copy spread over the request's steps, all scaled by
    the pool's tail waste."""
    skv, hkv = max(problem["skv"], 1), max(problem["hkv"], 1)
    row = hkv * problem["d"] * dtype_bytes(dtype)
    n_pt = cdiv(skv, page)
    moved = (4 * n_pt * page * row
             + 2 * n_pt * hkv * DRAM_PAGE_BYTES
             + 4 * n_pt
             + 4 * page * row / skv)
    return moved * (1 + page / (2 * skv))


def _kv_page_workload(tile: TileShape, problem: Mapping[str, int],
                      dtype: str) -> TileWorkload:
    # The gather spreads over a wave of blocks, one SM's share a tile.
    return TileWorkload(
        flops=0.0,
        hbm_bytes=page_bytes(int(tile[0]), problem, dtype) / H100_SXM.num_sm,
        row_segments=1,
        row_stride_bytes=float(problem["d"] * dtype_bytes(dtype)),
        threads=GATHER_THREADS,
        bulk_copies=True,
    )


KV_PAGE_SPEC = registry.register(registry.KernelSpec(
    name="kv_page",
    constraints=lambda problem: TileConstraints(
        rank=1, max_dims=(problem["skv"],), lane_dim=0, vmem_fraction=1.0),
    # No launch stages a page in shared memory.
    vmem_bytes=lambda tile, problem, dtype: 0.0,
    workload=_kv_page_workload,
    n_tiles=lambda tile, problem: H100_SXM.num_sm,
    default_tile=lambda problem, dtype: TileShape(
        (min(512, problem["skv"]),)),
))


__all__ = ["CHUNKED_SPEC", "DECODE_SPEC", "FLASH_SPEC", "KV_PAGE_SPEC",
           "PACKED_SPEC", "PACK_ROUND_SEGS", "page_bytes",
           "attention_dense_ref", "chunk_bq", "chunk_launch_tile",
           "flash_attention", "flash_attention_ref", "flash_decode"]
