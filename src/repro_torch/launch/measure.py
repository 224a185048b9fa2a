"""Wall-clock tile measurement on the H100 for plan compilation.

The paper timed every tile candidate on each GPU. ``make_measure_fn``
returns a ``MeasureFn`` (tile -> seconds per call) that runs one kernel's
wrapper on the card, timed with CUDA events after a warm-up; the autotuner prefers these times over the cost
model's (``SweepEntry.measured_s`` outranks ``cost.total_s``); the calls
are replayed from a CUDA graph, so the time is the device's. Each builder
below makes the operands of one kernel's tuning problem on the card, from a
seeded CUDA generator (a decode cell's cache is gigabytes, too much to draw
on the host), and returns a call that launches the kernel with a given
tile.

Gating, with no fallback that hides the card or a kernel:

* ``h100_sxm`` with a CUDA device: timed on the card;
* a modelled descriptor (the paper's GTX260 and 8800GTS, which no machine
  here has): ``None``, so the cell is scored by the cost model;
* ``h100_sxm`` without a CUDA device: ``RuntimeError``;
* a serving cell (``chunked_prefill``, ``packed_prefill``: a tile is a
  step's chunk or pack width, not one launch's block; ``kv_page``: the
  paged pool's page size): ``None``, scored by the cost model, as the
  reference's ``launch/measure.py`` leaves it.

``make_cell_timer`` is the same path for callers that always need a number:
the card's time on the H100, the cost model's score on a modelled target.
"""
from __future__ import annotations

from typing import Callable, Mapping, Optional

import torch

from repro_torch.core.hardware import MODELLED, HardwareModel
from repro_torch.core.tiling import TileShape

MeasureFn = Callable[[TileShape], float]

# Serving cells the cost model scores on every descriptor.
ANALYTIC_ONLY = ("chunked_prefill", "packed_prefill", "kv_page")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _maker(dtype: str, seed: int = 0):
    """``make(shape, lo, hi)``: a tensor on the card in ``dtype``, uniform
    in [lo, hi) (or standard normal with no bounds)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def make(shape, lo=None, hi=None, dt=None):
        if lo is None:
            a = torch.randn(shape, generator=gen, device="cuda")
        else:
            a = torch.rand(shape, generator=gen, device="cuda") * (hi - lo) + lo
        return a.to(dt or _DTYPES[dtype])

    return make


def _matmul_call(problem: Mapping[str, int], dtype: str):
    from repro_torch.kernels.matmul.ops import mm

    make = _maker(dtype)
    m, k, n = problem["m"], problem["k"], problem["n"]
    a, b = make((m, k)), make((k, n))
    return lambda tile: mm(a, b, tile=tuple(tile))


def _flash_call(problem: Mapping[str, int], dtype: str):
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention

    make = _maker(dtype)
    sq, skv, d = problem["sq"], problem["skv"], problem["d"]
    hq, hkv = problem["hq"], problem["hkv"]
    window = problem.get("window", 0) or None
    q = make((1, hq, sq, d))
    k, v = make((1, hkv, skv, d)), make((1, hkv, skv, d))
    return lambda tile: flash_attention(q, k, v, causal=True, window=window,
                                        tile=tuple(tile))


def _flash_decode_call(problem: Mapping[str, int], dtype: str):
    from repro_torch.kernels.flash_attention.decode import flash_decode

    make = _maker(dtype)
    b, skv, d = problem["b"], problem["skv"], problem["d"]
    hq, hkv = problem["hq"], problem["hkv"]
    window = problem.get("window", 0) or None
    q = make((b, hq, d))
    k, v = make((b, hkv, skv, d)), make((b, hkv, skv, d))
    # Steady state: the query at the last slot of a full cache, its
    # position a device scalar as a cache keeps it.
    pos = torch.full((), skv - 1, dtype=torch.int32, device=q.device)
    return lambda tile: flash_decode(q, k, v, pos=pos, window=window,
                                     bkv=int(tile[0]))


def _ssd_call(problem: Mapping[str, int], dtype: str):
    from repro_torch.kernels.ssd.ops import ssd

    make = _maker(dtype)
    s, h, p, n = problem["s"], problem["h"], problem["p"], problem["n"]
    x = make((1, s, h, p))
    dt = make((1, s, h), 0.01, 0.1)
    A = make((h,), -1.5, -0.5, dt=torch.float32)
    Bm, C = make((1, s, n)), make((1, s, n))
    return lambda tile: ssd(x, dt, A, Bm, C, chunk=int(tile[0]))


def _rglru_call(problem: Mapping[str, int], dtype: str):
    from repro_torch.kernels.rglru.ops import rglru

    make = _maker(dtype)
    s, f = problem["s"], problem["f"]
    x = make((1, s, f))
    r, i = make((1, s, f), 0.0, 1.0), make((1, s, f), 0.0, 1.0)
    a = make((f,), dt=torch.float32)
    return lambda tile: rglru(x, r, i, a, tile=tuple(tile))


def _bilinear_call(problem: Mapping[str, int], dtype: str):
    from repro_torch.kernels.bilinear.ops import upscale

    src = _maker(dtype)((problem["src_h"], problem["src_w"]))
    return lambda tile: upscale(src, problem["scale"], tile=tuple(tile))


BUILDERS = {
    "matmul": _matmul_call,
    "flash_attention": _flash_call,
    "flash_decode": _flash_decode_call,
    "ssd": _ssd_call,
    "rglru": _rglru_call,
    "bilinear": _bilinear_call,
}


def time_call(call, warmup: int = 2, iters: int = 5) -> float:
    """Seconds per call of ``call()`` on the card: ``iters`` calls captured
    into a CUDA graph after ``warmup`` calls, one replay timed with CUDA
    events. The replay leaves out the host's launch cost, which is larger
    than a decode-sized kernel's whole time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            call()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            call()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def make_measure_fn(
    kernel: str,
    problem: Mapping[str, int],
    dtype: str,
    hw: HardwareModel,
    warmup: int = 2,
    iters: int = 5,
) -> Optional[MeasureFn]:
    """A tile -> seconds hook for one cell on the card, or None for a
    modelled descriptor or a serving cell (``ANALYTIC_ONLY``). Raises
    without a CUDA device, or for a kernel with no operand builder."""
    if hw.name in MODELLED or kernel in ANALYTIC_ONLY:
        return None
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"wall-clock timing on {hw.name} needs its card: no CUDA device "
            f"is available (use --measure analytic on this host)")
    builder = BUILDERS.get(kernel)
    if builder is None:
        raise KeyError(f"no wall-clock builder for kernel {kernel!r}; "
                       f"known: {sorted(BUILDERS)}")
    call = builder(problem, dtype)
    return lambda tile: time_call(lambda: call(tile), warmup, iters)


def make_cell_timer(
    kernel: str,
    problem: Mapping[str, int],
    dtype: str,
    hw: HardwareModel,
    warmup: int = 1,
    iters: int = 3,
) -> MeasureFn:
    """Always a callable: the card's time via :func:`make_measure_fn`, or on
    a modelled descriptor the cost-model score the plan was ranked by."""
    fn = make_measure_fn(kernel, problem, dtype, hw, warmup=warmup, iters=iters)
    if fn is not None:
        return lambda tile: fn(TileShape(tuple(tile)))
    from repro_torch.core.plans import score_tile

    return lambda tile: score_tile(kernel, TileShape(tuple(tile)),
                                   dict(problem), dtype, hw)
