"""Runtime serving telemetry: per-bucket latency, queue depth, plan counters.

One :class:`ServeMetrics` instance rides along with a ``ServeEngine`` (the
fleet router aggregates one per instance). Everything is plain Python — no
jax — so recording on the request path costs nanoseconds and the whole
object exports as a dict (``as_dict``) for logging / the launcher to print.

Measured quantities follow serving convention:

* **TTFT** (time to first token): request *submit* -> end of the prefill
  that produced the request's first token, per bucket. Submit-anchored on
  purpose: with chunked prefill a request's first token can trail its
  admission by many engine steps, and measuring from admission would hide
  exactly the queueing the chunk scheduler manages. Means come with
  p50/p95/p99 — tail latency is what head-of-line blocking moves.
* **TPOT** (time per output token): decode-step wall time divided by the
  number of active slots, attributed to each active request's bucket.
* **Queue depth**: scheduler backlog sampled at every engine step AND at
  every admit/reject, so backlog accrued while an engine sits idle between
  steps is visible instead of silently missing.
* **Plan counters**: how each kernel-tile lookup was satisfied — ``exact``,
  ``nearest_shape``, ``cross_hardware`` (the paper's transferred-optimum
  case), ``fallback`` (heuristic default), or ``no_plan`` — split by phase
  (``prefill`` / ``decode``). ``plan_hit_rate()`` is the exact-hit fraction,
  the quantity the shape-bucketed scheduler exists to maximize.
* **Chunked prefill**: per-chunk queue age (gap since the request last made
  prefill progress), a chunks-per-prefill histogram, a packed-chunks-per-
  step histogram (how many prefill chunks rode each packed step), and
  per-step mixed token counts. Rejections carry an explicit reason
  (``over_length`` / ``queue_full`` / ``cache_overflow``) — admission
  never drops silently.
* **Shadow execution**: ``record_shadow`` keeps per-(kernel, tile) timing
  stats for the candidate tiles the engine measures on diverted steps (see
  ``repro.serve.refine``) next to the incumbent's, so the telemetry export
  carries the raw material the :class:`~repro.serve.refine.PlanRefiner`
  re-ranks from. ``ttft_counts``/``ttft_window``/``ttft_p95`` support
  windowed p95 reads (samples since a marked count), the rollback guard's
  regression signal; a window wider than the retained circular buffer is
  flagged ``clipped`` so guards don't act on a corrupted window.

* **Paged KV pool**: page alloc/free counts, copy-on-write splits,
  shared-prefix lookup/hit counts with tokens-reused, and pool occupancy
  samples (peak + mean pages in use) — the ``repro.serve.pool`` health
  readout (``prefix_hit_rate`` is the fleet-wide prefill-dedup win).

Metrics are aggregates; the causal, per-event record (which requests shared
a packed step, which plan entry resolved each kernel launch, where a chunk
sat queued) is the trace layer — see :mod:`repro.obs.trace` and the
``python -m repro.launch.trace_report`` CLI. ``as_dict()`` output is
deterministic (sorted keys, stable nesting) and stamped with
``metrics_schema`` = :data:`METRICS_SCHEMA_VERSION` so golden tests and CI
artifact diffs are ordering-insensitive.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import Counter, defaultdict
from typing import Callable, Dict, List, Optional, Tuple

# Resolution sources, in decreasing order of trustworthiness. "fallback" is
# the heuristic default tile (plan had nothing usable); "tile_fallback"
# means a resolved tile did not legally apply at the kernel call site (the
# lowering degraded to a reference path or an adjusted chunk — see
# ``models.attention.capture_tile_events``); "no_plan" means the engine was
# constructed without an artifact at all.
PLAN_SOURCES = ("exact", "nearest_shape", "cross_hardware", "fallback",
                "tile_fallback", "no_plan")

# Bump on any change to the ``as_dict()`` layout (keys, nesting, units) so
# downstream consumers of exported metrics artifacts can gate on it.
# v2: added the "pool" section (paged KV pool occupancy, prefix reuse,
# copy-on-write splits).
METRICS_SCHEMA_VERSION = 2


def nearest_rank(xs: List[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 1]) over ``xs`` (0.0 if empty).

    The single percentile definition shared by ``_LatencyStat``, the
    windowed TTFT reads, ``FleetRouter.roll_plans`` and the trace-report
    CLI — one formula, so a trace's span durations reproduce the metrics'
    percentiles exactly.
    """
    if not xs:
        return 0.0
    ordered = sorted(xs)
    return ordered[max(0, math.ceil(q * len(ordered)) - 1)]


@dataclasses.dataclass
class _LatencyStat:
    count: int = 0
    total_s: float = 0.0
    max_s: float = 0.0
    # Raw samples for percentiles, capped to bound memory on long runs:
    # beyond the cap the buffer is circular, so percentiles describe the
    # most recent ``sample_cap`` observations (a sliding window) while
    # count/mean/max keep covering the whole run.
    samples: List[float] = dataclasses.field(default_factory=list)
    sample_cap: int = 8192

    def record(self, dt: float) -> None:
        self.count += 1
        self.total_s += dt
        self.max_s = max(self.max_s, dt)
        if len(self.samples) < self.sample_cap:
            self.samples.append(dt)
        else:
            # count was already incremented: sample #count lives at slot
            # (count - 1) % cap, keeping the window exactly the newest cap.
            self.samples[(self.count - 1) % self.sample_cap] = dt

    @property
    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile over the recorded samples (0 if none)."""
        return nearest_rank(self.samples, q / 100.0)

    def recent(self, n: int) -> List[float]:
        """The newest ``n`` samples, oldest first (bounded by the window)."""
        n = min(n, len(self.samples))
        if n <= 0:
            return []
        if len(self.samples) < self.sample_cap:
            return self.samples[-n:]
        # Circular: the newest sample lives at (count - 1) % cap.
        return [self.samples[(self.count - n + i) % self.sample_cap]
                for i in range(n)]

    def as_dict(self) -> Dict[str, float]:
        return {"count": self.count, "mean_s": self.mean_s,
                "max_s": self.max_s,
                "p50_s": self.percentile(50),
                "p95_s": self.percentile(95),
                "p99_s": self.percentile(99)}


class ServeMetrics:
    """Mutable counters; ``clock`` is injectable for deterministic tests."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self.clock = clock
        self.submitted = 0
        self.rejected = 0
        self.completed = 0
        self.tokens_out = 0
        self._submit_t: Dict[int, float] = {}          # rid -> submit time
        self.ttft: Dict[object, _LatencyStat] = defaultdict(_LatencyStat)
        self.tpot: Dict[object, _LatencyStat] = defaultdict(_LatencyStat)
        self.queue_depth_max = 0
        self._queue_depth_sum = 0
        self._queue_depth_n = 0
        # (phase, source) -> count and (phase, kernel) -> source breakdown.
        self.plan_counts: Counter = Counter()
        self.plan_by_kernel: Dict[str, Counter] = defaultdict(Counter)
        # Chunked-prefill telemetry.
        self.reject_reasons: Counter = Counter()
        self.chunks_run = 0
        self.chunk_age: Dict[object, _LatencyStat] = defaultdict(_LatencyStat)
        self.chunks_per_prefill: Counter = Counter()
        # Step packing: how many prefill chunks rode each packed step — the
        # occupancy histogram the packing bench uploads as a CI artifact.
        self.packed_chunks_per_step: Counter = Counter()
        # Shadow execution: per-(kernel, tile) measured timings from the
        # engine's diverted steps, plus which tile was the incumbent when
        # last measured. Keys are str(tile) so the export is JSON-clean.
        self.shadow_steps = 0
        self.shadow_time: Dict[tuple, _LatencyStat] = defaultdict(_LatencyStat)
        self.shadow_incumbents: Dict[str, str] = {}
        # Paged KV pool (repro.serve.pool): page churn, shared-prefix
        # reuse, copy-on-write splits, and occupancy samples.
        self.pool_page_allocs = 0
        self.pool_page_frees = 0
        self.pool_cow_splits = 0
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefix_tokens_reused = 0
        self.pool_used_max = 0
        self.pool_total = 0
        self._pool_used_sum = 0
        self._pool_used_n = 0

    # -- request lifecycle ---------------------------------------------------
    def record_submit(self, rid: int, t: Optional[float] = None) -> None:
        """Record one submit. ``t`` backdates the anchor: a request
        re-queued after an engine failure keeps its ORIGINAL submit time,
        so its recovered first token's TTFT covers the whole outage —
        tail metrics tell the truth across retries."""
        self.submitted += 1
        self._submit_t[rid] = self.clock() if t is None else t

    def drop_submit(self, rid: int) -> Optional[float]:
        """Forget a pending submit anchor (the request was evicted, stolen,
        or handed off before its first token here). Returns the dropped
        timestamp so fleet recovery can re-anchor it on the next engine;
        None (and a no-op) when the request already produced its first
        token."""
        return self._submit_t.pop(rid, None)

    def record_reject(self, bucket: Optional[object] = None,
                      reason: str = "admission") -> None:
        del bucket  # per-bucket reject split not tracked yet
        self.rejected += 1
        self.reject_reasons[reason] += 1

    def submit_time(self, rid: int) -> Optional[float]:
        """Submit timestamp of a not-yet-first-token request (else None)."""
        return self._submit_t.get(rid)

    def record_first_token(self, rid: int, bucket: object,
                           t: Optional[float] = None) -> None:
        """One first token, at ``t`` (default: now). A traced engine reads
        the clock once and gives the same ``t`` to its trace's ``ttft``
        span, so the two agree exactly on a live clock too."""
        self.tokens_out += 1   # prefill samples the request's first token
        t0 = self._submit_t.pop(rid, None)
        if t0 is not None:
            self.ttft[bucket].record((self.clock() if t is None else t) - t0)

    def record_decode_step(self, buckets, dt: float) -> None:
        """One engine decode step over ``buckets`` (one entry per active
        slot); each slot produced one token in ``dt`` seconds total."""
        n = len(buckets)
        if not n:
            return
        per_tok = dt / n
        for b in buckets:
            self.tpot[b].record(per_tok)
        self.tokens_out += n

    def record_complete(self) -> None:
        self.completed += 1

    # -- chunked prefill -----------------------------------------------------
    def record_chunk(self, bucket: object, queue_age_s: float) -> None:
        """One prefill chunk ran; ``queue_age_s`` is how long the request
        sat without prefill progress before this chunk (submit -> first
        chunk, then chunk -> chunk) — the quantity the per-step token
        budget trades against decode latency."""
        self.chunks_run += 1
        self.chunk_age[bucket].record(queue_age_s)

    def record_prefill_chunks(self, n_chunks: int) -> None:
        """A request's prefill completed after ``n_chunks`` chunks."""
        self.chunks_per_prefill[n_chunks] += 1

    def record_packed_step(self, n_chunks: int) -> None:
        """A packed step ran ``n_chunks`` prefill chunks in one launch."""
        self.packed_chunks_per_step[n_chunks] += 1

    # -- shadow execution ----------------------------------------------------
    def record_shadow_step(self) -> None:
        """One engine step was diverted to shadow measurement."""
        self.shadow_steps += 1

    def record_shadow(self, kernel: str, tile, dt: float,
                      incumbent: bool = False) -> None:
        """One shadow measurement: ``tile`` (a dims tuple/TileShape) ran the
        ``kernel`` cell in ``dt`` measured seconds. ``incumbent`` marks the
        serving tile's own measurement, recorded next to each candidate's so
        the refiner's speedup gate compares like with like."""
        key = str(tuple(tile))
        self.shadow_time[(kernel, key)].record(dt)
        if incumbent:
            self.shadow_incumbents[kernel] = key

    # -- paged KV pool -------------------------------------------------------
    def record_page_alloc(self, n: int = 1) -> None:
        self.pool_page_allocs += n

    def record_page_free(self, n: int = 1) -> None:
        self.pool_page_frees += n

    def record_cow_split(self, n: int = 1) -> None:
        self.pool_cow_splits += n

    def record_prefix_lookup(self, hit_tokens: int) -> None:
        """One shared-prefix lookup; ``hit_tokens`` > 0 means the request
        mapped that many already-prefilled tokens instead of recomputing
        them (the fleet-wide prefill dedup win)."""
        self.prefix_lookups += 1
        if hit_tokens > 0:
            self.prefix_hits += 1
            self.prefix_tokens_reused += hit_tokens

    def record_pool(self, used: int, total: int) -> None:
        """One pool-occupancy sample (pages in use / pool size)."""
        self.pool_total = total
        self.pool_used_max = max(self.pool_used_max, used)
        self._pool_used_sum += used
        self._pool_used_n += 1

    def prefix_hit_rate(self) -> float:
        return (self.prefix_hits / self.prefix_lookups
                if self.prefix_lookups else 0.0)

    @property
    def pool_used_mean(self) -> float:
        return (self._pool_used_sum / self._pool_used_n
                if self._pool_used_n else 0.0)

    # -- TTFT windows (rollout guard) ----------------------------------------
    def ttft_counts(self) -> Dict[object, int]:
        """Per-bucket TTFT sample counts — a mark for windowed reads."""
        return {b: s.count for b, s in self.ttft.items()}

    def ttft_window(self, marks: Optional[Dict[object, int]] = None
                    ) -> "Tuple[List[float], bool]":
        """(samples recorded after ``marks``, clipped) — every bucket pooled.

        ``clipped`` is True when any bucket's window is wider than its
        retained circular buffer (``_LatencyStat.sample_cap``): the buffer
        overwrote samples inside the window, so the returned list silently
        misses observations. Guards (``FleetRouter.roll_plans``) must treat
        a clipped window as inconclusive rather than reading it as a
        faithful record. With no marks the window is the whole run, so
        clipping means "the run outgrew the buffer".
        """
        out: List[float] = []
        clipped = False
        for b, s in self.ttft.items():
            n_new = s.count - (marks.get(b, 0) if marks else 0)
            if n_new > len(s.samples):
                clipped = True
            out.extend(s.recent(n_new))
        return out, clipped

    def ttft_since(self, marks: Optional[Dict[object, int]] = None
                   ) -> List[float]:
        """All TTFT samples recorded after ``marks`` (every bucket pooled);
        with no marks, every retained sample. Bounded by the per-bucket
        sliding sample window — use :meth:`ttft_window` to learn whether
        the window was clipped by that bound."""
        return self.ttft_window(marks)[0]

    def ttft_p95(self, marks: Optional[Dict[object, int]] = None) -> float:
        """Nearest-rank p95 over the (windowed) pooled TTFT samples."""
        return nearest_rank(self.ttft_since(marks), 0.95)

    def record_queue_depth(self, depth: int) -> None:
        self.queue_depth_max = max(self.queue_depth_max, depth)
        self._queue_depth_sum += depth
        self._queue_depth_n += 1

    # -- plan resolution -----------------------------------------------------
    def record_plan(self, phase: str, kernel: str, source: str) -> None:
        if source not in PLAN_SOURCES:
            source = "fallback"
        self.plan_counts[(phase, source)] += 1
        self.plan_by_kernel[kernel][source] += 1

    def plan_hit_rate(self, phase: Optional[str] = None) -> float:
        """Exact-hit fraction over all recorded resolutions (0.0 if none)."""
        total = hits = 0
        for (ph, source), n in self.plan_counts.items():
            if phase is not None and ph != phase:
                continue
            total += n
            if source == "exact":
                hits += n
        return hits / total if total else 0.0

    # -- export --------------------------------------------------------------
    @property
    def queue_depth_mean(self) -> float:
        return (self._queue_depth_sum / self._queue_depth_n
                if self._queue_depth_n else 0.0)

    def as_dict(self) -> Dict[str, object]:
        plan = {src: 0 for src in PLAN_SOURCES}
        by_phase: Dict[str, Dict[str, int]] = defaultdict(
            lambda: {src: 0 for src in PLAN_SOURCES})
        for (phase, source), n in self.plan_counts.items():
            plan[source] += n
            by_phase[phase][source] += n
        return {
            "metrics_schema": METRICS_SCHEMA_VERSION,
            "requests": {
                "submitted": self.submitted,
                "rejected": self.rejected,
                "completed": self.completed,
                "tokens_out": self.tokens_out,
            },
            "rejects": dict(sorted(self.reject_reasons.items())),
            "queue_depth": {
                "max": self.queue_depth_max,
                "mean": self.queue_depth_mean,
            },
            "chunked_prefill": {
                "chunks_run": self.chunks_run,
                "chunks_per_prefill": {
                    str(n): c for n, c in
                    sorted(self.chunks_per_prefill.items())},
                "packed_chunks_per_step": {
                    str(n): c for n, c in
                    sorted(self.packed_chunks_per_step.items())},
                "chunk_age_s": {str(b): s.as_dict() for b, s in sorted(
                    self.chunk_age.items(), key=lambda kv: str(kv[0]))},
            },
            "shadow": {
                "steps": self.shadow_steps,
                "incumbents": dict(sorted(self.shadow_incumbents.items())),
                "samples": {
                    kernel: {
                        tile: stat.as_dict()
                        for (k, tile), stat in sorted(
                            self.shadow_time.items(),
                            key=lambda kv: kv[0]) if k == kernel
                    }
                    for kernel in sorted({k for k, _ in self.shadow_time})
                },
            },
            "pool": {
                "page_allocs": self.pool_page_allocs,
                "page_frees": self.pool_page_frees,
                "cow_splits": self.pool_cow_splits,
                "prefix_lookups": self.prefix_lookups,
                "prefix_hits": self.prefix_hits,
                "prefix_hit_rate": self.prefix_hit_rate(),
                "prefix_tokens_reused": self.prefix_tokens_reused,
                "pages_total": self.pool_total,
                "pages_used_max": self.pool_used_max,
                "pages_used_mean": self.pool_used_mean,
            },
            "ttft_s": {str(b): s.as_dict() for b, s in sorted(
                self.ttft.items(), key=lambda kv: str(kv[0]))},
            "tpot_s": {str(b): s.as_dict() for b, s in sorted(
                self.tpot.items(), key=lambda kv: str(kv[0]))},
            "plan": {
                "counts": plan,
                "by_phase": {k: dict(v) for k, v in sorted(by_phase.items())},
                "hit_rate": self.plan_hit_rate(),
                "hit_rate_prefill": self.plan_hit_rate("prefill"),
                "hit_rate_decode": self.plan_hit_rate("decode"),
                # Inner dicts sorted too: Counter order is insertion order,
                # which varies with resolution order across runs.
                "by_kernel": {
                    k: {s: c[s] for s in sorted(c)}
                    for k, c in sorted(self.plan_by_kernel.items())},
            },
        }

    def render(self) -> str:
        """Human-readable multi-line summary (the launcher prints this)."""
        d = self.as_dict()
        lines = [
            "serve metrics:",
            f"  requests: {d['requests']['submitted']} submitted, "
            f"{d['requests']['rejected']} rejected, "
            f"{d['requests']['completed']} completed, "
            f"{d['requests']['tokens_out']} tokens",
            f"  queue depth: max {d['queue_depth']['max']}, "
            f"mean {d['queue_depth']['mean']:.1f}",
            f"  plan hit rate: {d['plan']['hit_rate']:.2f} "
            f"(prefill {d['plan']['hit_rate_prefill']:.2f}, "
            f"decode {d['plan']['hit_rate_decode']:.2f}) "
            f"counts {d['plan']['counts']}",
        ]
        if d["rejects"]:
            lines.append(f"  rejects: {d['rejects']}")
        if self.chunks_run:
            lines.append(
                f"  chunked prefill: {self.chunks_run} chunks, "
                f"chunks/prefill "
                f"{d['chunked_prefill']['chunks_per_prefill']}")
        if self.packed_chunks_per_step:
            lines.append(
                f"  step packing: chunks/step "
                f"{d['chunked_prefill']['packed_chunks_per_step']}")
        if self.shadow_steps:
            lines.append(
                f"  shadow: {self.shadow_steps} diverted steps, "
                f"{len(self.shadow_time)} (kernel, tile) cells measured")
        if self.pool_total:
            lines.append(
                f"  kv pool: {self.pool_used_max}/{self.pool_total} pages "
                f"peak ({self.pool_used_mean:.1f} mean), "
                f"{self.pool_page_allocs} allocs / "
                f"{self.pool_page_frees} frees, "
                f"{self.pool_cow_splits} cow splits, "
                f"prefix hit rate {self.prefix_hit_rate():.2f} "
                f"({self.prefix_tokens_reused} tokens reused)")
        for label, table in (("ttft", d["ttft_s"]), ("tpot", d["tpot_s"])):
            for bucket, stat in table.items():
                lines.append(
                    f"  {label}[{bucket}]: n={stat['count']} "
                    f"mean={stat['mean_s'] * 1e3:.2f}ms "
                    f"p95={stat['p95_s'] * 1e3:.2f}ms "
                    f"max={stat['max_s'] * 1e3:.2f}ms")
        return "\n".join(lines)
