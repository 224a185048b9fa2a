"""Span/event tracer for the port's serving stack.

The port's copy of ``repro/obs/trace.py``, with the same event names,
lanes and schema version, so either package's ``trace_report`` reads the
other's files. The tracer is the serving fleet's flight recorder: every
engine attaches as a *process* (a Perfetto process row) and records
events on fixed *lanes* (thread rows) against the **injected clock** — the
same callable the engine and its
:class:`~repro_torch.serve.metrics.ServeMetrics` run on, so virtual-clock
runs produce deterministic, byte-identical traces while live runs trace
wall time.

What a span measures on the card. Every timestamp is the host's clock,
and tracing adds no synchronisation. A span that ends after a readback
holds the device's time up to it: the ``decode`` span (the step reads its
tokens back with one ``.tolist()``), a whole-prompt ``prefill`` span, and
the ``first_token`` instant and ``ttft`` span (the first token is read
back with ``int(argmax)``). A ``chunk`` span is recorded before its
prompt's first token is sampled, so it ends when the chunk's kernels are
queued: it is the host's launch time alone, and the device work it queued
lands in whichever later span reads back first. ``step`` spans run from
one step's start to the next's, so they hold everything. The engine reads
the clock once for a first token and gives that time to both its metrics
and the ``ttft`` span (the reference reads it twice), so the trace's TTFT
percentiles equal ``ServeMetrics``' exactly on a live clock too.

Event vocabulary (names are a stable contract with
``repro_torch.launch.trace_report``):

- ``submit`` / ``admit`` / ``reject`` / ``first_token`` / ``finish`` —
  request-lifecycle instants on the lifecycle lane, plus one async
  ``req`` span per request (submit → finish) and one complete ``ttft``
  span whose ``ts`` is the submit time and whose ``dur`` is exactly the
  engine's recorded TTFT, so a trace reproduces
  ``ServeMetrics.ttft[...].percentile(0.95)`` by nearest-rank over span
  durations.
- ``step`` — one complete span per engine step. Under a virtual clock
  time only advances *between* steps, so step spans are **deferred**:
  step N's span closes when step N+1 begins (or at flush), giving each
  span the step's modeled duration instead of zero.
- ``chunk`` / ``prefill`` / ``decode`` — work spans. Packed prefill
  chunks land on per-segment pack lanes (``pack 0``, ``pack 1``, …) so
  pack membership is visible as parallel tracks.
- ``plan_resolve`` / ``plan_swap`` / ``shadow`` / ``roll`` / ``route`` —
  the plan-decision audit trail: which tile each kernel launch resolved
  to and from which source (exact / nearest_shape / cross_hardware /
  fallback…), live artifact swaps, shadow measurements, and
  ``roll_plans`` keep/revert decisions as instant events.
- ``queue_push`` / ``queue_pop`` / ``queue_depth`` — scheduler events
  and the backlog counter (sampled on admit/reject as well as inside
  steps, so idle-time backlog is visible).
- ``page_alloc`` / ``page_free`` / ``prefix_hit`` / ``cow_split`` /
  ``pool_occupancy`` — paged-KV-pool lifecycle instants on the pool
  lane (see ``repro_torch.serve.pool``): page allocations and frees
  with the pool's running occupancy, shared-prefix reuse hits, and
  copy-on-write splits.
- ``fault`` / ``fault_detected`` / ``recover`` / ``recover_fail`` /
  ``drain_begin`` / ``drain_done`` / ``join`` / ``steal`` — the fleet
  fault-tolerance lane (the reference's ``repro/serve/faults.py``
  and ``FleetRouter``; the port's fleet will call them):
  scripted fault injections, watchdog/liveness detections with the
  instance's new status, per-request recovery decisions (source, target,
  retries, tokens discarded), graceful drain begin/done, elastic joins,
  and work-stealing moves.
- ``autoscale`` — one instant per autoscaler decision
  (the reference's ``serve/autoscale.py``) on the fleet lane: the
  join/drain action, the chosen instance/hardware, the triggering
  reason, and the full
  signal snapshot (queue depth, windowed p95 TTFT, pool occupancy,
  orphan count) the policy evaluated.

Zero-cost when disabled: components hold ``self._trace = None`` unless a
tracer was injected and guard every site with ``if self._trace is not
None`` — no tracer object, no event construction, no calls on the hot
path. All recording funnels through the single
:meth:`Tracer.record` chokepoint, which the guard test instruments.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

TRACE_SCHEMA_VERSION = 1

# Fixed lanes (Chrome-trace ``tid``s) within each process. Pack lanes —
# one per prefill segment slot — start at PACK_LANE_BASE.
LANE_LIFECYCLE = 0
LANE_STEPS = 1
LANE_DECODE = 2
LANE_PLAN = 3
LANE_SHADOW = 4
LANE_SCHED = 5
LANE_QUEUE = 6
LANE_POOL = 7
LANE_FLEET = 8
PACK_LANE_BASE = 9

LANE_NAMES = {
    LANE_LIFECYCLE: "lifecycle",
    LANE_STEPS: "steps",
    LANE_DECODE: "decode",
    LANE_PLAN: "plan audit",
    LANE_SHADOW: "shadow",
    LANE_SCHED: "scheduler",
    LANE_QUEUE: "queue depth",
    LANE_POOL: "kv pool",
    LANE_FLEET: "fleet",
}


def lane_name(tid: int) -> str:
    if tid >= PACK_LANE_BASE:
        return f"pack {tid - PACK_LANE_BASE}"
    return LANE_NAMES.get(tid, f"lane {tid}")


class Tracer:
    """Collects raw events (timestamps in clock seconds) across processes.

    ``clock`` is any zero-arg callable returning seconds; inject the same
    virtual clock the engines run on for deterministic traces.
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self.clock = clock
        self.events: List[Dict[str, Any]] = []
        self.procs: List[Dict[str, Any]] = []
        # Deferred spans keyed by (pid, tid): emitted when the next span
        # on the same lane begins, or at flush().
        self._open: Dict[Tuple[int, int], Dict[str, Any]] = {}

    # -- processes ---------------------------------------------------------
    def attach(self, name: str, kind: str = "engine",
               hardware: Optional[str] = None) -> "ProcTrace":
        """Register a process (engine/router/…) and return its handle."""
        pid = len(self.procs) + 1
        self.procs.append(
            {"pid": pid, "name": name, "kind": kind, "hardware": hardware})
        return ProcTrace(self, pid)

    # -- recording chokepoint ---------------------------------------------
    def record(self, ph: str, name: str, cat: str, pid: int, tid: int,
               ts: float, dur: Optional[float] = None,
               args: Optional[Dict[str, Any]] = None) -> None:
        """Append one raw event. Every event passes through here — the
        zero-cost guard test instruments this single method."""
        ev: Dict[str, Any] = {
            "ph": ph, "name": name, "cat": cat,
            "pid": pid, "tid": tid, "ts": ts,
        }
        if dur is not None:
            ev["dur"] = dur
        if args is not None:
            ev["args"] = args
        self.events.append(ev)

    def defer(self, pid: int, tid: int, name: str, cat: str, ts: float,
              args: Optional[Dict[str, Any]] = None) -> None:
        """Open a span that closes when the lane's next defer/flush lands.

        Needed for step spans under virtual clocks: the clock advances
        between engine steps, so a span closed inside its own step would
        have zero duration; closing it at the next step's begin gives it
        the step's modeled cost.
        """
        key = (pid, tid)
        prev = self._open.pop(key, None)
        if prev is not None:
            self.record(
                "X", prev["name"], prev["cat"], pid, tid, prev["ts"],
                dur=max(ts - prev["ts"], 0.0), args=prev.get("args"))
        self._open[key] = {"name": name, "cat": cat, "ts": ts, "args": args}

    def flush(self) -> None:
        """Close all deferred spans at the current clock. Idempotent."""
        if not self._open:
            return
        now = self.clock()
        for (pid, tid), prev in sorted(self._open.items()):
            self.record(
                "X", prev["name"], prev["cat"], pid, tid, prev["ts"],
                dur=max(now - prev["ts"], 0.0), args=prev.get("args"))
        self._open.clear()


class ProcTrace:
    """Per-process handle: the event vocabulary components speak.

    Thin wrappers over :meth:`Tracer.record` that fix the event names,
    categories, and lanes so the engine/scheduler/fleet call sites stay
    one-liners and ``trace_report`` can rely on the schema.
    """

    __slots__ = ("tracer", "pid")

    def __init__(self, tracer: Tracer, pid: int):
        self.tracer = tracer
        self.pid = pid

    def now(self) -> float:
        return self.tracer.clock()

    # -- generic -----------------------------------------------------------
    def instant(self, tid: int, name: str, cat: str,
                args: Optional[Dict[str, Any]] = None) -> None:
        self.tracer.record(
            "i", name, cat, self.pid, tid, self.tracer.clock(), args=args)

    def span(self, tid: int, name: str, cat: str, ts: float, dur: float,
             args: Optional[Dict[str, Any]] = None) -> None:
        self.tracer.record("X", name, cat, self.pid, tid, ts, dur=dur,
                           args=args)

    def counter(self, name: str, value: float) -> None:
        self.tracer.record(
            "C", name, "counter", self.pid, LANE_QUEUE, self.tracer.clock(),
            args={"value": float(value)})

    # -- request lifecycle -------------------------------------------------
    def submit(self, rid: int, prompt_len: int, bucket: int) -> None:
        rid, bucket = int(rid), int(bucket)
        ts = self.tracer.clock()
        self.tracer.record(
            "i", "submit", "lifecycle", self.pid, LANE_LIFECYCLE, ts,
            args={"rid": rid, "prompt_len": prompt_len, "bucket": bucket})
        # Async request span: Perfetto groups b/e pairs by (cat, id, name)
        # into one sub-track per request.
        self.tracer.record(
            "b", "req", "request", self.pid, LANE_LIFECYCLE, ts,
            args={"rid": rid, "id": rid})

    def reject(self, reason: str, prompt_len: int) -> None:
        self.instant(LANE_LIFECYCLE, "reject", "lifecycle",
                     args={"reason": reason, "prompt_len": prompt_len})

    def admit(self, rid: int, prompt_len: int, wait_s: float) -> None:
        self.instant(LANE_LIFECYCLE, "admit", "lifecycle",
                     args={"rid": int(rid), "prompt_len": int(prompt_len),
                           "wait_s": float(wait_s)})

    def first_token(self, rid: int, bucket: int,
                    submit_t: Optional[float],
                    now: Optional[float] = None) -> None:
        """``now`` (default: the clock) is the first token's time; the
        engine passes the time its metrics recorded the TTFT at."""
        rid, bucket = int(rid), int(bucket)
        now = self.tracer.clock() if now is None else now
        self.tracer.record("i", "first_token", "lifecycle", self.pid,
                           LANE_LIFECYCLE, now,
                           args={"rid": rid, "bucket": bucket})
        if submit_t is not None:
            # ts = submit, dur = TTFT: nearest-rank percentile over these
            # span durations reproduces ServeMetrics.ttft exactly.
            self.tracer.record(
                "X", "ttft", "lifecycle", self.pid, LANE_LIFECYCLE, submit_t,
                dur=max(now - submit_t, 0.0),
                args={"rid": rid, "bucket": bucket})

    def finish(self, rid: int, n_tokens: int) -> None:
        rid, n_tokens = int(rid), int(n_tokens)
        ts = self.tracer.clock()
        self.tracer.record(
            "i", "finish", "lifecycle", self.pid, LANE_LIFECYCLE, ts,
            args={"rid": rid, "tokens": n_tokens})
        self.tracer.record(
            "e", "req", "request", self.pid, LANE_LIFECYCLE, ts,
            args={"rid": rid, "id": rid})

    # -- engine work -------------------------------------------------------
    def step_mark(self, ts: float, stats: Dict[str, Any],
                  steps_run: int) -> None:
        """Begin step span at ``ts``; the previous step span closes here."""
        args = {"step": steps_run}
        args.update(stats)
        self.tracer.defer(self.pid, LANE_STEPS, "step", "engine", ts,
                          args=args)

    def chunk(self, rid: int, lane: int, ts: float, done: int, take: int,
              pack_n: int, queue_age_s: float) -> None:
        self.span(PACK_LANE_BASE + lane, "chunk", "prefill", ts,
                  max(self.tracer.clock() - ts, 0.0),
                  args={"rid": int(rid), "done": int(done),
                        "take": int(take), "pack_n": int(pack_n),
                        "queue_age_s": float(queue_age_s)})

    def prefill(self, rid: int, ts: float, length: int) -> None:
        self.span(PACK_LANE_BASE, "prefill", "prefill", ts,
                  max(self.tracer.clock() - ts, 0.0),
                  args={"rid": int(rid), "length": int(length)})

    def decode(self, ts: float, rids: List[int]) -> None:
        self.span(LANE_DECODE, "decode", "decode", ts,
                  max(self.tracer.clock() - ts, 0.0),
                  args={"batch": len(rids),
                        "rids": [int(r) for r in rids]})

    def queue_depth(self, depth: int) -> None:
        self.counter("queue_depth", depth)

    # -- paged KV pool -----------------------------------------------------
    def page_alloc(self, rid: int, n_pages: int, used: int,
                   total: int) -> None:
        self.instant(LANE_POOL, "page_alloc", "pool",
                     args={"rid": int(rid), "pages": int(n_pages),
                           "used": int(used), "total": int(total)})

    def page_free(self, rid: int, n_pages: int, used: int,
                  total: int) -> None:
        self.instant(LANE_POOL, "page_free", "pool",
                     args={"rid": int(rid), "pages": int(n_pages),
                           "used": int(used), "total": int(total)})

    def prefix_hit(self, rid: int, hit_tokens: int, n_pages: int) -> None:
        self.instant(LANE_POOL, "prefix_hit", "pool",
                     args={"rid": int(rid), "hit_tokens": int(hit_tokens),
                           "pages": int(n_pages)})

    def cow_split(self, rid: int, src: int, dst: int) -> None:
        self.instant(LANE_POOL, "cow_split", "pool",
                     args={"rid": int(rid), "src": int(src),
                           "dst": int(dst)})

    def pool_occupancy(self, used: int, total: int) -> None:
        self.instant(LANE_POOL, "pool_occupancy", "pool",
                     args={"used": int(used), "total": int(total)})

    # -- scheduler ---------------------------------------------------------
    def queue_push(self, rid: int, bucket: int) -> None:
        self.instant(LANE_SCHED, "queue_push", "scheduler",
                     args={"rid": int(rid), "bucket": int(bucket)})

    def queue_pop(self, rid: int, bucket: int) -> None:
        self.instant(LANE_SCHED, "queue_pop", "scheduler",
                     args={"rid": int(rid), "bucket": int(bucket)})

    # -- plan audit --------------------------------------------------------
    def plan_resolve(self, phase: str, kernel: str, problem: str, tile: Any,
                     source: str, schema: Optional[int]) -> None:
        self.instant(LANE_PLAN, "plan_resolve", "plan",
                     args={"phase": phase, "kernel": kernel,
                           "problem": problem, "tile": list(tile),
                           "source": source, "schema": schema})

    def plan_swap(self, schema: Optional[int],
                  refined_from: Optional[str]) -> None:
        self.instant(LANE_PLAN, "plan_swap", "plan",
                     args={"schema": schema, "refined_from": refined_from})

    def shadow(self, kernel: str, problem: str, incumbent: Any,
               candidate: Any, dt_inc: float, dt_cand: float) -> None:
        self.instant(LANE_SHADOW, "shadow", "plan",
                     args={"kernel": kernel, "problem": problem,
                           "incumbent": [int(x) for x in incumbent],
                           "candidate": [int(x) for x in candidate],
                           "dt_incumbent_s": float(dt_inc),
                           "dt_candidate_s": float(dt_cand)})

    # -- fleet -------------------------------------------------------------
    def route(self, rid: int, instance: str, bucket: int,
              score: float) -> None:
        self.instant(LANE_SCHED, "route", "fleet",
                     args={"rid": int(rid), "instance": instance,
                           "bucket": int(bucket), "score": float(score)})

    def route_reject(self, reason: str) -> None:
        self.instant(LANE_SCHED, "route_reject", "fleet",
                     args={"reason": reason})

    def roll(self, instance: str, pre_p95: Optional[float],
             post_p95: Optional[float], rolled_back: bool,
             clipped: bool) -> None:
        self.instant(LANE_PLAN, "roll", "fleet",
                     args={"instance": instance, "pre_p95": pre_p95,
                           "post_p95": post_p95, "rolled_back": rolled_back,
                           "clipped": clipped})

    # -- fleet fault tolerance ---------------------------------------------
    def fault(self, action: str, instance: str, step: int,
              factor: float = 1.0) -> None:
        self.instant(LANE_FLEET, "fault", "fleet",
                     args={"action": action, "instance": instance,
                           "step": int(step), "factor": float(factor)})

    def fault_detected(self, instance: str, status: str, via: str) -> None:
        """An instance was marked unhealthy: ``via`` is "liveness" (a dead
        engine failed its step) or "watchdog" (no progress past the
        threshold)."""
        self.instant(LANE_FLEET, "fault_detected", "fleet",
                     args={"instance": instance, "status": status,
                           "via": via})

    def recover(self, fid: int, src: str, dst: str, rid: int, retries: int,
                tokens_discarded: int) -> None:
        self.instant(LANE_FLEET, "recover", "fleet",
                     args={"fid": int(fid), "src": src, "dst": dst,
                           "rid": int(rid), "retries": int(retries),
                           "tokens_discarded": int(tokens_discarded)})

    def recover_fail(self, fid: int, reason: str, retries: int) -> None:
        self.instant(LANE_FLEET, "recover_fail", "fleet",
                     args={"fid": int(fid), "reason": reason,
                           "retries": int(retries)})

    def drain_begin(self, instance: str, handoff: int) -> None:
        self.instant(LANE_FLEET, "drain_begin", "fleet",
                     args={"instance": instance, "handoff": int(handoff)})

    def drain_done(self, instance: str) -> None:
        self.instant(LANE_FLEET, "drain_done", "fleet",
                     args={"instance": instance})

    def join(self, instance: str, hardware: Optional[str]) -> None:
        self.instant(LANE_FLEET, "join", "fleet",
                     args={"instance": instance, "hardware": hardware})

    def steal(self, fid: int, src: str, dst: str) -> None:
        self.instant(LANE_FLEET, "steal", "fleet",
                     args={"fid": int(fid), "src": src, "dst": dst})

    def autoscale(self, action: str, instance: str,
                  hardware: Optional[str], reason: str,
                  signals: Dict[str, float]) -> None:
        """One autoscaler decision (the reference's autoscaler): the
        join/drain action plus the full telemetry snapshot that triggered
        it, so a trace alone explains WHY the fleet changed size."""
        self.instant(LANE_FLEET, "autoscale", "fleet",
                     args={"action": action, "instance": instance,
                           "hardware": hardware, "reason": reason,
                           "signals": {k: signals[k]
                                       for k in sorted(signals)}})

    def refine_cell(self, kernel: str, problem: str, old_tile: Any,
                    new_tile: Any, speedup: float, samples: int) -> None:
        self.instant(LANE_PLAN, "refine_cell", "plan",
                     args={"kernel": kernel, "problem": problem,
                           "old_tile": [int(x) for x in old_tile],
                           "new_tile": [int(x) for x in new_tile],
                           "speedup": float(speedup),
                           "samples": int(samples)})
