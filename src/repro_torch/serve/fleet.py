"""Hardware-aware fleet router of the port: one engine per accelerator model.

The reference's router (``repro/serve/fleet.py``) over the port's
:class:`~repro_torch.serve.engine.ServeEngine`. The paper's cross-model
result — the optimal tile on one GPU model is not the optimal tile on
another — has a fleet-level corollary: once tiles are per-model, *cost* is
per-model, so the cheapest placement for a request depends on which
hardware the fleet offers and on the request's shape bucket. The router
makes that concrete:

* it holds one engine per :class:`~repro_torch.core.hardware.HardwareModel`;
* it prices every ``(bucket, hardware)`` pair with the engine's plan and
  the analytic cost model — prefill at the bucket edge plus
  ``max_new_tokens`` decode steps, each from the *per-hardware* resolved
  tiles;
* it routes each request to the instance minimizing
  ``service_estimate * (1 + backlog/slots)`` — the cost-model-optimal
  placement, discounted for instances that are already loaded.

Fault tolerance (``serve/faults.py``), drain, join, work stealing, the
autoscaler's adapter surface (``serve/autoscale.py``) and the versioned
plan rollout (:meth:`FleetRouter.roll_plans`) are the reference's. On the
card every instance's decode steps replay captured CUDA graphs, and the
engine's eviction hooks keep them valid: an evicted slot keeps its
tensors, and a recovered request is re-prefilled from its prompt on the
survivor (through its kernels) into a slot whose graph replays as it was
captured. ``step_all`` treats only :class:`EngineFault` as a dead
instance: a kernel that fails to launch raises through it. A ``join``
under a dead or drained name replaces the engine object, and the router
keeps no reference to the old one, so its caches and graph pool are freed
once it is collected.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, List, Mapping, Optional, Tuple

from repro_torch import kernels
from repro_torch.core import registry
from repro_torch.core.plans import PlanTransferWarning, score_tile
from repro_torch.kernels.flash_attention.ops import (PACK_ROUND_SEGS,
                                                     serve_launch_tile)
from repro_torch.launch.specs import kernel_problems, resolve_model_tiles
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.faults import EngineFault, FaultInjector
from repro_torch.serve.metrics import nearest_rank
from repro_torch.serve.scheduler import BucketPolicy


class FleetExhausted(RuntimeError):
    """``run_until_done`` hit ``max_steps`` with work still pending.

    Previously the router returned silently in this situation, so callers
    could read a partial result set as a complete run. Now the exhaustion
    is explicit, carrying the per-instance residue so the operator can see
    WHERE the fleet wedged (``pending`` maps instance -> in-flight/queued
    counts; ``orphans`` counts evicted requests awaiting a healthy home).
    """

    def __init__(self, max_steps: int, pending: Dict[str, Dict[str, int]],
                 orphans: int = 0):
        self.max_steps = max_steps
        self.pending = pending
        self.orphans = orphans
        detail = "; ".join(
            f"{name}: {c['in_flight']} in-flight + {c['queued']} queued"
            for name, c in sorted(pending.items()))
        if orphans:
            detail = (detail + "; " if detail else "") + f"{orphans} orphaned"
        super().__init__(
            f"fleet not drained after {max_steps} steps ({detail})")


@dataclasses.dataclass
class _FleetRequest:
    """Fleet-level identity for one request, stable across retries.

    Engines hand out per-engine rids; the fleet keys every request by a
    fleet id (fid) so a request that dies with its instance and re-queues
    on a survivor is still THE SAME request — same original prompt, same
    submit-time TTFT anchor, one results() entry."""

    fid: int
    prompt: Any                       # raw (unpadded) prompt tokens
    max_new_tokens: int
    priority: int
    deadline: float
    submit_t: Optional[float]         # original submit time (TTFT anchor)
    instance: str                     # current (or last) placement
    rid: int                          # rid on that instance
    retries: int = 0                  # recovery attempts consumed
    tokens_discarded: int = 0         # generated-then-lost token count
    lost: bool = False                # retry budget exhausted


@dataclasses.dataclass(frozen=True)
class RouteDecision:
    """Where one request went and why."""

    rid: int
    instance: str
    bucket: int
    score: float                      # chosen instance's loaded score
    scores: Tuple[Tuple[str, float], ...]  # all (instance, loaded score)
    fid: Optional[int] = None         # fleet-level id (stable across retries)


@dataclasses.dataclass(frozen=True)
class RollDecision:
    """One instance's plan-rollout outcome (``FleetRouter.roll_plans``)."""

    instance: str
    pre_p95: float                    # probe p95 TTFT before the swap (s)
    post_p95: float                   # probe p95 TTFT after the swap (s)
    rolled_back: bool
    # True when either probe window outgrew the metrics' circular sample
    # buffer: the window silently misses samples, so the guard treated it
    # as thin (no confident keep/revert) rather than reading it.
    clipped: bool = False


class FleetRouter:
    """Route requests across per-hardware engines by plan-resolved cost."""

    def __init__(self, engines: Mapping[str, ServeEngine],
                 policy: BucketPolicy, tracer=None,
                 watchdog_threshold: int = 8, retry_budget: int = 2,
                 injector: Optional[FaultInjector] = None,
                 autoscaler=None):
        if not engines:
            raise ValueError("FleetRouter needs at least one engine")
        self.engines: Dict[str, ServeEngine] = dict(engines)
        self.policy = policy
        # Fleet-level trace process (obs/trace.py): routing and plan-
        # rollout decisions as instants. None = tracing off, zero cost.
        self._trace = (tracer.attach("router", kind="router")
                       if tracer is not None else None)
        self.decisions: List[RouteDecision] = []
        # Router-level rejections (no engine was ever asked): reason -> n.
        self.rejects: Dict[str, int] = {}
        # Plan-rollout audit trail (roll_plans appends one entry per
        # instance swapped or reverted).
        self.roll_history: List[RollDecision] = []
        # (instance, kind, length) -> estimated seconds; pure function of
        # the plan + cost model, so cache freely.
        self._cell_cost: Dict[Tuple[str, str, int], float] = {}
        # -- fault tolerance ------------------------------------------------
        # Scripted fault source (kill/stall/degrade/drain/join at step N);
        # None = no injection, everything below still guards real faults.
        self.injector = injector
        # Consecutive no-progress steps (with work pending) before the
        # watchdog declares an instance stalled and evicts its work.
        self.watchdog_threshold = watchdog_threshold
        # Recovery attempts per request before it is declared lost.
        self.retry_budget = retry_budget
        # instance -> "live" | "stalled" | "dead" | "draining" | "drained".
        # Only "live" instances take new work; "draining" finish in place.
        self.status: Dict[str, str] = {name: "live" for name in self.engines}
        # instance -> (last progress reading, consecutive stuck steps).
        # Progress = tokens_out + chunks_run: multi-chunk prefills emit no
        # tokens for many steps, so chunk completions must count.
        self._progress: Dict[str, Tuple[int, int]] = {}
        # fid -> fleet record; (instance, rid) -> fid. The rid mapping is
        # popped when a request leaves an instance (eviction/steal) and
        # re-added at its new home, so finished rids resolve forever.
        self._fleet: Dict[int, _FleetRequest] = {}
        self._rid_map: Dict[Tuple[str, int], int] = {}
        self._next_fid = 0
        # Evicted requests awaiting a healthy instance (retried each step).
        self._orphans: List[_FleetRequest] = []
        self._steps = 0
        self.recoveries = 0
        self.steals = 0
        self.lost = 0
        # Finished results preserved across join-time engine replacement:
        # fid -> tokens. A joiner reusing a dead instance's name replaces
        # the engine object, and with it the old engine's _finished list —
        # requests that completed BEFORE the failure must stay resolvable
        # through results() or the zero-loss invariant silently breaks.
        self._retired_results: Dict[int, List[int]] = {}
        # instance -> status it held when it failed ("live"/"draining").
        # A scripted recover restores THIS status, so an instance that
        # stalled mid-drain resumes draining instead of re-entering
        # rotation (which would cancel the drain the operator requested).
        self._pre_fail: Dict[str, str] = {}
        # -- autoscaling ----------------------------------------------------
        # AutoscalePolicy (serve/autoscale.py) or None. Consulted at the
        # end of every step_all, after recovery/steal/drain bookkeeping.
        self.autoscaler = autoscaler
        # Powered instance-steps (live + draining), the capacity-cost
        # denominator to compare against a static fleet.
        self.instance_steps = 0
        # Cumulative routed-traffic mix: bucket -> count, plus the
        # max_new_tokens running sum — the policy windows these to price
        # candidates against the CURRENT mix, not a static ranking.
        self._mix_counts: Dict[int, int] = {}
        self._mix_new_tokens = 0
        self._mix_n = 0
        # Pricing engines for scale candidates (one per candidate, built
        # lazily, never joined or stepped — they only feed the cost model).
        self._cand_engines: Dict[str, ServeEngine] = {}

    # -- cost model ----------------------------------------------------------
    def _phase_cost(self, name: str, kind: str, length: int) -> float:
        return self._phase_cost_for(self.engines[name], kind, length, name)

    def _phase_cost_for(self, eng: ServeEngine, kind: str, length: int,
                        cache_name: str) -> float:
        """Estimated seconds of one prefill (kind="prefill" for monolithic,
        "chunked_prefill" for the chunk-decomposed cell, "packed_prefill"
        for the step-packed cell, all batch 1) or one decode step
        (kind="decode", the engine's slot batch) on ``eng``.

        ``eng`` need not be a fleet member: the autoscaler prices *scale
        candidates* through the same path, each against its own plan
        artifact and hardware (``cache_name`` keys the cost cache — member
        names for fleet engines, ``"cand:<name>"`` for candidates).

        The packed cell is scored against a fixed round of
        ``PACK_ROUND_SEGS`` segments (that is what makes pack widths
        comparable in the sweep), so its score is divided back to ONE
        request here — keeping every kind's cost in per-request seconds.
        """
        key = (cache_name, kind, length)
        hit = self._cell_cost.get(key)
        if hit is not None:
            return hit
        kernels.register_all()
        batch = eng.slots if kind == "decode" else 1
        dtype = eng._dtype_name
        total = 0.0
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", PlanTransferWarning)
            for kernel, problem in kernel_problems(
                    eng.cfg, batch, length, kind).items():
                res = (eng.plans.resolve(kernel, problem, dtype, eng.hardware)
                       if eng.plans is not None else None)
                if res is not None:
                    score = res.score_s
                else:
                    tile = registry.get(kernel).default_tile(problem, dtype)
                    if kernel in ("chunked_prefill", "packed_prefill"):
                        # Priced at the bkv its calls launch: the default's
                        # may be one the regime does not compile, which the
                        # cost model calls infeasible (every instance inf).
                        tile = serve_launch_tile(tile, problem, dtype)
                    score = score_tile(kernel, tile, problem, dtype,
                                       eng.hardware)
                if kernel == "packed_prefill":
                    score /= PACK_ROUND_SEGS
                total += score
        self._cell_cost[key] = total
        return total

    def service_score(self, name: str, bucket: int,
                      max_new_tokens: int) -> float:
        """Estimated service seconds for one request of this bucket.

        Chunk-prefill engines price the prefill through the plan's
        ``chunked_prefill`` cell — the chunk-decomposed cost, including the
        per-chunk dispatch overhead the chunk length was tuned against —
        and step-packing engines through the ``packed_prefill`` cell,
        whose per-step dispatch cost is amortized over the plan's pack
        width — so the estimate reflects how each engine will actually run
        the request.
        """
        return self.service_score_for(self.engines[name], bucket,
                                      max_new_tokens, cache_name=name)

    def service_score_for(self, eng: ServeEngine, bucket: int,
                          max_new_tokens: int,
                          cache_name: Optional[str] = None) -> float:
        """:meth:`service_score` for an arbitrary engine — fleet member or
        not. The autoscaler prices scale *candidates* here, so a joiner's
        cost comes from its own plan artifact before it ever joins."""
        if cache_name is None:
            cache_name = f"id:{id(eng)}"
        prefill_kind = ("packed_prefill" if eng.pack_prefill
                        else "chunked_prefill" if eng.chunk_prefill
                        else "prefill")
        return (self._phase_cost_for(eng, prefill_kind, bucket, cache_name)
                + max_new_tokens
                * self._phase_cost_for(eng, "decode", eng.max_len,
                                       cache_name))

    def _load(self, name: str) -> float:
        """Backlog pressure in slot-equivalents.

        Unchunked engines count every queued request as one monolithic unit
        of head-of-line work. Chunk-prefill engines hold an admitted prompt
        for only one chunk at a time (urgent work overtakes between
        chunks), so a queued request contributes its *chunk fraction* —
        chunk_len / admitted length — and routing stops over-penalizing
        instances that merely hold long prompts.
        """
        eng = self.engines[name]
        busy = sum(r is not None for r in eng._active)
        if not eng.chunk_prefill:
            return (busy + eng.scheduler.pending()) / max(eng.slots, 1)
        frac = float(len(eng._ready))
        for job in eng._chunking:
            frac += job.chunk_len / max(len(job.prompt), 1)
        for req in eng._held:
            bucket = req.bucket or len(req.prompt)
            frac += eng.chunk_len_for(bucket) / max(bucket, 1)
        queued = getattr(eng.scheduler, "queued_buckets", None)
        if queued is None:
            frac += eng.scheduler.pending()
        else:
            for bucket in queued():
                frac += eng.chunk_len_for(bucket) / max(bucket, 1)
        return (busy + frac) / max(eng.slots, 1)

    # -- observability -------------------------------------------------------
    def _routable(self) -> List[str]:
        """Instances that can take new work right now (status "live").
        Dead/drained/stalled members keep their engines around for result
        resolution but must never be *recommended* — a placement table
        pointing at a dead instance is an operator trap."""
        return [n for n in sorted(self.engines) if self.status[n] == "live"]

    def placement_table(self, max_new_tokens: int = 16) -> Dict[int, str]:
        """Pure-cost best ROUTABLE instance per bucket edge (no load term)
        — the paper's per-model-optimum claim at placement granularity.
        Empty when no instance is live."""
        live = self._routable()
        if not live:
            return {}
        table = {}
        for edge in self.policy.edges:
            table[edge] = min(
                live,
                key=lambda n: (self.service_score(n, edge, max_new_tokens), n))
        return table

    def tile_table(self, bucket: int) -> Dict[str, Dict[str, str]]:
        """routable instance -> kernel -> resolved prefill tile at this
        bucket edge (exposes that the same shape wants different tiles per
        model)."""
        out: Dict[str, Dict[str, str]] = {}
        for name in self._routable():
            eng = self.engines[name]
            if eng.plans is None:
                continue
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", PlanTransferWarning)
                tiles, _ = resolve_model_tiles(
                    eng.plans, eng.cfg, 1, bucket, "prefill",
                    eng._dtype_name, eng.hardware)
            out[name] = {k: str(t) for k, t in tiles.items()}
        return out

    # -- routing -------------------------------------------------------------
    def route(self, prompt, max_new_tokens: int = 16, priority: int = 0,
              deadline: float = float("inf")) -> Optional[RouteDecision]:
        """Admit one request on the cheapest healthy instance; None when
        rejected everywhere. An engine-level rejection (queue full,
        over-length for that engine's policy) fails over to the next-best
        instance by loaded score instead of dropping the request; only when
        EVERY healthy instance rejects is the terminal reason counted in
        ``self.rejects`` — never dropped silently."""
        bucket, reason = self.policy.admit(len(prompt))
        if bucket is None:
            self.rejects[reason] = self.rejects.get(reason, 0) + 1
            if self._trace is not None:
                self._trace.route_reject(reason)
            return None
        live = [n for n in self.engines if self.status[n] == "live"]
        if not live:
            reason = "no_healthy_instance"
            self.rejects[reason] = self.rejects.get(reason, 0) + 1
            if self._trace is not None:
                self._trace.route_reject(reason)
            return None
        scores = tuple(sorted(
            (name,
             self.service_score(name, bucket, max_new_tokens)
             * (1.0 + self._load(name)))
            for name in live))
        reason = "engine_reject"
        for name, score in sorted(scores, key=lambda kv: (kv[1], kv[0])):
            eng = self.engines[name]
            rid = eng.add_request(
                prompt, max_new_tokens=max_new_tokens, priority=priority,
                deadline=deadline)
            if rid is None:
                reason = getattr(eng, "last_reject_reason", reason)
                continue
            fid = self._register_admit(name, rid, prompt, max_new_tokens,
                                       priority, deadline)
            # Traffic-mix accounting (admits only, never retries/steals —
            # a recovered request is the same traffic, not new demand).
            self._mix_counts[bucket] = self._mix_counts.get(bucket, 0) + 1
            self._mix_new_tokens += max_new_tokens
            self._mix_n += 1
            decision = RouteDecision(
                rid=rid, instance=name, bucket=bucket,
                score=score, scores=scores, fid=fid)
            self.decisions.append(decision)
            if self._trace is not None:
                self._trace.route(rid, name, bucket, decision.score)
            return decision
        self.rejects[reason] = self.rejects.get(reason, 0) + 1
        if self._trace is not None:
            self._trace.route_reject(reason)
        return None

    def _register_admit(self, name: str, rid: int, prompt,
                        max_new_tokens: int, priority: int,
                        deadline: float) -> int:
        """Mint a fleet id for a freshly admitted request, anchoring its
        original submit time (the TTFT anchor recovery preserves)."""
        fid = self._next_fid
        self._next_fid += 1
        self._fleet[fid] = _FleetRequest(
            fid=fid, prompt=prompt, max_new_tokens=max_new_tokens,
            priority=priority, deadline=deadline,
            submit_t=self.engines[name].metrics.submit_time(rid),
            instance=name, rid=rid)
        self._rid_map[(name, rid)] = fid
        return fid

    def placements(self) -> Dict[int, Dict[str, int]]:
        """bucket -> instance -> routed request count (from the live run)."""
        out: Dict[int, Dict[str, int]] = {}
        for d in self.decisions:
            out.setdefault(d.bucket, {}).setdefault(d.instance, 0)
            out[d.bucket][d.instance] += 1
        return out

    # -- execution -----------------------------------------------------------
    def step_all(self) -> int:
        """One engine step on every healthy instance; returns total pending
        work (active slots + partial prefills + orphans awaiting a home).

        This is also the fault-tolerance heartbeat: scripted faults fire
        here (deterministically, keyed by step count — replayable), killed
        instances are detected by liveness (stepping one raises/flags), and
        stalled instances by the progress watchdog. Either way the failed
        instance's queued AND in-flight requests are evicted, re-queued on
        survivors under the retry budget, and re-prefilled from their
        original prompts with submit-anchored TTFT. Work stealing then
        rebalances queued requests from busy to idle live instances."""
        self._steps += 1
        if self.injector is not None:
            for ev in self.injector.advance(self._steps):
                if self._trace is not None:
                    self._trace.fault(ev.action, ev.instance, ev.step,
                                      ev.factor)
                if ev.action == "drain":
                    self.drain(ev.instance)
                elif ev.action == "join":
                    self.join(ev.instance, ev.make_engine())
                elif (ev.action == "recover"
                      and self.status.get(ev.instance) == "stalled"):
                    # The wedge cleared; the instance was already evicted,
                    # so it rejoins empty. Recovery restores the status it
                    # held BEFORE the stall: an instance that stalled while
                    # draining resumes draining (and, being empty, retires
                    # on this step's _finish_drains) instead of silently
                    # re-entering rotation and cancelling the drain.
                    self.status[ev.instance] = self._pre_fail.pop(
                        ev.instance, "live")
                    self._progress.pop(ev.instance, None)
        total = 0
        for name in sorted(self.engines):
            st = self.status[name]
            if st in ("dead", "drained", "stalled"):
                continue
            # Powered instance-step: this member occupies hardware this
            # step whether it is serving or finishing a drain.
            self.instance_steps += 1
            inj = self.injector
            if inj is not None and inj.is_killed(name):
                self._mark_failed(name, "dead", via="liveness")
                continue
            eng = self.engines[name]
            if inj is not None and inj.is_stalled(name):
                # Wedged, not dead: the step is a no-op — it holds its
                # state and makes no progress, so only the watchdog (not
                # liveness) can catch it.
                total += eng.in_flight()
                self._watch(name)
                continue
            try:
                total += eng.step()
            except EngineFault:
                self._mark_failed(name, "dead", via="liveness")
                continue
            self._watch(name)
        self._requeue_orphans()
        self._steal()
        self._finish_drains()
        if self.autoscaler is not None:
            self.autoscaler.observe(self, self._steps)
        return total + len(self._orphans)

    def _watch(self, name: str) -> None:
        """Progress watchdog: an instance with work pending that makes no
        progress (no new tokens, no chunk completions) for
        ``watchdog_threshold`` consecutive steps is declared stalled and
        its work evicted for recovery. Chunk completions count as progress
        because a multi-chunk prefill legitimately emits no tokens for
        many steps."""
        eng = self.engines[name]
        progress = eng.metrics.tokens_out + eng.metrics.chunks_run
        last, stuck = self._progress.get(name, (progress, 0))
        if eng.in_flight() or eng.scheduler.pending():
            stuck = stuck + 1 if progress == last else 0
        else:
            stuck = 0
        self._progress[name] = (progress, stuck)
        if (stuck >= self.watchdog_threshold
                and self.status[name] in ("live", "draining")):
            self._mark_failed(name, "stalled", via="watchdog")

    def _mark_failed(self, name: str, status: str, via: str) -> None:
        """Take an instance out of rotation and orphan its entire resident
        request set (queued + in-flight) for recovery on survivors. Pool
        pages are released refcount-balanced by the eviction; recovery
        re-prefills from original prompts, never from the dead caches."""
        self._pre_fail[name] = self.status[name]
        self.status[name] = status
        self._progress.pop(name, None)
        if self._trace is not None:
            self._trace.fault_detected(name, status, via)
        for req in self.engines[name].evict_all():
            self._absorb(name, req, failure=True)

    def _absorb(self, name: str, req: Request, *, failure: bool) -> None:
        """Fold one evicted engine request back into fleet bookkeeping.
        ``failure=True`` (kill/stall) consumes a retry and accounts the
        discarded generated tokens; ``failure=False`` (drain handoff,
        steal) moves the request for free."""
        fid = self._rid_map.pop((name, req.rid), None)
        if fid is None:
            # Directly-added request (bypassed route()): synthesize a fleet
            # record from the evicted Request — the prompt is the raw
            # unpadded one and the submit anchor was stashed at eviction.
            fr = _FleetRequest(
                fid=self._next_fid, prompt=req.prompt,
                max_new_tokens=req.max_new_tokens, priority=req.priority,
                deadline=req.deadline, submit_t=req.submit_t,
                instance=name, rid=req.rid)
            self._next_fid += 1
            self._fleet[fr.fid] = fr
        else:
            fr = self._fleet[fid]
        if failure:
            fr.retries += 1
            fr.tokens_discarded += len(req.out_tokens)
            if fr.retries > self.retry_budget:
                fr.lost = True
                self.lost += 1
                self.rejects["retry_budget"] = (
                    self.rejects.get("retry_budget", 0) + 1)
                if self._trace is not None:
                    self._trace.recover_fail(fr.fid, "retry_budget",
                                             fr.retries)
                return
        self._orphans.append(fr)

    def _requeue_orphans(self) -> None:
        """Re-place evicted requests on the cheapest live instance, keeping
        the original submit time as the TTFT anchor (recovered requests pay
        their true end-to-end latency, including the failed attempt).
        Requests no live instance will take stay orphaned and are retried
        every step."""
        if not self._orphans:
            return
        live = [n for n in self.engines if self.status[n] == "live"]
        if not live:
            return
        still: List[_FleetRequest] = []
        for fr in self._orphans:
            bucket, _ = self.policy.admit(len(fr.prompt))
            if bucket is None:
                bucket = len(fr.prompt)
            ranked = sorted(
                ((self.service_score(n, bucket, fr.max_new_tokens)
                  * (1.0 + self._load(n)), n) for n in live))
            src = fr.instance
            for _score, name in ranked:
                rid = self.engines[name].add_request(
                    fr.prompt, max_new_tokens=fr.max_new_tokens,
                    priority=fr.priority, deadline=fr.deadline,
                    submit_t=fr.submit_t)
                if rid is None:
                    continue
                fr.instance, fr.rid = name, rid
                self._rid_map[(name, rid)] = fr.fid
                self.recoveries += 1
                if self._trace is not None:
                    self._trace.recover(fr.fid, src, name, rid, fr.retries,
                                        fr.tokens_discarded)
                break
            else:
                still.append(fr)
        self._orphans = still

    # -- drain / join / steal ------------------------------------------------
    def drain(self, name: str) -> int:
        """Gracefully retire an instance: stop admission, hand its queued
        (not-yet-started) requests to the rest of the fleet for free — no
        retry consumed, drain is not a failure — and let in-flight work
        finish in place. The instance flips to "drained" once empty
        (``_finish_drains`` on the step loop). Returns the handoff count."""
        if self.status.get(name) not in ("live",):
            return 0
        self.status[name] = "draining"
        handoff = self.engines[name].extract_queued()
        if self._trace is not None:
            self._trace.drain_begin(name, len(handoff))
        for req in handoff:
            self._absorb(name, req, failure=False)
        self._requeue_orphans()
        return len(handoff)

    def _finish_drains(self) -> None:
        for name in sorted(self.engines):
            if self.status[name] != "draining":
                continue
            eng = self.engines[name]
            if not eng.in_flight() and not eng.scheduler.pending():
                self.status[name] = "drained"
                if self._trace is not None:
                    self._trace.drain_done(name)

    def join(self, name: str, engine: ServeEngine) -> None:
        """Add an instance mid-run. The engine carries its own
        HardwareModel and plan artifact, so its plan cells resolve for its
        own hardware — a heterogeneous joiner prices (and runs) every
        bucket with its own tiles, and routing starts sending it work on
        the next ``route``/steal. Reusing the name of a dead or drained
        instance replaces it — but never its history: results that
        finished on the old engine BEFORE it failed are retired into fleet
        bookkeeping first, so ``results()`` keeps resolving them."""
        if name in self.engines and self.status.get(name) not in (
                "dead", "drained"):
            raise ValueError(f"instance {name!r} is already active")
        old = self.engines.get(name)
        if old is not None:
            for req in old._finished:
                fid = self._rid_map.pop((name, req.rid), None)
                if fid is not None:
                    self._retired_results[fid] = list(req.out_tokens)
        self.engines[name] = engine
        self.status[name] = "live"
        self._progress.pop(name, None)
        self._pre_fail.pop(name, None)
        for key in [k for k in self._cell_cost if k[0] == name]:
            del self._cell_cost[key]
        if self._trace is not None:
            self._trace.join(name, engine.hardware.name)

    def _steal(self) -> None:
        """Rebalance between steps: an idle live instance (nothing queued,
        free slots) pulls the most urgent queued request from the most
        backlogged live instance. The move is free (no retry) and keeps the
        original submit anchor, so stolen requests' TTFT reflects their
        full wait. Deterministic: sorted iteration, max-backlog source."""
        live = [n for n in sorted(self.engines) if self.status[n] == "live"]
        if len(live) < 2:
            return
        for dst in live:
            deng = self.engines[dst]
            if deng.scheduler.pending() or deng.in_flight() >= deng.slots:
                continue
            srcs = [n for n in live
                    if n != dst and self.engines[n].scheduler.pending() > 0]
            if not srcs:
                continue
            src = max(srcs, key=lambda n: (
                self.engines[n].scheduler.pending(), n))
            seng = self.engines[src]
            req = seng.scheduler.next_request()
            if req is None:
                continue
            seng._evict_state(req)
            fid = self._rid_map.pop((src, req.rid), None)
            if fid is None:
                self._absorb(src, req, failure=False)
                fr = self._orphans.pop()
            else:
                fr = self._fleet[fid]
            rid = deng.add_request(
                fr.prompt, max_new_tokens=fr.max_new_tokens,
                priority=fr.priority, deadline=fr.deadline,
                submit_t=fr.submit_t)
            if rid is None:
                self._orphans.append(fr)   # re-placed next step
                continue
            fr.instance, fr.rid = dst, rid
            self._rid_map[(dst, rid)] = fr.fid
            self.steals += 1
            if self._trace is not None:
                self._trace.steal(fr.fid, src, dst)

    # -- autoscale adapter protocol ------------------------------------------
    # The surface serve/autoscale.py's AutoscalePolicy consumes. Kept
    # deliberately small and duck-typed, so that a queueing simulator can
    # implement the same protocol and exercise the real policy without
    # real engines.
    def live_instances(self) -> List[str]:
        return [n for n in sorted(self.engines) if self.status[n] == "live"]

    def known_instances(self) -> set:
        return set(self.engines)

    def instance_hardware(self, name: str) -> Optional[str]:
        eng = self.engines.get(name)
        return eng.hardware.name if eng is not None else None

    def queue_depths(self) -> Dict[str, int]:
        """Queued (admitted-but-not-started) requests per instance — the
        backlog the policy reads as load pressure."""
        return {name: eng.scheduler.pending()
                for name, eng in sorted(self.engines.items())}

    def ttft_marks(self) -> Dict[str, Dict[object, int]]:
        """Opaque cursor for :meth:`ttft_window_since` (per-instance
        ``ServeMetrics.ttft_counts`` marks)."""
        return {name: eng.metrics.ttft_counts()
                for name, eng in self.engines.items()}

    def ttft_window_since(self, marks) -> Tuple[List[float], bool]:
        """First-token latencies recorded fleet-wide since ``marks``
        (None = everything), plus a flag when any instance's circular
        sample buffer outgrew the window (the window silently misses
        samples — the policy treats its p95 as untrustworthy only insofar
        as it is surfaced in the decision's signal snapshot)."""
        samples: List[float] = []
        clipped = False
        for name, eng in sorted(self.engines.items()):
            mark = (marks or {}).get(name)
            s, c = eng.metrics.ttft_window(mark)
            samples.extend(s)
            clipped = clipped or c
        return samples, clipped

    def traffic_mix(self) -> Tuple[Dict[int, int], int, int]:
        """Cumulative routed mix: (bucket -> admits, sum of
        max_new_tokens, admit count). The policy windows successive
        snapshots to price capacity against CURRENT demand."""
        return dict(self._mix_counts), self._mix_new_tokens, self._mix_n

    def pool_occupancy(self) -> float:
        """Max used/total page fraction over live paged instances (0.0
        when nothing is paged) — KV-pressure trigger for scale-up."""
        occ = 0.0
        for name in self.live_instances():
            pool = self.engines[name].pool
            if pool is not None and pool.n_pages:
                occ = max(occ, pool.used_pages / pool.n_pages)
        return occ

    def orphan_count(self) -> int:
        return len(self._orphans)

    def price_instance(self, name: str, mix: Mapping[int, int],
                       avg_new_tokens: int) -> float:
        """Mix-weighted service seconds per request on a fleet member."""
        return self._mix_price(self.engines[name], mix, avg_new_tokens, name)

    def price_candidate(self, candidate, mix: Mapping[int, int],
                        avg_new_tokens: int) -> float:
        """Mix-weighted service seconds per request on a scale candidate,
        from the candidate's OWN plan artifact — one pricing engine is
        built per candidate and cached; it never joins and never steps."""
        eng = self._cand_engines.get(candidate.name)
        if eng is None:
            eng = candidate.make_engine(f"price:{candidate.name}")
            self._cand_engines[candidate.name] = eng
        return self._mix_price(eng, mix, avg_new_tokens,
                               f"cand:{candidate.name}")

    def _mix_price(self, eng: ServeEngine, mix: Mapping[int, int],
                   avg_new_tokens: int, cache_name: str) -> float:
        """Expected service seconds over a bucket mix; empty mix (no
        traffic observed yet) prices a uniform mix over the bucket edges."""
        if not mix:
            mix = {edge: 1 for edge in self.policy.edges}
        total_w = sum(mix.values())
        return sum(
            w * self.service_score_for(eng, b, avg_new_tokens, cache_name)
            for b, w in sorted(mix.items())) / max(total_w, 1)

    def scale_join(self, name: str, engine: ServeEngine) -> None:
        self.join(name, engine)

    def scale_drain(self, name: str) -> None:
        self.drain(name)

    def record_autoscale(self, decision) -> None:
        """Trace hook: every policy decision lands on the fleet lane with
        the full signal snapshot that triggered it."""
        if self._trace is not None:
            self._trace.autoscale(decision.action, decision.instance,
                                  decision.hardware, decision.reason,
                                  decision.signals)

    def pending(self) -> int:
        return (sum(eng.scheduler.pending() for eng in self.engines.values())
                + len(self._orphans))

    def run_until_done(self, max_steps: int = 1000
                       ) -> Dict[str, List[Request]]:
        """Drain every instance with interleaved steps (lockstep), so one
        engine's backlog never inflates another's wall-clock TTFT/TPOT.

        Raises :class:`FleetExhausted` when ``max_steps`` elapse with work
        still resident — a partial result set must never read as a
        complete run."""
        for _ in range(max_steps):
            if not self.step_all() and not self.pending():
                break
        else:
            work = {name: {"in_flight": eng.in_flight(),
                           "queued": eng.scheduler.pending()}
                    for name, eng in sorted(self.engines.items())
                    if eng.in_flight() or eng.scheduler.pending()}
            if work or self._orphans:
                raise FleetExhausted(max_steps, work, len(self._orphans))
        return {name: list(eng._finished)
                for name, eng in self.engines.items()}

    def results(self) -> Dict[int, List[int]]:
        """fid -> generated tokens for every finished request the fleet
        tracks (routed or absorbed). The basis for the fleet's
        zero-loss / zero-duplication / token-parity assertions: each fid
        appears at most once because rid mappings move with the request
        (and results retired at join-time replacement stay resolvable)."""
        out: Dict[int, List[int]] = dict(self._retired_results)
        for name, eng in self.engines.items():
            for req in eng._finished:
                fid = self._rid_map.get((name, req.rid))
                if fid is not None:
                    out[fid] = list(req.out_tokens)
        return out

    # -- versioned plan rollout ----------------------------------------------
    def roll_plans(self, artifact, drive_fn=None, tolerance: float = 1.10,
                   min_window: int = 4) -> List[RollDecision]:
        """Roll a (refined) plan artifact across the fleet, one instance at
        a time, with a p95-TTFT rollback guard.

        Per instance: ``drive_fn(name)`` (when given) pushes probe traffic
        through that engine BEFORE the swap — the pre-swap p95-TTFT window —
        then the engine is swapped via :meth:`ServeEngine.set_plans` and the
        SAME probe runs again. If the post-swap window regresses past
        ``tolerance`` x the pre-swap p95 (both windows holding at least
        ``min_window`` first-token samples — a thin window must never
        trigger a revert), the instance rolls back to its old artifact.
        A window that outgrew the metrics' circular sample buffer
        (``ttft_window`` reports it ``clipped``) silently misses samples
        and is treated exactly like a thin one: no confident keep/revert,
        the swap stands unguarded and the decision is marked ``clipped``.
        Either way the outcome lands in ``self.roll_history`` and the
        per-instance cost cache is invalidated (costs are a function of the
        plan). Without a ``drive_fn`` the swap is unguarded — every
        instance just moves to the new artifact.
        """
        decisions: List[RollDecision] = []
        for name in sorted(self.engines):
            eng = self.engines[name]
            old = eng.plans
            pre_p95, n_pre, pre_clip = 0.0, 0, False
            if drive_fn is not None:
                mark = eng.metrics.ttft_counts()
                drive_fn(name)
                samples, pre_clip = eng.metrics.ttft_window(mark)
                pre_p95 = nearest_rank(samples, 0.95)
                n_pre = len(samples)
            mark = eng.metrics.ttft_counts()
            eng.set_plans(artifact)
            self._cell_cost.clear()
            post_p95, n_post, post_clip = 0.0, 0, False
            if drive_fn is not None:
                drive_fn(name)
                samples, post_clip = eng.metrics.ttft_window(mark)
                post_p95 = nearest_rank(samples, 0.95)
                n_post = len(samples)
            clipped = pre_clip or post_clip
            rolled_back = (drive_fn is not None and not clipped
                           and n_pre >= min_window and n_post >= min_window
                           and pre_p95 > 0.0
                           and post_p95 > tolerance * pre_p95)
            if rolled_back:
                eng.set_plans(old)
                self._cell_cost.clear()
            decision = RollDecision(instance=name, pre_p95=pre_p95,
                                    post_p95=post_p95,
                                    rolled_back=rolled_back,
                                    clipped=clipped)
            self.roll_history.append(decision)
            decisions.append(decision)
            if self._trace is not None:
                self._trace.roll(name, pre_p95, post_p95, rolled_back,
                                 clipped)
        return decisions

    def metrics(self) -> Dict[str, dict]:
        out = {name: eng.metrics.as_dict()
               for name, eng in self.engines.items()}
        out["router"] = {
            "routed": len(self.decisions),
            "rejects": dict(sorted(self.rejects.items())),
            "placements": {str(b): dict(sorted(p.items()))
                           for b, p in sorted(self.placements().items())},
        }
        out["fleet"] = {
            "status": dict(sorted(self.status.items())),
            "recoveries": self.recoveries,
            "steals": self.steals,
            "lost": self.lost,
            "orphans": len(self._orphans),
            "tokens_discarded": sum(fr.tokens_discarded
                                    for fr in self._fleet.values()),
            "instance_steps": self.instance_steps,
        }
        if self.autoscaler is not None:
            out["autoscale"] = self.autoscaler.as_dict()
        return out
