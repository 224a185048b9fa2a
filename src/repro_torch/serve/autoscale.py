"""Telemetry-driven autoscaling of the port's fleet: WHEN to join or drain.

The reference's policy (``repro/serve/autoscale.py``), as it is.
``FleetRouter.drain`` / ``join`` retire and add instances mid-run with
zero request loss; this module decides when to use them:
:class:`AutoscalePolicy` watches the signals the fleet already exports
(per-instance queue depth, windowed p95 TTFT, KV-pool occupancy, orphan
count) and emits deterministic scale decisions.

The paper's cross-model result is what makes the *which hardware* question
non-trivial: per-model tiles mean per-model cost, so the cheapest
instance to add depends on the current traffic mix, not on a static
hardware ranking. Each :class:`ScaleCandidate` carries a ``price``
(relative $/instance-step) and is scored as::

    price * sum_b mix[b] * service_score(candidate, b, avg_new_tokens)

— the plan-resolved service estimate for the *observed* bucket mix. A
compute-heavy mix (long prefills) and a memory-heavy mix (decode-token
heavy) therefore rank a high-FLOPs model and a high-bandwidth model
differently, and the policy joins different hardware for each: the
paper's per-model-optimum claim at fleet-capacity granularity.

Hysteresis so the fleet never flaps:

* decisions are evaluated every ``interval`` steps, never more often;
* any decision starts a ``cooldown`` (counted in evaluations) during
  which no further decision fires — a join must show up in the signals
  before the next one is considered;
* scale-down additionally requires ``low_evals`` *consecutive* low-load
  evaluations (the streak resets on any high signal);
* fleet size is clamped to ``[min_instances, max_instances]``.

The policy is deliberately engine-agnostic: it talks to any "fleet" that
implements the small adapter protocol below, which the port's
:class:`~repro_torch.serve.fleet.FleetRouter` (virtual- or wall-clock
engines) and the reference's queueing simulator
(``benchmarks/bench_autoscale.py``) both provide::

    live_instances() -> list[str]         # routable instance names
    known_instances() -> set[str]         # every name ever used
    instance_hardware(name) -> str|None
    queue_depths() -> dict[str, int]      # queued (not in-flight) work
    ttft_marks() -> mark                  # opaque cursor
    ttft_window_since(mark) -> (list[float], clipped)
    traffic_mix() -> (dict[bucket,int], new_tokens_sum, n)   # cumulative
    pool_occupancy() -> float             # max used/total over live, 0-1
    orphan_count() -> int
    price_instance(name, mix, avg_new_tokens) -> float   # s/request
    price_candidate(candidate, mix, avg_new_tokens) -> float
    scale_join(name, engine) -> None
    scale_drain(name) -> None
    record_autoscale(decision) -> None    # trace hook

Every emitted :class:`ScaleDecision` carries the full signal snapshot
that triggered it, lands in ``policy.decisions`` / ``as_dict()`` (the
``metrics()["autoscale"]`` block), and is traced on the fleet lane.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.serve.metrics import nearest_rank

AUTOSCALE_SCHEMA_VERSION = 1

#: Scale-up triggers in priority order (first matching wins; the reason
#: string lands on the decision and in the trace event).
UP_REASONS = ("orphans", "p95_ttft", "queue_depth", "pool_occupancy")


@dataclasses.dataclass(frozen=True)
class ScaleCandidate:
    """One hardware model the policy may join capacity from.

    ``make_engine(name)`` builds a fresh instance (a ``ServeEngine`` for
    the real fleet; any adapter-compatible object for a simulator) — a
    NEW engine per join, never shared. ``price`` is the relative cost of
    keeping one such instance running for one step; the policy minimizes
    ``price x mix-weighted service seconds``, so an expensive fast model
    wins only when the traffic mix actually exploits its strength.
    """

    name: str
    hardware: str
    make_engine: Callable[[str], Any]
    price: float = 1.0

    def __post_init__(self):
        if self.price <= 0:
            raise ValueError(f"candidate {self.name!r}: price must be > 0")


@dataclasses.dataclass(frozen=True)
class ScaleDecision:
    """One autoscale action plus the telemetry snapshot that triggered it."""

    step: int
    action: str                       # "join" | "drain"
    instance: str
    hardware: Optional[str]
    reason: str                       # UP_REASONS entry or "low_load"
    signals: Dict[str, float]

    def as_dict(self) -> Dict[str, Any]:
        return {
            "step": self.step, "action": self.action,
            "instance": self.instance, "hardware": self.hardware,
            "reason": self.reason,
            "signals": {k: self.signals[k] for k in sorted(self.signals)},
        }


class AutoscalePolicy:
    """Deterministic join/drain decisions from fleet telemetry."""

    def __init__(self, candidates=(), *,
                 min_instances: int = 1, max_instances: int = 4,
                 interval: int = 8, cooldown: int = 2,
                 queue_high: float = 8.0, queue_low: float = 1.0,
                 ttft_high: Optional[float] = None,
                 ttft_low: Optional[float] = None,
                 pool_high: float = 0.9,
                 low_evals: int = 3, min_ttft_samples: int = 4,
                 instance_prices: Optional[Dict[str, float]] = None):
        self.candidates: Tuple[ScaleCandidate, ...] = tuple(candidates)
        names = [c.name for c in self.candidates]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate candidate names: {names}")
        if min_instances < 1:
            raise ValueError("min_instances must be >= 1")
        if max_instances < min_instances:
            raise ValueError("max_instances must be >= min_instances")
        if interval < 1:
            raise ValueError("interval must be >= 1")
        if cooldown < 0:
            raise ValueError("cooldown must be >= 0")
        if low_evals < 1:
            raise ValueError("low_evals must be >= 1")
        if queue_low > queue_high:
            raise ValueError("queue_low must be <= queue_high")
        if (ttft_high is not None and ttft_low is not None
                and ttft_low > ttft_high):
            raise ValueError("ttft_low must be <= ttft_high")
        self.min_instances = min_instances
        self.max_instances = max_instances
        self.interval = interval
        self.cooldown = cooldown
        self.queue_high = queue_high
        self.queue_low = queue_low
        self.ttft_high = ttft_high
        self.ttft_low = ttft_low
        self.pool_high = pool_high
        self.low_evals = low_evals
        self.min_ttft_samples = min_ttft_samples
        # Per-member price (for drain-victim costing). Members joined by
        # this policy inherit their candidate's price; pre-existing fleet
        # members default to 1.0 unless listed here.
        self.instance_price: Dict[str, float] = dict(instance_prices or {})
        self.decisions: List[ScaleDecision] = []
        self._last_eval: Optional[int] = None
        self._evals = 0
        self._cooldown_left = 0
        self._low_streak = 0
        self._ttft_mark = None
        self._mix_mark: Tuple[Dict[Any, int], int, int] = ({}, 0, 0)

    # -- signal assembly ---------------------------------------------------
    def _signals(self, fleet, step: int) -> Tuple[Dict[str, float],
                                                  Dict[Any, int], float]:
        """Snapshot the fleet's telemetry for one evaluation.

        Returns ``(signals, window_mix, avg_new_tokens)`` where the mix is
        the bucket histogram of arrivals since the previous evaluation
        (falling back to the cumulative mix when the window is empty, so
        pricing keeps working through idle stretches)."""
        live = sorted(fleet.live_instances())
        depths = fleet.queue_depths()
        queued = sum(int(depths.get(n, 0)) for n in live)
        samples, clipped = fleet.ttft_window_since(self._ttft_mark)
        self._ttft_mark = fleet.ttft_marks()
        p95 = nearest_rank(samples, 0.95) if samples else 0.0
        mix_total, nt_sum, nt_n = fleet.traffic_mix()
        prev_mix, prev_sum, prev_n = self._mix_mark
        window_mix = {b: c - prev_mix.get(b, 0)
                      for b, c in mix_total.items()
                      if c - prev_mix.get(b, 0) > 0}
        win_n = nt_n - prev_n
        avg_new = ((nt_sum - prev_sum) / win_n if win_n > 0
                   else nt_sum / nt_n if nt_n > 0 else 16.0)
        self._mix_mark = (dict(mix_total), nt_sum, nt_n)
        if not window_mix:
            window_mix = dict(mix_total)
        signals = {
            "step": int(step),
            "instances": len(live),
            "queue_depth": queued,
            "queue_per_instance": queued / len(live) if live else float(queued),
            "p95_ttft": float(p95),
            "ttft_samples": len(samples),
            "ttft_clipped": int(bool(clipped)),
            "pool_occupancy": float(fleet.pool_occupancy()),
            "orphans": int(fleet.orphan_count()),
            "arrivals": int(win_n) if win_n > 0 else 0,
        }
        return signals, window_mix, avg_new

    def _up_reason(self, sig: Dict[str, float]) -> Optional[str]:
        if sig["orphans"] > 0:
            return "orphans"
        if (self.ttft_high is not None
                and sig["ttft_samples"] >= self.min_ttft_samples
                and sig["p95_ttft"] > self.ttft_high):
            return "p95_ttft"
        if sig["queue_per_instance"] > self.queue_high:
            return "queue_depth"
        if sig["pool_occupancy"] > self.pool_high:
            return "pool_occupancy"
        return None

    def _is_low(self, sig: Dict[str, float]) -> bool:
        return (sig["orphans"] == 0
                and sig["queue_per_instance"] <= self.queue_low
                and sig["pool_occupancy"] <= self.pool_high
                and (self.ttft_low is None
                     or sig["ttft_samples"] == 0
                     or sig["p95_ttft"] <= self.ttft_low))

    def _join_name(self, fleet, cand: ScaleCandidate) -> str:
        known = set(fleet.known_instances())
        name, k = cand.name, 1
        while name in known:
            k += 1
            name = f"{cand.name}{k}"
        return name

    # -- decision loop -----------------------------------------------------
    def observe(self, fleet, step: int) -> List[ScaleDecision]:
        """Evaluate the fleet at ``step``; apply and return any decision.

        Called by ``FleetRouter.step_all`` (behind ``autoscaler=``) after
        orphan recovery / stealing / drain completion, so signals reflect
        the post-recovery state of this step."""
        if (self._last_eval is not None
                and step - self._last_eval < self.interval):
            return []
        self._last_eval = step
        self._evals += 1
        sig, mix, avg_new = self._signals(fleet, step)
        live = sorted(fleet.live_instances())
        reason = self._up_reason(sig)
        if reason is not None:
            # High load resets the scale-down streak even during cooldown:
            # evidence of load is evidence against draining.
            self._low_streak = 0
        elif self._is_low(sig):
            self._low_streak += 1
        else:
            self._low_streak = 0
        if self._cooldown_left > 0:
            self._cooldown_left -= 1
            return []
        nt = max(1, int(round(avg_new)))
        if (reason is not None and self.candidates
                and len(live) < self.max_instances):
            cand = min(
                self.candidates,
                key=lambda c: (c.price * fleet.price_candidate(c, mix, nt),
                               c.name))
            name = self._join_name(fleet, cand)
            decision = ScaleDecision(
                step=step, action="join", instance=name,
                hardware=cand.hardware, reason=reason, signals=sig)
            fleet.record_autoscale(decision)
            fleet.scale_join(name, cand.make_engine(name))
            self.instance_price[name] = cand.price
            self.decisions.append(decision)
            self._cooldown_left = self.cooldown
            return [decision]
        if (self._low_streak >= self.low_evals
                and len(live) > self.min_instances):
            # Drain the member whose removal is cheapest: the one with the
            # WORST cost-effectiveness (price x per-request seconds) for
            # the current mix — losing it costs the least capacity per $.
            victim = max(
                live,
                key=lambda n: (self.instance_price.get(n, 1.0)
                               * fleet.price_instance(n, mix, nt), n))
            decision = ScaleDecision(
                step=step, action="drain", instance=victim,
                hardware=fleet.instance_hardware(victim),
                reason="low_load", signals=sig)
            fleet.record_autoscale(decision)
            fleet.scale_drain(victim)
            self.decisions.append(decision)
            self._low_streak = 0
            self._cooldown_left = self.cooldown
            return [decision]
        return []

    # -- export ------------------------------------------------------------
    def as_dict(self) -> Dict[str, Any]:
        """The ``metrics()["autoscale"]`` block: deterministic, JSON-clean."""
        return {
            "schema_version": AUTOSCALE_SCHEMA_VERSION,
            "evaluations": self._evals,
            "joins": sum(d.action == "join" for d in self.decisions),
            "drains": sum(d.action == "drain" for d in self.decisions),
            "cooldown_left": self._cooldown_left,
            "low_streak": self._low_streak,
            "candidates": [
                {"name": c.name, "hardware": c.hardware, "price": c.price}
                for c in self.candidates],
            "log": [d.as_dict() for d in self.decisions],
        }
