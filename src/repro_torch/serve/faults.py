"""Deterministic fault injection for the port's serving fleet.

The reference's vocabulary (``repro/serve/faults.py``), as it is.

The paper's claim — a tiling strategy tuned under one set of conditions
degrades when "external conditions were changed" — has a fleet-level
analogue: a placement made at admission degrades when the fleet itself
changes. This module scripts exactly those changes so they are
*replayable*: every fault fires at a scripted **router step number**, not
at a wall-clock instant, so two runs of the same script against the same
trace produce byte-identical schedules, recoveries, and exported traces.

Vocabulary (``FaultEvent.action``):

- ``kill`` — the instance dies. The router's next ``step_all`` detects it
  as a liveness failure (stepping a killed engine raises
  :class:`EngineFault`), marks it ``dead``, and recovers its queued and
  in-flight requests onto survivors.
- ``stall`` — the instance keeps "stepping" but makes no progress (a hung
  accelerator, a livelocked host). Nothing raises: only the router's
  progress watchdog (steps-without-progress threshold) can detect it.
- ``degrade`` — the instance serves correctly but ``factor`` x slower.
  Pure clock-side: virtual-clock callers read
  :meth:`FaultInjector.latency_factor` when advancing time; behavior and
  tokens are untouched.
- ``recover`` — undo a prior kill/stall/degrade on the instance (the
  router does NOT automatically re-trust it; requests already recovered
  stay recovered — this models a restarted process rejoining as healthy).
- ``drain`` — scripted graceful drain: the router calls
  ``FleetRouter.drain(instance)``.
- ``join`` — scripted elastic join: the router calls
  ``FleetRouter.join(instance, make_engine())`` — ``make_engine`` is the
  event's engine factory, invoked at the scripted step so construction
  cost lands where the scenario says it does.

No randomness anywhere: a :class:`FaultScript` is a plain sorted list of
events, and :class:`FaultInjector` is a step-indexed cursor over it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Set

ACTIONS = ("kill", "stall", "degrade", "recover", "drain", "join")


class EngineFault(RuntimeError):
    """Raised when a killed instance is stepped — the liveness signal the
    router converts into failure detection + request recovery."""

    def __init__(self, instance: str):
        super().__init__(f"engine {instance!r} is dead (injected fault)")
        self.instance = instance


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scripted fault: ``action`` hits ``instance`` at router ``step``.

    ``factor`` is the step-latency multiplier for ``degrade`` (ignored
    otherwise); ``make_engine`` is the zero-arg engine factory for
    ``join`` (required there, ignored otherwise).
    """

    step: int
    action: str
    instance: str
    factor: float = 1.0
    make_engine: Optional[Callable[[], Any]] = None

    def __post_init__(self):
        if self.action not in ACTIONS:
            raise ValueError(
                f"unknown fault action {self.action!r} (one of {ACTIONS})")
        if self.step < 0:
            raise ValueError(f"fault step must be >= 0: {self.step}")
        if self.action == "degrade" and self.factor <= 0:
            raise ValueError(f"degrade factor must be > 0: {self.factor}")
        if self.action == "join" and self.make_engine is None:
            raise ValueError("join events need a make_engine factory")


class FaultScript:
    """An ordered, replayable fault schedule.

    Events sort by (step, submission order) so two events at the same step
    apply in the order they were scripted — determinism is the contract.
    """

    def __init__(self, events: Sequence[FaultEvent] = ()):
        self.events: List[FaultEvent] = sorted(
            events, key=lambda e: e.step)
        # Stable sort keeps same-step submission order.

    def add(self, event: FaultEvent) -> "FaultScript":
        self.events = sorted(self.events + [event], key=lambda e: e.step)
        return self

    def events_at(self, step: int) -> List[FaultEvent]:
        return [e for e in self.events if e.step == step]

    def max_step(self) -> int:
        return self.events[-1].step if self.events else 0


class FaultInjector:
    """Step-indexed cursor over a :class:`FaultScript` plus the live fault
    state (which instances are currently killed / stalled / degraded).

    The router calls :meth:`advance` once at the top of every
    ``step_all``; the injector applies kill/stall/degrade/recover to its
    own state and returns ALL of the step's events so the router can act
    on ``drain``/``join`` and trace every injection. Virtual-clock
    callers read :meth:`latency_factor` when advancing time.
    """

    def __init__(self, script: FaultScript):
        self.script = script
        self.killed: Set[str] = set()
        self.stalled: Set[str] = set()
        self.degraded: Dict[str, float] = {}
        self._cursor = 0

    def advance(self, step: int) -> List[FaultEvent]:
        """Apply every scripted event with ``event.step <= step`` that has
        not fired yet; returns them in firing order."""
        fired: List[FaultEvent] = []
        while (self._cursor < len(self.script.events)
               and self.script.events[self._cursor].step <= step):
            ev = self.script.events[self._cursor]
            self._cursor += 1
            if ev.action == "kill":
                self.killed.add(ev.instance)
                self.stalled.discard(ev.instance)
            elif ev.action == "stall":
                self.stalled.add(ev.instance)
            elif ev.action == "degrade":
                self.degraded[ev.instance] = float(ev.factor)
            elif ev.action == "recover":
                self.killed.discard(ev.instance)
                self.stalled.discard(ev.instance)
                self.degraded.pop(ev.instance, None)
            # drain/join mutate the router, not the injector.
            fired.append(ev)
        return fired

    def is_killed(self, instance: str) -> bool:
        return instance in self.killed

    def is_stalled(self, instance: str) -> bool:
        return instance in self.stalled

    def latency_factor(self, instance: str) -> float:
        """Step-latency multiplier for virtual-clock callers (1.0 =
        healthy)."""
        return self.degraded.get(instance, 1.0)
