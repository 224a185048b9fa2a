"""Online plan refinement: close the loop from serving telemetry to the plan.

The port's ``repro/serve/refine.py``. The paper's punchline is that a
tiling optimum tuned on one model of GPU rots when the hardware, or the
conditions around it, change. The AOT plan artifacts
(``repro_torch.core.plans``) are such offline optima: ranked once, by the
cost model (or by the card, for a wall-clock compile), for one hardware
descriptor. A serving engine contradicts them in real time. This module
feeds that evidence back:

* **Shadow execution** — each engine diverts a deterministic fraction of
  its steps (``shadow_fraction``, counter-based: no wall-clock randomness)
  to *measure* one candidate tile drawn from the plan's stored sensitivity
  curve next to the incumbent, through the shared timing path
  (:func:`make_shadow_measure` -> ``launch.measure.make_cell_timer``: the
  card's time of the kernel on the cell's own operands for ``h100_sxm``,
  the cost model's score on a modelled descriptor). Shadow measurements
  never touch the serving math or the slots' captured graphs: a cell is
  timed out of band, on operands of its own, in a graph of its own that is
  dropped after the measurement, so served tokens are bit-identical with
  shadowing on or off.
* **Online re-ranking** — :class:`PlanRefiner` aggregates the samples per
  ``(hardware, kernel, problem, dtype)`` cell behind a confidence gate
  (``min_samples`` per tile and ``min_speedup`` over the *measured*
  incumbent) and :meth:`PlanRefiner.refine` emits a new schema-v3 artifact:
  every donor entry kept, plus one measured entry per confidently-better
  cell keyed to the observing hardware, so resolution after the swap
  (``ServeEngine.set_plans``) is an *exact* hit. Provenance rides in
  ``meta["refined_from"]`` / ``meta["measurements"]``;
  :func:`drift_report` renders the incumbent-vs-refined tile table.

**A tile the wrapper would not launch as given measures ``inf``.** The
port's kernels compile a fixed set of tiles, and a plan ranked for another
GPU model names tiles the H100's wrappers refuse (a matmul or attention
tile that is not compiled) or run as another tile (a decode block longer
than the cache, clamped to it). On the card such a tile, incumbent or
candidate, is never timed: :func:`make_shadow_measure` returns
``math.inf`` for it (``launch.specs.cell_launches``), as the reference's
measure path does for a cell it cannot set up, so the refiner never
re-ranks on the time of another tile. The gate then reads an infinite
mean like any other: an infinite candidate never wins; an infinite
incumbent (the plan serves a tile the card cannot run as named, so the
engine replaced it by the kernel's default at resolution) is beaten by any
candidate with a finite mean and ``min_samples`` samples, at an infinite
speedup; a cell whose every sampled tile is infinite is not re-ranked.
The refined entry's curve keeps the infinite points, and its sensitivity
is taken over the finite ones.

The fleet's versioned rollout (``FleetRouter.roll_plans``) comes with the
fleet; a single engine swaps with ``set_plans``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Mapping, Optional, Tuple

from repro_torch.core.hardware import MODELLED, HardwareModel
from repro_torch.core.plans import (
    PLAN_SCHEMA_VERSION,
    PlanEntry,
    TilePlan,
    problem_key,
)
from repro_torch.core.tiling import TileShape

# (kernel, problem, dtype, tile dims) -> measured seconds.
ShadowMeasureFn = Callable[[str, Mapping[str, int], str, Tuple[int, ...]],
                           float]


def make_shadow_measure(hw: HardwareModel) -> ShadowMeasureFn:
    """The default shadow timing path for one hardware target.

    Delegates to ``launch.measure.make_cell_timer``: the card's time for
    ``h100_sxm`` (``RuntimeError`` without a CUDA device: it never falls
    back to the cost model), the cost model's score on a modelled
    descriptor, with the per-cell timer (and its operands on the card)
    cached across shadow steps, so a long-running engine builds each
    cell's operands once. Each measurement captures, replays and drops
    its own CUDA graph. On the card a tile its wrapper would not launch as
    given measures ``inf`` without being timed. ``measure.timers`` is the
    cache (cell -> timer).
    """
    from repro_torch.launch.measure import make_cell_timer
    from repro_torch.launch.specs import cell_launches

    timers: Dict[Tuple[str, str, str], Callable] = {}

    def measure(kernel: str, problem: Mapping[str, int], dtype: str,
                tile) -> float:
        if hw.name not in MODELLED and not cell_launches(kernel, problem,
                                                         dtype, tile):
            return math.inf
        key = (kernel, problem_key(problem), dtype)
        timer = timers.get(key)
        if timer is None:
            timer = make_cell_timer(kernel, dict(problem), dtype, hw)
            timers[key] = timer
        return float(timer(tuple(tile)))

    measure.timers = timers
    return measure


@dataclasses.dataclass
class _TileStats:
    count: int = 0
    total_s: float = 0.0

    @property
    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0


@dataclasses.dataclass
class _CellStats:
    """Shadow evidence for one (hardware, kernel, problem, dtype) cell."""

    kernel: str
    problem: Dict[str, int]
    dtype: str
    hardware: str
    tiles: Dict[Tuple[int, ...], _TileStats] = dataclasses.field(
        default_factory=dict)
    incumbent: Optional[Tuple[int, ...]] = None


class PlanRefiner:
    """Aggregate shadow measurements and re-rank a plan artifact from them.

    One refiner may be shared by several engines (cells are keyed by
    the observing engine's hardware name, so a heterogeneous fleet refines
    each model's cells independently). The confidence gate is deliberately
    conservative: a cell is only re-ranked when BOTH the winner and the
    measured incumbent have at least ``min_samples`` observations and the
    winner's mean beats the incumbent's by at least ``min_speedup`` — a
    noisy single fast sample must never flip a fleet's tile.
    """

    def __init__(self, min_samples: int = 3, min_speedup: float = 1.05):
        if min_samples < 1:
            raise ValueError("min_samples must be >= 1")
        if min_speedup < 1.0:
            raise ValueError("min_speedup must be >= 1.0")
        self.min_samples = min_samples
        self.min_speedup = min_speedup
        self._cells: Dict[Tuple[str, str, str, str], _CellStats] = {}

    # -- evidence ------------------------------------------------------------
    def observe(self, kernel: str, problem: Mapping[str, int], dtype: str,
                hardware: str, tile, dt: float,
                incumbent: bool = False) -> None:
        """One shadow measurement: ``tile`` ran the cell in ``dt`` seconds.

        ``incumbent`` marks the tile the engine is actually serving with;
        it anchors the speedup gate (candidates are compared against the
        incumbent's *measured* mean, not its stale plan score).
        """
        key = (hardware, kernel, problem_key(problem), dtype)
        cell = self._cells.get(key)
        if cell is None:
            cell = _CellStats(kernel=kernel, problem=dict(problem),
                              dtype=dtype, hardware=hardware)
            self._cells[key] = cell
        dims = tuple(int(x) for x in tile)
        stats = cell.tiles.setdefault(dims, _TileStats())
        stats.count += 1
        stats.total_s += float(dt)
        if incumbent:
            cell.incumbent = dims

    def n_samples(self) -> int:
        return sum(s.count for c in self._cells.values()
                   for s in c.tiles.values())

    def cells(self) -> List[Tuple[str, str, str, str]]:
        return sorted(self._cells)

    # -- the confidence gate -------------------------------------------------
    def _decide(self, cell: _CellStats) -> Optional[dict]:
        """A confidently-better tile for this cell, or None."""
        inc = cell.incumbent
        if inc is None:
            return None
        inc_stats = cell.tiles.get(inc)
        if inc_stats is None or inc_stats.count < self.min_samples:
            return None
        ranked = sorted(
            ((s.mean_s, dims) for dims, s in cell.tiles.items()
             if s.count >= self.min_samples),
            key=lambda p: (p[0], p[1]),
        )
        if not ranked:
            return None
        best_s, best = ranked[0]
        if best == inc or best_s <= 0.0 or not math.isfinite(best_s):
            return None
        speedup = inc_stats.mean_s / best_s
        if speedup < self.min_speedup:
            return None
        return {
            "tile": best,
            "score_s": best_s,
            "incumbent": inc,
            "incumbent_s": inc_stats.mean_s,
            "speedup": speedup,
            "samples": cell.tiles[best].count,
        }

    # -- re-ranking ----------------------------------------------------------
    def refine(self, plan: TilePlan, trace=None) -> TilePlan:
        """Emit a schema-v3 artifact: the donor plan plus one measured entry
        per confidently re-ranked cell, keyed to the observing hardware so
        post-rollout resolution is exact. The provenance block records what
        the artifact was refined from and every re-rank decision.

        ``trace`` (a :class:`repro_torch.obs.trace.ProcTrace`, optional) gets one
        ``refine_cell`` instant per re-ranked cell, so the audit trail shows
        *when* the fleet's evidence flipped each tile, next to the shadow
        measurements that justified it."""
        refined = TilePlan(entries=plan.entries(), meta=dict(plan.meta))
        measurements: List[dict] = []
        for key in sorted(self._cells):
            cell = self._cells[key]
            decision = self._decide(cell)
            if decision is None:
                continue
            if trace is not None:
                trace.refine_cell(cell.kernel, problem_key(cell.problem),
                                  decision["incumbent"], decision["tile"],
                                  decision["speedup"], decision["samples"])
            curve = tuple(sorted(
                ((dims, s.mean_s) for dims, s in cell.tiles.items()
                 if s.count >= self.min_samples),
                key=lambda p: (p[1], p[0]),
            ))
            finite = [s for _, s in curve if 0.0 < s < math.inf]
            refined.add(PlanEntry(
                kernel=cell.kernel,
                hardware=cell.hardware,
                dtype=cell.dtype,
                problem=tuple(sorted(cell.problem.items())),
                tile=TileShape(decision["tile"]),
                score_s=decision["score_s"],
                dominant="measured",
                sensitivity=(max(finite) / min(finite) if finite else 1.0),
                curve=curve,
            ))
            measurements.append({
                "kernel": cell.kernel,
                "problem": dict(cell.problem),
                "dtype": cell.dtype,
                "hardware": cell.hardware,
                "incumbent": list(decision["incumbent"]),
                "incumbent_s": decision["incumbent_s"],
                "tile": list(decision["tile"]),
                "score_s": decision["score_s"],
                "speedup": decision["speedup"],
                "samples": decision["samples"],
            })
        refined.meta["refined_from"] = {
            "entries": len(plan),
            "hardware": plan.hardware_names(),
            "generated_by": plan.meta.get("generated_by"),
            "schema_version": PLAN_SCHEMA_VERSION,
        }
        refined.meta["measurements"] = measurements
        refined.meta["shadow_samples"] = self.n_samples()
        return refined


def drift_report(refined: TilePlan) -> dict:
    """Incumbent-vs-refined tile per re-ranked cell (the CI drift artifact).

    Reads the provenance block a :meth:`PlanRefiner.refine` call wrote, so
    the report can be regenerated from the artifact alone.
    """
    measurements = refined.meta.get("measurements", [])
    cells = [
        {
            "cell": (f"{m['kernel']}|{problem_key(m['problem'])}"
                     f"|{m['dtype']}|{m['hardware']}"),
            "incumbent": m["incumbent"],
            "refined": m["tile"],
            "incumbent_s": m["incumbent_s"],
            "refined_s": m["score_s"],
            "speedup": m["speedup"],
            "samples": m["samples"],
        }
        for m in measurements
    ]
    return {
        "n_refined": len(cells),
        "shadow_samples": refined.meta.get("shadow_samples", 0),
        "refined_from": refined.meta.get("refined_from", {}),
        "cells": cells,
    }
