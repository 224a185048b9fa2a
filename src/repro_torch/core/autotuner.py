"""Tile autotuner — the paper's sweep methodology as a framework service.

The port's copy of ``repro/core/autotuner.py``. The paper's experiment: for
each GPU model, run the kernel over a grid of tile dims, pick the fastest,
observe that optima differ across models. This module does exactly that,
per :class:`~repro_torch.core.hardware.HardwareModel`:

* ``sweep`` evaluates every legal tile (via the registry's constraint system)
  with the analytic cost model — and, when a ``measure_fn`` is supplied (an
  H100 present, ``repro_torch.launch.measure``), times the analytically best
  candidates on the card; measured times take precedence.
* results are cached persistently keyed by
  ``(kernel, problem, dtype, hardware)`` so tuning amortizes across runs, and
  the cache doubles as the cross-model comparison table of the paper's Fig. 3.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import TYPE_CHECKING, Callable, Dict, List, Mapping, Optional

from repro_torch.core import registry
from repro_torch.core.cost_model import CostBreakdown, estimate
from repro_torch.core.hardware import HardwareModel
from repro_torch.core.tiling import TileShape, enumerate_tiles

if TYPE_CHECKING:  # avoid a cycle: plans.compile_entry uses Autotuner
    from repro_torch.core.plans import TilePlan

MeasureFn = Callable[[TileShape], float]  # returns seconds per call


class NoLegalTileError(ValueError):
    """A cell whose kernel has no legal (launchable, fitting) tile."""


@dataclasses.dataclass(frozen=True)
class SweepEntry:
    tile: TileShape
    cost: CostBreakdown
    measured_s: Optional[float] = None

    @property
    def score(self) -> float:
        return self.measured_s if self.measured_s is not None else self.cost.total_s


@dataclasses.dataclass
class SweepResult:
    kernel: str
    hardware: str
    dtype: str
    problem: Mapping[str, int]
    entries: List[SweepEntry]

    @property
    def best(self) -> SweepEntry:
        # Wall-clock measurements outrank model estimates: never compare a
        # measured time against an (optimistic) analytic one directly.
        measured = [e for e in self.entries if e.measured_s is not None]
        pool = measured if measured else self.entries
        return min(pool, key=lambda e: e.score)

    def sensitivity(self) -> float:
        """Spread of the sweep: worst/best ratio over finite entries.

        The paper's §IV.C principle predicts this shrinks as core count
        grows; `benchmarks/bench_sensitivity.py` asserts exactly that.
        """
        finite = [e.score for e in self.entries if e.score != float("inf")]
        if not finite:
            return float("inf")
        return max(finite) / min(finite)


class Autotuner:
    """Sweep + select + persistent cache.

    With ``plans`` (a compiled :class:`~repro_torch.core.plans.TilePlan`), the
    resolution order of :meth:`best_tile` becomes cache -> plan lookup
    (exact / nearest-shape / cross-hardware, see ``TilePlan.resolve``) ->
    sweep, so pre-compiled fleets never sweep on the hot path.
    """

    def __init__(self, cache_path: Optional[str] = None,
                 plans: Optional["TilePlan"] = None):
        self._cache_path = cache_path
        self._cache: Dict[str, dict] = {}
        self._lock = threading.Lock()
        self.plans = plans
        self.sweep_count = 0  # observability: hot paths assert this stays 0
        if cache_path and os.path.exists(cache_path):
            try:
                with open(cache_path) as f:
                    self._cache = json.load(f)
            except (json.JSONDecodeError, OSError):
                self._cache = {}

    @staticmethod
    def _key(kernel: str, problem: Mapping[str, int], dtype: str, hw: str) -> str:
        pk = ",".join(f"{k}={v}" for k, v in sorted(problem.items()))
        return f"{kernel}|{pk}|{dtype}|{hw}"

    def sweep(
        self,
        kernel: str,
        problem: Mapping[str, int],
        dtype: str,
        hw: HardwareModel,
        measure_fn: Optional[MeasureFn] = None,
        max_candidates: int = 512,
        measure_top_k: int = 8,
        tiles: Optional[List[TileShape]] = None,
    ) -> SweepResult:
        """Sweep ``tiles`` (or the auto-enumerated legal space) on ``hw``.

        Passing ``tiles`` explicitly pins the candidate set — used by the
        paper-reproduction benchmarks to sweep the paper's own Fig. 3 axis.
        """
        self.sweep_count += 1
        spec = registry.get(kernel)
        if tiles is None:
            constraints = spec.constraints(problem)
            tiles = enumerate_tiles(
                constraints, hw, dtype,
                vmem_bytes_fn=lambda t: spec.vmem_bytes(t, problem, dtype),
                max_candidates=max_candidates,
            )
        if not tiles:
            raise NoLegalTileError(
                f"no legal tiles for {kernel} problem={dict(problem)} on {hw.name}"
            )
        entries = []
        for t in tiles:
            work = spec.workload(t, problem, dtype)
            cost = estimate(
                hw, work, spec.n_tiles(t, problem),
                vmem_bytes=spec.vmem_bytes(t, problem, dtype),
            )
            entries.append(SweepEntry(tile=t, cost=cost))
        # If real hardware timing is available, measure the analytically-best
        # top-k (the paper measured everything; we prune with the model first).
        if measure_fn is not None:
            entries.sort(key=lambda e: e.cost.total_s)
            timed = []
            for e in entries[:measure_top_k]:
                timed.append(
                    SweepEntry(e.tile, e.cost, measured_s=measure_fn(e.tile))
                )
            entries = timed + entries[measure_top_k:]
        return SweepResult(kernel, hw.name, dtype, dict(problem), entries)

    def best_tile(
        self,
        kernel: str,
        problem: Mapping[str, int],
        dtype: str,
        hw: HardwareModel,
        measure_fn: Optional[MeasureFn] = None,
    ) -> TileShape:
        key = self._key(kernel, problem, dtype, hw.name)
        with self._lock:
            hit = self._cache.get(key)
        if hit is not None:
            return TileShape(tuple(hit["tile"]))
        if self.plans is not None:
            res = self.plans.resolve(kernel, problem, dtype, hw)
            if res is not None:
                with self._lock:
                    self._cache[key] = {
                        "tile": list(res.tile.dims),
                        "score_s": res.score_s,
                        "dominant": res.entry.dominant,
                        "source": f"plan:{res.source}",
                    }
                    self._flush_locked()
                return res.tile
        result = self.sweep(kernel, problem, dtype, hw, measure_fn=measure_fn)
        best = result.best
        with self._lock:
            self._cache[key] = {
                "tile": list(best.tile.dims),
                "score_s": best.score,
                "dominant": best.cost.dominant(),
            }
            self._flush_locked()
        return best.tile

    def _flush_locked(self) -> None:
        if not self._cache_path:
            return
        # Approximate plan resolutions (nearest-shape clamps, cross-hardware
        # transfers) are provisional: never durable, whoever triggers the
        # flush, so a corrected plan artifact with an exact entry wins on
        # the next process start. Swept/measured results and exact plan hits
        # persist.
        durable = {
            k: v for k, v in self._cache.items()
            if v.get("source") in (None, "plan:exact")
        }
        tmp = self._cache_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(durable, f, indent=1, sort_keys=True)
        os.replace(tmp, self._cache_path)

    def cached(self) -> Dict[str, dict]:
        with self._lock:
            return dict(self._cache)
