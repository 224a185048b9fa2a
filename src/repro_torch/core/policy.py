"""TilingPolicy — how the framework picks tiles at model-build time.

The port's copy of ``repro/core/policy.py``. Three modes, all grounded in
the paper:

* ``heuristic``  — each kernel's Hopper ``default_tile`` (the "32x4
  principle": the contiguous dim wide first). Zero-cost, no sweep.
* ``tuned``      — per-hardware-model autotune (the paper's per-GPU sweep),
  cached persistently.
* ``robust``     — the paper's §V recommendation: pick the tile minimizing
  the *worst-case* cost across a fleet of hardware models ("consider more
  about the performance on the worst-case GPU").

With ``plans`` attached (a compiled :class:`~repro_torch.core.plans.TilePlan`):
``heuristic`` consults the plan before falling back to the default tile;
``tuned`` delegates to the autotuner, whose resolution order is already
cache -> plan -> sweep (an exact, possibly hardware-measured cache entry
must outrank an approximate plan resolution); ``robust`` ignores plans —
its contract is the fleet-wide worst-case minimum, which no
single-hardware plan entry can honor.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

from repro_torch.core import registry
from repro_torch.core.autotuner import Autotuner
from repro_torch.core.cost_model import estimate
from repro_torch.core.hardware import PRODUCTION_TARGET, HardwareModel
from repro_torch.core.plans import TilePlan
from repro_torch.core.tiling import TileShape, enumerate_tiles


@dataclasses.dataclass
class TilingPolicy:
    mode: str = "heuristic"                  # heuristic | tuned | robust
    hardware: HardwareModel = PRODUCTION_TARGET
    fleet: Sequence[HardwareModel] = ()      # for robust mode
    autotuner: Optional[Autotuner] = None
    plans: Optional[TilePlan] = None         # compiled AOT plans, tried first

    def __post_init__(self):
        if self.mode not in ("heuristic", "tuned", "robust"):
            raise ValueError(f"unknown policy mode {self.mode!r}")
        if self.mode == "tuned":
            if self.autotuner is None:
                self.autotuner = Autotuner(plans=self.plans)
            elif self.autotuner.plans is None:
                self.autotuner.plans = self.plans
        if self.mode == "robust" and not self.fleet:
            raise ValueError("robust mode requires a hardware fleet")

    def tile_for(
        self, kernel: str, problem: Mapping[str, int], dtype: str = "bfloat16"
    ) -> TileShape:
        spec = registry.get(kernel)
        if self.mode == "heuristic":
            if self.plans is not None:
                res = self.plans.resolve(kernel, problem, dtype,
                                         self.hardware)
                if res is not None:
                    return res.tile
            return spec.default_tile(problem, dtype)
        if self.mode == "tuned":
            # The autotuner already resolves cache -> plan -> sweep; going
            # through it keeps an exact (possibly measured) cache entry from
            # being shadowed by an approximate plan resolution.
            return self.autotuner.best_tile(kernel, problem, dtype, self.hardware)
        # Robust mode ignores plans: a single-hardware plan entry (or a
        # transfer) would silently replace the fleet worst-case minimum.
        return self._robust_tile(spec, problem, dtype)

    def _robust_tile(self, spec, problem, dtype) -> TileShape:
        # Candidate set: union of legal tiles on every fleet member (a tile
        # must be legal everywhere to be a fleet-wide default).
        per_hw = []
        for hw in self.fleet:
            constraints = spec.constraints(problem)
            tiles = enumerate_tiles(
                constraints, hw, dtype,
                vmem_bytes_fn=lambda t: spec.vmem_bytes(t, problem, dtype),
            )
            per_hw.append(set(tiles))
        common = set.intersection(*per_hw) if per_hw else set()
        if not common:
            raise ValueError("no tile legal on every fleet member")
        best_tile, best_worst = None, float("inf")
        for t in sorted(common):
            worst = 0.0
            for hw in self.fleet:
                work = spec.workload(t, problem, dtype)
                cost = estimate(
                    hw, work, spec.n_tiles(t, problem),
                    vmem_bytes=spec.vmem_bytes(t, problem, dtype),
                )
                worst = max(worst, cost.total_s)
            if worst < best_worst:
                best_worst, best_tile = worst, t
        return best_tile

