"""Ahead-of-time tile plans: compile once per hardware fleet, resolve anywhere.

The port's copy of ``repro/core/plans.py``, reading and writing the same
schema-v3 JSON artifact (an artifact compiled by either package loads in the
other). The paper's central result is that the best tile on one GPU model is
not the best on another, so tuning is per hardware model; this module does
it ahead of time:

* :func:`compile_plan` sweeps a set of ``(kernel, problem, dtype, hardware)``
  jobs and records, per cell, the best tile *and* the full sensitivity curve
  (every candidate's score). With a wall-clock ``measure_fn`` (on the H100,
  ``repro_torch.launch.measure``) the best candidates are timed on the card
  and the entry is marked ``measured``.
* :class:`TilePlan` is the portable artifact. Loading validates the schema; a
  corrupt or stale artifact degrades to "no plan" rather than crashing.
* :meth:`TilePlan.resolve` is the run-time lookup: **exact** hit, then the
  **nearest_shape** on the same hardware (donor tile clamped and
  legality-checked), then a **cross_hardware** transfer among the port's
  descriptors, re-ranked with the target's cost model and flagged with a
  :class:`PlanTransferWarning`.

Unlike the reference, :func:`compile_plan` skips only a cell with no legal
tile: an error raised while building, launching or timing a kernel ends the
compile, so a measured artifact never hides a kernel that failed.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import warnings
from typing import Dict, Iterable, List, Mapping, Optional, Tuple, Union

from repro_torch.core import registry
from repro_torch.core.cost_model import estimate
from repro_torch.core.hardware import HardwareModel
from repro_torch.core.hardware import get as get_hardware
from repro_torch.core.tiling import TileShape

log = logging.getLogger("repro_torch.plans")

# The reference's schema history: v1 -> v2 added the ``packed_prefill``
# serving cells, v2 -> v3 refinement provenance (``meta["refined_from"]`` /
# ``meta["measurements"]``) and measured per-cell entries. Versions in
# COMPAT_SCHEMA_VERSIONS still load (their entry layout is
# forward-compatible) with a :class:`PlanVersionWarning`; anything else is
# rejected: a stale artifact must not silently misconfigure tiles. The
# port's entries add an optional ``measured`` flag, which the reference's
# loader ignores.
PLAN_SCHEMA_VERSION = 3
COMPAT_SCHEMA_VERSIONS = (1, 2)


class PlanError(ValueError):
    """Base error for plan artifacts."""


class PlanSchemaError(PlanError):
    """Artifact exists but is not a valid plan (bad version / missing fields)."""


class PlanVersionWarning(UserWarning):
    """An artifact from an older (still-readable) schema version was loaded.

    The entries resolve fine, but the artifact predates cell families the
    current code expects (e.g. the packed_prefill serving cells), so those
    lookups fall back to heuristics — recompile with
    ``repro_torch.launch.compile_plans`` to silence this.
    """


class PlanTransferWarning(UserWarning):
    """A tile tuned on one hardware model was transferred to another.

    The paper's cross-model comparison shows transferred optima can be far
    from the true optimum; the resolution re-ranks with the target's cost
    model, but consumers should re-tune on the real hardware when possible.
    """


def problem_key(problem: Mapping[str, int]) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(problem.items()))


def plan_key(kernel: str, problem: Mapping[str, int], dtype: str,
             hardware: str) -> str:
    # Same layout as Autotuner._key so the two caches stay interchangeable.
    return f"{kernel}|{problem_key(problem)}|{dtype}|{hardware}"


# ---------------------------------------------------------------------------
# Artifact entries.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PlanEntry:
    """One compiled cell: the best tile plus its full sensitivity curve."""

    kernel: str
    hardware: str
    dtype: str
    problem: Tuple[Tuple[str, int], ...]      # sorted items (hashable)
    tile: TileShape
    score_s: float
    dominant: str                             # compute | memory | overhead
    sensitivity: float                        # worst/best over finite entries
    # ((dims...), score_s) ascending by score; [0] is the best tile.
    curve: Tuple[Tuple[Tuple[int, ...], float], ...] = ()
    measured: bool = False                    # score_s timed on the card

    @property
    def problem_dict(self) -> Dict[str, int]:
        return dict(self.problem)

    @property
    def key(self) -> str:
        return plan_key(self.kernel, self.problem_dict, self.dtype,
                        self.hardware)

    def to_dict(self) -> dict:
        return {
            "kernel": self.kernel,
            "hardware": self.hardware,
            "dtype": self.dtype,
            "problem": self.problem_dict,
            "tile": list(self.tile.dims),
            "score_s": self.score_s,
            "dominant": self.dominant,
            "sensitivity": self.sensitivity,
            "curve": [[list(dims), score] for dims, score in self.curve],
            "measured": self.measured,
        }

    @staticmethod
    def from_dict(d: Mapping) -> "PlanEntry":
        if not isinstance(d, Mapping):
            raise PlanSchemaError(
                f"plan entry must be an object, got {type(d).__name__}")
        required = ("kernel", "hardware", "dtype", "problem", "tile",
                    "score_s")
        for field in required:
            if field not in d:
                raise PlanSchemaError(f"plan entry missing field {field!r}")
        problem = d["problem"]
        if (not isinstance(problem, Mapping)
                or not all(isinstance(v, int) for v in problem.values())):
            raise PlanSchemaError(f"bad problem in plan entry: {problem!r}")
        tile = d["tile"]
        if (not isinstance(tile, (list, tuple)) or not tile
                or not all(isinstance(x, int) and x > 0 for x in tile)):
            raise PlanSchemaError(f"bad tile in plan entry: {tile!r}")
        try:
            curve = []
            for point in d.get("curve", ()):
                dims, score = point
                curve.append((tuple(int(x) for x in dims), float(score)))
            return PlanEntry(
                kernel=str(d["kernel"]),
                hardware=str(d["hardware"]),
                dtype=str(d["dtype"]),
                problem=tuple(sorted(problem.items())),
                tile=TileShape(tuple(int(x) for x in tile)),
                score_s=float(d["score_s"]),
                dominant=str(d.get("dominant", "")),
                sensitivity=float(d.get("sensitivity", 1.0)),
                curve=tuple(curve),
                measured=bool(d.get("measured", False)),
            )
        except (TypeError, ValueError) as e:
            # Field coercion failed: a malformed artifact must surface as a
            # schema error so load_or_none degrades instead of crashing.
            raise PlanSchemaError(f"malformed plan entry: {e}") from e


@dataclasses.dataclass(frozen=True)
class PlanResolution:
    """How a tile request was satisfied by the plan store."""

    tile: TileShape
    source: str                    # exact | nearest_shape | cross_hardware
    entry: PlanEntry               # the donor entry
    score_s: float                 # (re-)estimated score on the target hw
    distance: float = 0.0          # problem-shape distance (0 for exact)
    donor_hardware: Optional[str] = None   # set for cross_hardware


# ---------------------------------------------------------------------------
# Resolution helpers.
# ---------------------------------------------------------------------------

def _shape_distance(a: Mapping[str, int], b: Mapping[str, int]) -> Optional[float]:
    """Log-space L1 distance between two problems; None if incomparable."""
    if set(a) != set(b):
        return None
    return sum(
        abs(math.log2(max(a[k], 1) / max(b[k], 1))) for k in a
    )


def _fit_tile(tile: TileShape, kernel: str, problem: Mapping[str, int],
              dtype: str, hw: HardwareModel) -> Optional[TileShape]:
    """Clamp a donor tile to the target problem and legality-check it."""
    try:
        spec = registry.get(kernel)
    except KeyError:
        return tile  # unknown kernel: trust the donor dims as-is
    constraints = spec.constraints(problem)
    if len(tile) != constraints.rank:
        return None
    fitted = TileShape(tuple(
        min(d, m) for d, m in zip(tile.dims, constraints.max_dims)
    ))
    budget = hw.vmem_bytes * constraints.vmem_fraction
    if spec.vmem_bytes(fitted, problem, dtype) > budget:
        return None
    return fitted


def _rescore(kernel: str, tile: TileShape, problem: Mapping[str, int],
             dtype: str, hw: HardwareModel) -> float:
    """Cost-model score of a tile on a (possibly different) hardware model."""
    try:
        spec = registry.get(kernel)
        cost = estimate(
            hw, spec.workload(tile, problem, dtype), spec.n_tiles(tile, problem),
            vmem_bytes=spec.vmem_bytes(tile, problem, dtype),
        )
        return cost.total_s
    except (KeyError, ValueError):
        return math.inf


def score_tile(kernel: str, tile: TileShape, problem: Mapping[str, int],
               dtype: str, hw: HardwareModel) -> float:
    """Public cost-model score of one tile on one hardware model (seconds).

    Used by consumers that need a comparable score for cells the plan could
    not resolve (e.g. the fleet router pricing a heuristic-default tile);
    returns +inf when the kernel is unknown or the tile is illegal.
    """
    return _rescore(kernel, tile, problem, dtype, hw)


# ---------------------------------------------------------------------------
# The portable plan artifact.
# ---------------------------------------------------------------------------

class TilePlan:
    """A set of compiled :class:`PlanEntry` cells plus artifact metadata."""

    def __init__(self, entries: Iterable[PlanEntry] = (),
                 meta: Optional[Mapping] = None):
        self._entries: Dict[str, PlanEntry] = {}
        self.meta: Dict = dict(meta or {})
        for e in entries:
            self.add(e)

    # -- container ----------------------------------------------------------
    def add(self, entry: PlanEntry) -> None:
        self._entries[entry.key] = entry

    def entries(self) -> List[PlanEntry]:
        return list(self._entries.values())

    def __len__(self) -> int:
        return len(self._entries)

    def kernels(self) -> List[str]:
        return sorted({e.kernel for e in self._entries.values()})

    def hardware_names(self) -> List[str]:
        return sorted({e.hardware for e in self._entries.values()})

    # -- lookup -------------------------------------------------------------
    def lookup(self, kernel: str, problem: Mapping[str, int], dtype: str,
               hardware: str) -> Optional[PlanEntry]:
        return self._entries.get(plan_key(kernel, problem, dtype, hardware))

    def resolve(
        self,
        kernel: str,
        problem: Mapping[str, int],
        dtype: str,
        hw: Union[HardwareModel, str],
        allow_nearest: bool = True,
        allow_transfer: bool = True,
        transfer_candidates: int = 8,
    ) -> Optional[PlanResolution]:
        """Lookup-then-fallback tile resolution. Never sweeps.

        Order: exact hit -> nearest problem shape on the same hardware ->
        cross-hardware transfer re-ranked with the target's cost model (with
        a :class:`PlanTransferWarning`). Returns None when the plan has
        nothing usable — callers fall back to heuristics or a sweep.
        """
        hw_model = get_hardware(hw) if isinstance(hw, str) else hw
        problem = dict(problem)

        entry = self.lookup(kernel, problem, dtype, hw_model.name)
        if entry is not None:
            return PlanResolution(entry.tile, "exact", entry, entry.score_s)

        pool = [e for e in self._entries.values()
                if e.kernel == kernel and e.dtype == dtype]

        if allow_nearest:
            res = self._nearest_shape(pool, kernel, problem, dtype, hw_model)
            if res is not None:
                return res

        if allow_transfer:
            res = self._transfer(pool, kernel, problem, dtype, hw_model,
                                 transfer_candidates)
            if res is not None:
                return res
        return None

    def _nearest_shape(self, pool, kernel, problem, dtype,
                       hw: HardwareModel) -> Optional[PlanResolution]:
        ranked = []
        for e in pool:
            if e.hardware != hw.name:
                continue
            dist = _shape_distance(e.problem_dict, problem)
            if dist is not None:
                ranked.append((dist, e.key, e))
        for dist, _, e in sorted(ranked):
            # Walk the donor's curve best-first until a tile fits the target.
            for dims, _score in ((tuple(e.tile.dims), e.score_s), *e.curve):
                tile = _fit_tile(TileShape(tuple(dims)), kernel, problem,
                                 dtype, hw)
                if tile is None:
                    continue
                score = _rescore(kernel, tile, problem, dtype, hw)
                if math.isfinite(score):
                    log.info(
                        "plan %s/%s: nearest-shape hit from %s (distance %.2f)",
                        kernel, hw.name, problem_key(e.problem_dict), dist,
                    )
                    return PlanResolution(tile, "nearest_shape", e, score,
                                          distance=dist)
        return None

    def _transfer(self, pool, kernel, problem, dtype, hw: HardwareModel,
                  transfer_candidates: int) -> Optional[PlanResolution]:
        pk = problem_key(problem)
        donors = [e for e in pool if e.hardware != hw.name]
        exact_problem = [e for e in donors
                         if problem_key(e.problem_dict) == pk]
        if exact_problem:
            ranked = [(0.0, e.key, e) for e in exact_problem]
        else:
            ranked = []
            for e in donors:
                dist = _shape_distance(e.problem_dict, problem)
                if dist is not None:
                    ranked.append((dist, e.key, e))
        ranked.sort()
        min_dist = ranked[0][0] if ranked else 0.0
        best: Optional[Tuple[float, TileShape, PlanEntry, float]] = None
        for dist, _, e in ranked:
            if best is not None and dist > min_dist:
                # All equally-near donors have been scored; don't dilute the
                # re-rank with farther-away problem shapes.
                break
            # Re-rank the donor's top candidates with the TARGET's cost
            # model — the donor's ordering is exactly what the paper shows
            # cannot be trusted across models.
            candidates = ((tuple(e.tile.dims), e.score_s),
                          *e.curve[:transfer_candidates])
            for dims, _score in candidates:
                tile = _fit_tile(TileShape(tuple(dims)), kernel, problem,
                                 dtype, hw)
                if tile is None:
                    continue
                score = _rescore(kernel, tile, problem, dtype, hw)
                if math.isfinite(score) and (best is None or score < best[0]):
                    best = (score, tile, e, dist)
        if best is None:
            return None
        score, tile, entry, dist = best
        msg = (
            f"tile plan for {kernel} ({problem_key(problem)}, {dtype}) "
            f"transferred from {entry.hardware} to {hw.name}: tile {tile} "
            f"re-ranked with the {hw.name} cost model. Per-model optima are "
            f"not portable (paper Fig. 3) — re-tune on {hw.name} to remove "
            f"this warning."
        )
        warnings.warn(PlanTransferWarning(msg), stacklevel=3)
        log.warning("%s", msg)
        return PlanResolution(tile, "cross_hardware", entry, score,
                              distance=dist, donor_hardware=entry.hardware)

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "schema_version": PLAN_SCHEMA_VERSION,
            "meta": self.meta,
            "entries": [e.to_dict() for e in self._entries.values()],
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "TilePlan":
        if not isinstance(d, Mapping):
            raise PlanSchemaError(f"plan artifact must be an object, got "
                                  f"{type(d).__name__}")
        version = d.get("schema_version")
        if version in COMPAT_SCHEMA_VERSIONS:
            msg = (
                f"loading plan artifact with old schema version {version} "
                f"(current {PLAN_SCHEMA_VERSION}): entries resolve, but "
                f"features added since (packed_prefill serving cells in v2, "
                f"refinement provenance in v3) are missing and degrade to "
                f"heuristics — recompile with repro_torch.launch.compile_plans"
            )
            warnings.warn(PlanVersionWarning(msg), stacklevel=3)
            log.warning("%s", msg)
        elif version != PLAN_SCHEMA_VERSION:
            raise PlanSchemaError(
                f"plan schema version {version!r} unsupported "
                f"(expected {PLAN_SCHEMA_VERSION}, compat "
                f"{COMPAT_SCHEMA_VERSIONS}); recompile with "
                f"repro_torch.launch.compile_plans"
            )
        entries = d.get("entries")
        if not isinstance(entries, list):
            raise PlanSchemaError("plan artifact missing 'entries' list")
        return cls(entries=[PlanEntry.from_dict(e) for e in entries],
                   meta=d.get("meta") or {})

    def save(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, indent=1, sort_keys=True)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "TilePlan":
        """Load and validate; raises PlanError on any problem."""
        try:
            with open(path) as f:
                data = json.load(f)
        except OSError as e:
            raise PlanError(f"cannot read plan artifact {path}: {e}") from e
        except json.JSONDecodeError as e:
            raise PlanSchemaError(
                f"plan artifact {path} is not valid JSON: {e}") from e
        return cls.from_dict(data)

    @classmethod
    def load_or_none(cls, path: Optional[str]) -> Optional["TilePlan"]:
        """Corrupt-file-tolerant load: log and return None instead of raising."""
        if not path:
            return None
        try:
            return cls.load(path)
        except PlanError as e:
            log.warning("ignoring unusable tile-plan artifact %s: %s", path, e)
            return None


# ---------------------------------------------------------------------------
# Compilation (the ahead-of-time sweep).
# ---------------------------------------------------------------------------

# (kernel, problem, dtype, hardware) — one cell to compile.
PlanJob = Tuple[str, Mapping[str, int], str, HardwareModel]


def compile_entry(
    kernel: str,
    problem: Mapping[str, int],
    dtype: str,
    hw: HardwareModel,
    autotuner=None,
    max_candidates: int = 256,
    curve_cap: Optional[int] = None,
    measure_fn=None,
) -> PlanEntry:
    """Sweep one cell and package the result as a :class:`PlanEntry`.

    ``curve_cap`` keeps only the best N points of the score-sorted curve.
    ``measure_fn`` (tile -> seconds, see ``launch.measure``) adds wall-clock
    timing of the analytically-best candidates; measured scores outrank
    analytic ones in the sweep's ``best`` selection.
    """
    from repro_torch.core.autotuner import Autotuner, NoLegalTileError

    if autotuner is None:
        autotuner = Autotuner()
    result = autotuner.sweep(kernel, problem, dtype, hw,
                             max_candidates=max_candidates,
                             measure_fn=measure_fn)
    best = result.best
    if not math.isfinite(best.score):
        raise NoLegalTileError(
            f"no feasible tile for {kernel} {problem_key(problem)} on {hw.name}"
        )
    curve = sorted(
        ((tuple(e.tile.dims), e.score) for e in result.entries
         if math.isfinite(e.score)),
        key=lambda p: p[1],
    )
    if curve_cap is not None:
        curve = curve[:curve_cap]
    return PlanEntry(
        kernel=kernel,
        hardware=hw.name,
        dtype=dtype,
        problem=tuple(sorted(dict(problem).items())),
        tile=best.tile,
        score_s=best.score,
        dominant=best.cost.dominant(),
        sensitivity=result.sensitivity(),
        curve=tuple(curve),
        measured=best.measured_s is not None,
    )


def compile_plan(
    jobs: Iterable[PlanJob],
    autotuner=None,
    max_candidates: int = 256,
    curve_cap: Optional[int] = None,
    meta: Optional[Mapping] = None,
    measure_fn_factory=None,
) -> TilePlan:
    """Compile every job into a :class:`TilePlan`.

    A cell with no legal tile is skipped with a log line and counted in
    ``meta["skipped_jobs"]``; any other error (an unregistered kernel, a
    kernel that fails to build, launch or time) propagates and ends the
    compile. ``measure_fn_factory(kernel, problem, dtype, hw)`` may return
    a wall-clock MeasureFn per cell (or None for analytic) — see
    ``repro_torch.launch.measure.make_measure_fn``.
    """
    from repro_torch.core.autotuner import NoLegalTileError

    plan = TilePlan(meta=meta)
    skipped = 0
    measured = 0
    for kernel, problem, dtype, hw in jobs:
        measure_fn = (measure_fn_factory(kernel, problem, dtype, hw)
                      if measure_fn_factory is not None else None)
        measured += measure_fn is not None
        try:
            entry = compile_entry(kernel, problem, dtype, hw,
                                  autotuner=autotuner,
                                  max_candidates=max_candidates,
                                  curve_cap=curve_cap,
                                  measure_fn=measure_fn)
        except NoLegalTileError as e:
            skipped += 1
            log.info("plan compile: skipping %s on %s: %s", kernel, hw.name, e)
            continue
        plan.add(entry)
    plan.meta["kernels"] = plan.kernels()
    plan.meta["hardware"] = plan.hardware_names()
    plan.meta["skipped_jobs"] = skipped
    if measure_fn_factory is not None:
        plan.meta["measured_jobs"] = measured
    return plan
