"""Serving layer of the port: the engine, schedulers, metrics, the paged
KV pool, plan refinement from shadow measurements, and the fleet (router,
fault injection, autoscaling)."""
from repro_torch.serve.autoscale import (
    AutoscalePolicy, ScaleCandidate, ScaleDecision,
)
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.faults import (
    EngineFault, FaultEvent, FaultInjector, FaultScript,
)
from repro_torch.serve.fleet import (
    FleetExhausted, FleetRouter, RollDecision, RouteDecision,
)
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.pool import PagedKVPool, supports_prefix_sharing
from repro_torch.serve.refine import (
    PlanRefiner, drift_report, make_shadow_measure,
)
from repro_torch.serve.scheduler import (
    BucketPolicy, FifoScheduler, ShapeBucketScheduler, make_scheduler,
)

__all__ = ["AutoscalePolicy", "BucketPolicy", "EngineFault", "FaultEvent",
           "FaultInjector", "FaultScript", "FifoScheduler", "FleetExhausted",
           "FleetRouter", "PagedKVPool", "PlanRefiner", "Request",
           "RollDecision", "RouteDecision", "ScaleCandidate", "ScaleDecision",
           "ServeEngine", "ServeMetrics", "ShapeBucketScheduler",
           "drift_report", "make_scheduler", "make_shadow_measure",
           "supports_prefix_sharing"]
