"""Serving layer of the port: the engine, schedulers, metrics, the paged
KV pool, and plan refinement from shadow measurements."""
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.pool import PagedKVPool, supports_prefix_sharing
from repro_torch.serve.refine import (
    PlanRefiner, drift_report, make_shadow_measure,
)
from repro_torch.serve.scheduler import (
    BucketPolicy, FifoScheduler, ShapeBucketScheduler, make_scheduler,
)

__all__ = ["BucketPolicy", "FifoScheduler", "PagedKVPool", "PlanRefiner",
           "Request", "ServeEngine", "ServeMetrics", "ShapeBucketScheduler",
           "drift_report", "make_scheduler", "make_shadow_measure",
           "supports_prefix_sharing"]
