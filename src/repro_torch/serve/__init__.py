"""Serving layer of the port: the engine, schedulers, metrics, the paged
KV pool."""
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.pool import PagedKVPool, supports_prefix_sharing
from repro_torch.serve.scheduler import (
    BucketPolicy, FifoScheduler, ShapeBucketScheduler, make_scheduler,
)

__all__ = ["BucketPolicy", "FifoScheduler", "PagedKVPool", "Request",
           "ServeEngine", "ServeMetrics", "ShapeBucketScheduler",
           "make_scheduler", "supports_prefix_sharing"]
