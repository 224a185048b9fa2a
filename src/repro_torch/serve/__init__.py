"""Serving layer of the port: the unchunked engine, schedulers, metrics."""
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.scheduler import (
    BucketPolicy, FifoScheduler, ShapeBucketScheduler, make_scheduler,
)

__all__ = ["BucketPolicy", "FifoScheduler", "Request", "ServeEngine",
           "ServeMetrics", "ShapeBucketScheduler", "make_scheduler"]
