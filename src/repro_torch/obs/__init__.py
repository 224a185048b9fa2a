"""Observability of the port: the serving stack's flight recorder.

``repro_torch.obs.trace`` records request-lifecycle spans, per-step engine
spans, plan-decision audit instants and scheduler queue events against an
injected clock (virtual-clock runs trace deterministically);
``repro_torch.obs.export`` emits the Chrome-trace/Perfetto JSON and JSONL
files the ``python -m repro_torch.launch.trace_report`` CLI reads. Both
are the reference's (``repro/obs``), schema version included.
"""
from repro_torch.obs.export import (
    load_trace,
    to_chrome,
    write_jsonl,
    write_trace,
)
from repro_torch.obs.trace import (
    TRACE_SCHEMA_VERSION,
    ProcTrace,
    Tracer,
)

__all__ = [
    "TRACE_SCHEMA_VERSION", "Tracer", "ProcTrace",
    "to_chrome", "write_trace", "write_jsonl", "load_trace",
]
