"""Trace exporters: Chrome-trace/Perfetto JSON and JSONL (the port's copy
of ``repro/obs/export.py``; the files are the reference's).

Both formats serialize with sorted keys and compact separators so two
identical virtual-clock runs write **byte-identical** files (CPython's
float repr is deterministic, and the tracer's event order is the
engines' deterministic execution order).

Chrome-trace mapping: each attached process becomes a Perfetto process
row (``process_name`` metadata carries the engine name and hardware),
each lane becomes a named thread row, timestamps convert from clock
seconds to microseconds. Load the file at https://ui.perfetto.dev or
``chrome://tracing``.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List

from repro_torch.obs.trace import TRACE_SCHEMA_VERSION, Tracer, lane_name

_US = 1e6


def to_chrome(tracer: Tracer) -> Dict[str, Any]:
    """Render the tracer's events as a Chrome-trace (Perfetto) dict."""
    tracer.flush()
    events: List[Dict[str, Any]] = []
    lanes_seen: Dict[int, set] = {}
    for proc in tracer.procs:
        args = {"name": proc["name"]}
        if proc.get("hardware"):
            args["name"] = f"{proc['name']} [{proc['hardware']}]"
        events.append({"ph": "M", "name": "process_name", "pid": proc["pid"],
                       "tid": 0, "ts": 0, "args": args})
        events.append({"ph": "M", "name": "process_sort_index",
                       "pid": proc["pid"], "tid": 0, "ts": 0,
                       "args": {"sort_index": proc["pid"]}})
        lanes_seen[proc["pid"]] = set()
    for ev in tracer.events:
        lanes_seen.setdefault(ev["pid"], set()).add(ev["tid"])
        out: Dict[str, Any] = {
            "ph": ev["ph"], "name": ev["name"], "cat": ev["cat"],
            "pid": ev["pid"], "tid": ev["tid"], "ts": ev["ts"] * _US,
        }
        if ev["ph"] == "i":
            out["s"] = "t"  # thread-scoped instant
        if ev["ph"] in ("b", "e"):
            # Async events need an id; rid is unique per process.
            out["id"] = (ev.get("args") or {}).get("id", 0)
        if "dur" in ev:
            out["dur"] = ev["dur"] * _US
        if "args" in ev:
            out["args"] = ev["args"]
        events.append(out)
    for pid in sorted(lanes_seen):
        for tid in sorted(lanes_seen[pid]):
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "ts": 0,
                           "args": {"name": lane_name(tid)}})
            events.append({"ph": "M", "name": "thread_sort_index", "pid": pid,
                           "tid": tid, "ts": 0, "args": {"sort_index": tid}})
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"trace_schema": TRACE_SCHEMA_VERSION},
    }


def write_trace(tracer: Tracer, path: str) -> None:
    """Write Chrome-trace JSON. Deterministic byte-for-byte for
    deterministic-clock runs."""
    doc = to_chrome(tracer)
    with open(path, "w") as f:
        json.dump(doc, f, sort_keys=True, separators=(",", ":"))
        f.write("\n")


def write_jsonl(tracer: Tracer, path: str) -> None:
    """Write raw events (seconds, uncooked) one JSON object per line,
    preceded by one header line and the process table."""
    tracer.flush()
    with open(path, "w") as f:
        f.write(json.dumps({"trace_schema": TRACE_SCHEMA_VERSION},
                           sort_keys=True, separators=(",", ":")) + "\n")
        for proc in tracer.procs:
            f.write(json.dumps({"proc": proc}, sort_keys=True,
                               separators=(",", ":")) + "\n")
        for ev in tracer.events:
            f.write(json.dumps(ev, sort_keys=True,
                               separators=(",", ":")) + "\n")


def load_trace(path: str) -> Dict[str, Any]:
    """Load a trace written by :func:`write_trace` or :func:`write_jsonl`
    back into ``{"procs": [...], "events": [...]}`` with timestamps in
    seconds — the form ``trace_report`` analyzes."""
    with open(path) as f:
        text = f.read()
    try:
        # One JSON document = the Chrome-trace form. JSONL falls through:
        # its extra lines make this raise.
        return _from_chrome(json.loads(text))
    except json.JSONDecodeError:
        pass
    procs: List[Dict[str, Any]] = []
    events: List[Dict[str, Any]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        obj = json.loads(line)
        if "proc" in obj:
            procs.append(obj["proc"])
        elif "ph" in obj:
            events.append(obj)
    return {"procs": procs, "events": events}


def _from_chrome(doc: Dict[str, Any]) -> Dict[str, Any]:
    procs: Dict[int, Dict[str, Any]] = {}
    events: List[Dict[str, Any]] = []
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") == "M":
            if ev.get("name") == "process_name":
                # to_chrome renders "name [hardware]"; split it back.
                name, hardware = ev["args"]["name"], None
                if name.endswith("]") and " [" in name:
                    name, _, hw = name.rpartition(" [")
                    hardware = hw[:-1]
                procs[ev["pid"]] = {"pid": ev["pid"], "name": name,
                                    "hardware": hardware}
            continue
        out = dict(ev)
        out["ts"] = ev["ts"] / _US
        if "dur" in ev:
            out["dur"] = ev["dur"] / _US
        out.pop("s", None)
        events.append(out)
    return {"procs": [procs[k] for k in sorted(procs)], "events": events}
