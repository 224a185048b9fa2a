"""Trace analysis / regression-diff CLI for serving traces.

Usage::

    # Summarize one trace: per-request waterfall, plan-source attribution,
    # pack-occupancy summary, autoscale decision log.
    python -m repro_torch.launch.trace_report trace.json

    # Regression diff: BASE then CANDIDATE. Exits nonzero when the
    # candidate's pooled p95 TTFT regresses past --ttft-tol x the base's,
    # or its packed-step occupancy drops below base / --occupancy-tol.
    python -m repro_torch.launch.trace_report base.json candidate.json --diff

The port's copy of ``repro/launch/trace_report.py``. Traces come from
``python -m repro_torch.launch.serve --trace-out`` (or any file of the same
schema, the reference's launcher and benches included) in Chrome-trace
JSON or JSONL form — see :mod:`repro_torch.obs.trace` for the event
vocabulary this report reads and :mod:`repro_torch.obs.export` for the
formats. The TTFT statistics here use the same nearest-rank percentile over the trace's ``ttft`` span durations that
:class:`~repro_torch.serve.metrics.ServeMetrics` uses over its samples, so a
trace reproduces the engine's reported percentiles exactly.

Exit codes: 0 ok / no regression; 1 threshold breach in ``--diff``;
2 usage or unreadable trace.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from typing import Any, Dict, List, Optional

from repro_torch.obs.export import load_trace
from repro_torch.serve.metrics import nearest_rank


def _proc_names(trace: Dict[str, Any]) -> Dict[int, str]:
    return {p["pid"]: p["name"] for p in trace.get("procs", [])}


def _args(ev: Dict[str, Any]) -> Dict[str, Any]:
    return ev.get("args") or {}


def waterfall(trace: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Per-request lifecycle rows, ordered by (process, submit time, rid)."""
    rows: Dict[tuple, Dict[str, Any]] = {}

    def row(pid: int, rid: Any) -> Dict[str, Any]:
        return rows.setdefault((pid, rid), {
            "pid": pid, "rid": rid, "bucket": None, "submit": None,
            "wait_s": None, "chunks": 0, "packed_chunks": 0,
            "ttft_s": None, "finish": None, "tokens": None,
        })

    for ev in trace["events"]:
        name, a = ev.get("name"), _args(ev)
        if name == "submit":
            r = row(ev["pid"], a.get("rid"))
            r["submit"] = ev["ts"]
            r["bucket"] = a.get("bucket")
        elif name == "admit":
            row(ev["pid"], a.get("rid"))["wait_s"] = a.get("wait_s")
        elif name == "chunk":
            r = row(ev["pid"], a.get("rid"))
            r["chunks"] += 1
            r["packed_chunks"] += 1 if a.get("pack_n", 1) > 1 else 0
        elif name == "ttft":
            r = row(ev["pid"], a.get("rid"))
            r["ttft_s"] = ev.get("dur", 0.0)
            if r["bucket"] is None:
                r["bucket"] = a.get("bucket")
        elif name == "finish":
            r = row(ev["pid"], a.get("rid"))
            r["finish"] = ev["ts"]
            r["tokens"] = a.get("tokens")
    ordered = sorted(rows.values(), key=lambda r: (
        r["pid"], r["submit"] if r["submit"] is not None else float("inf"),
        str(r["rid"])))
    return ordered


def plan_attribution(trace: Dict[str, Any]) -> List[Dict[str, Any]]:
    """(process, phase, kernel, source) -> resolution count."""
    counts: Counter = Counter()
    for ev in trace["events"]:
        if ev.get("name") != "plan_resolve":
            continue
        a = _args(ev)
        counts[(ev["pid"], a.get("phase"), a.get("kernel"),
                a.get("source"))] += 1
    return [
        {"pid": pid, "phase": phase, "kernel": kernel, "source": source,
         "count": n}
        for (pid, phase, kernel, source), n in sorted(
            counts.items(), key=lambda kv: (kv[0][0], str(kv[0][1:])))
    ]


def pack_occupancy(trace: Dict[str, Any]) -> Dict[str, Any]:
    """Packed-chunks-per-step distribution over the trace's step spans."""
    hist: Counter = Counter()
    steps = prefill_steps = 0
    total_packed = 0
    for ev in trace["events"]:
        if ev.get("name") != "step":
            continue
        a = _args(ev)
        steps += 1
        packed = int(a.get("packed_chunks", 0) or 0)
        if packed:
            prefill_steps += 1
            total_packed += packed
            hist[packed] += 1
    return {
        "steps": steps,
        "prefill_steps": prefill_steps,
        "mean_packed_chunks": (total_packed / prefill_steps
                               if prefill_steps else 0.0),
        "histogram": {str(k): hist[k] for k in sorted(hist)},
    }


def autoscale_log(trace: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Autoscale decisions (the fleet lane's ``autoscale`` instants) in
    time order, each with its full signal snapshot."""
    out = []
    for ev in trace["events"]:
        if ev.get("name") != "autoscale":
            continue
        a = _args(ev)
        out.append({"ts": ev.get("ts"), "pid": ev["pid"],
                    "action": a.get("action"), "instance": a.get("instance"),
                    "hardware": a.get("hardware"), "reason": a.get("reason"),
                    "signals": a.get("signals") or {}})
    out.sort(key=lambda d: (d["ts"] if d["ts"] is not None else 0.0,
                            str(d["instance"])))
    return out


def ttft_values(trace: Dict[str, Any]) -> List[float]:
    """Every request's TTFT (the ``ttft`` span durations), pooled."""
    return [ev.get("dur", 0.0) for ev in trace["events"]
            if ev.get("name") == "ttft"]


def rejects(trace: Dict[str, Any]) -> Dict[str, int]:
    counts: Counter = Counter()
    for ev in trace["events"]:
        if ev.get("name") in ("reject", "route_reject"):
            counts[_args(ev).get("reason", "unknown")] += 1
    return {k: counts[k] for k in sorted(counts)}


def summarize(trace: Dict[str, Any]) -> Dict[str, Any]:
    ttfts = ttft_values(trace)
    return {
        "processes": _proc_names(trace),
        "requests": len({(r["pid"], r["rid"]) for r in waterfall(trace)}),
        "ttft": {
            "n": len(ttfts),
            "p50_s": nearest_rank(ttfts, 0.50),
            "p95_s": nearest_rank(ttfts, 0.95),
            "p99_s": nearest_rank(ttfts, 0.99),
        },
        "occupancy": pack_occupancy(trace),
        "rejects": rejects(trace),
        "autoscale": autoscale_log(trace),
    }


def render(trace: Dict[str, Any], max_rows: int = 20) -> str:
    names = _proc_names(trace)
    s = summarize(trace)
    lines = [
        f"trace: {len(trace['events'])} events, "
        f"{len(names)} processes, {s['requests']} requests",
        f"ttft: n={s['ttft']['n']} p50={s['ttft']['p50_s'] * 1e3:.2f}ms "
        f"p95={s['ttft']['p95_s'] * 1e3:.2f}ms "
        f"p99={s['ttft']['p99_s'] * 1e3:.2f}ms",
        f"pack occupancy: {s['occupancy']['prefill_steps']}/"
        f"{s['occupancy']['steps']} steps carried prefill, "
        f"mean {s['occupancy']['mean_packed_chunks']:.2f} chunks/step, "
        f"histogram {s['occupancy']['histogram']}",
    ]
    if s["rejects"]:
        lines.append(f"rejects: {s['rejects']}")

    lines.append("")
    lines.append("request waterfall (per process, by submit time):")
    lines.append(f"  {'proc':<14} {'rid':>5} {'bucket':>6} {'wait_ms':>8} "
                 f"{'chunks':>6} {'packed':>6} {'ttft_ms':>8} {'tokens':>6}")
    rows = waterfall(trace)
    for r in rows[:max_rows]:

        def ms(x: Optional[float]) -> str:
            return f"{x * 1e3:.2f}" if x is not None else "-"

        lines.append(
            f"  {names.get(r['pid'], r['pid']):<14} {str(r['rid']):>5} "
            f"{str(r['bucket']):>6} {ms(r['wait_s']):>8} "
            f"{r['chunks']:>6} {r['packed_chunks']:>6} "
            f"{ms(r['ttft_s']):>8} {str(r['tokens']):>6}")
    if len(rows) > max_rows:
        lines.append(f"  ... {len(rows) - max_rows} more "
                     f"(--max-rows to widen)")

    lines.append("")
    lines.append("plan-source attribution:")
    lines.append(f"  {'proc':<14} {'phase':<8} {'kernel':<22} "
                 f"{'source':<14} {'n':>4}")
    for row in plan_attribution(trace):
        lines.append(
            f"  {names.get(row['pid'], row['pid']):<14} "
            f"{str(row['phase']):<8} {str(row['kernel']):<22} "
            f"{str(row['source']):<14} {row['count']:>4}")

    scale = s["autoscale"]
    if scale:
        lines.append("")
        lines.append("autoscale decisions:")
        lines.append(f"  {'t_s':>10} {'action':<6} {'instance':<14} "
                     f"{'reason':<16} signals")
        for d in scale:
            sig = d["signals"]
            ttft = sig.get("p95_ttft")
            brief = (f"q/inst={sig.get('queue_per_instance')} "
                     f"p95={ttft * 1e3:.1f}ms " if ttft is not None else
                     f"q/inst={sig.get('queue_per_instance')} p95=- ")
            brief += (f"orphans={sig.get('orphans')} "
                      f"fleet={sig.get('instances')}")
            ts = f"{d['ts']:.3f}" if d["ts"] is not None else "-"
            lines.append(f"  {ts:>10} {str(d['action']):<6} "
                         f"{str(d['instance']):<14} {str(d['reason']):<16} "
                         f"{brief}")
    return "\n".join(lines)


def diff(base: Dict[str, Any], cand: Dict[str, Any],
         ttft_tol: float = 1.10, occupancy_tol: float = 1.10
         ) -> List[str]:
    """Regression breaches of ``cand`` against ``base`` (empty = clean).

    TTFT: candidate pooled p95 must not exceed ``ttft_tol`` x base p95.
    Occupancy: candidate mean packed-chunks-per-prefill-step must not drop
    below base / ``occupancy_tol`` (only checked when the base actually
    packed — an unpacked pair trivially passes).
    """
    breaches: List[str] = []
    b, c = summarize(base), summarize(cand)
    b95, c95 = b["ttft"]["p95_s"], c["ttft"]["p95_s"]
    if b["ttft"]["n"] and c["ttft"]["n"] and b95 > 0.0 \
            and c95 > ttft_tol * b95:
        breaches.append(
            f"ttft p95 regressed: {c95 * 1e3:.3f}ms vs base "
            f"{b95 * 1e3:.3f}ms (x{c95 / b95:.3f} > tol {ttft_tol})")
    b_occ = b["occupancy"]["mean_packed_chunks"]
    c_occ = c["occupancy"]["mean_packed_chunks"]
    if b_occ > 0.0 and c_occ < b_occ / occupancy_tol:
        breaches.append(
            f"pack occupancy regressed: {c_occ:.3f} chunks/step vs base "
            f"{b_occ:.3f} (x{c_occ / b_occ:.3f} < 1/tol {occupancy_tol})")
    return breaches


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.trace_report",
        description="Summarize a serving trace, or diff two for "
                    "TTFT/occupancy regressions.")
    ap.add_argument("trace", help="trace file (Chrome JSON or JSONL)")
    ap.add_argument("candidate", nargs="?", default=None,
                    help="candidate trace to diff against the first (base)")
    ap.add_argument("--diff", action="store_true",
                    help="diff mode: exit 1 when the candidate regresses")
    ap.add_argument("--ttft-tol", type=float, default=1.10,
                    help="allowed candidate/base p95-TTFT ratio "
                         "(default 1.10)")
    ap.add_argument("--occupancy-tol", type=float, default=1.10,
                    help="allowed base/candidate occupancy ratio "
                         "(default 1.10)")
    ap.add_argument("--json", action="store_true",
                    help="emit machine-readable JSON instead of text")
    ap.add_argument("--max-rows", type=int, default=20,
                    help="waterfall rows to print (default 20)")
    args = ap.parse_args(argv)

    if args.diff and args.candidate is None:
        print("--diff needs two traces: BASE CANDIDATE", file=sys.stderr)
        return 2
    try:
        base = load_trace(args.trace)
        cand = load_trace(args.candidate) if args.candidate else None
    except (OSError, ValueError, KeyError, json.JSONDecodeError) as e:
        print(f"cannot load trace: {e}", file=sys.stderr)
        return 2

    if args.diff:
        assert cand is not None
        breaches = diff(base, cand, ttft_tol=args.ttft_tol,
                        occupancy_tol=args.occupancy_tol)
        if args.json:
            print(json.dumps({"base": summarize(base),
                              "candidate": summarize(cand),
                              "breaches": breaches},
                             indent=1, sort_keys=True))
        else:
            print(f"base:      {args.trace}")
            print(f"candidate: {args.candidate}")
            for line in breaches:
                print(f"REGRESSION: {line}")
            if not breaches:
                print("no regression: candidate within thresholds")
        return 1 if breaches else 0

    if args.json:
        out: Dict[str, Any] = summarize(base)
        out["waterfall"] = waterfall(base)
        out["plan_attribution"] = plan_attribution(base)
        print(json.dumps(out, indent=1, sort_keys=True))
    else:
        print(render(base, max_rows=args.max_rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
