"""The port's serving trace (``repro_torch.obs``, ``launch.trace_report``) on
the CPU, against the reference's (``tests/test_obs_trace.py``).

* The tracer core: deferred step spans, the ``ttft`` span, the Chrome and
  JSONL round trips and the Perfetto metadata — and the same ``Tracer``
  calls made through both packages export byte-identical files.
* ``ServeMetrics.ttft_window`` clipping (the ``roll_plans`` guard that
  reads it comes with the fleet).
* ``trace_report``: ``diff`` and the CLI give the reference's exit codes,
  and each package's report reads the other's files with the same summary.
* The engine: two virtual-clock runs export byte-identical traces; tracing
  on or off leaves tokens and metrics bit-identical; a disabled tracer is
  never called; and with the same requests, plan and virtual clock the
  port's engine records the JAX engine's event sequence (phase, name,
  category, lane, time, arguments) in the unchunked, chunked and packed
  modes. Two differences are normalised, and only these: a ``plan_resolve``
  of source ``fallback`` or ``no_plan`` names each package's own kernel
  default tile; and a paged step records its ``finish`` instants after
  its token readback, so the paged comparison is lane by lane (every
  lane's sequence equal; on the lifecycle lane a step's ``page_free``
  events, which sit on the pool lane, come before its ``finish`` events).
* On a live clock the trace's TTFT p95 equals the metrics' p95 exactly:
  the engine reads the clock once for both.

Both engines name the hardware ``geforce_8800gts`` (each package's
default target differs). The plan-backed comparison serves a plan of the smoke
serving cells on an engine of that name in both packages, so every cell
resolves exactly and both packages read the same artifact (the JAX
package's own specs hold no tile of these cells within the paper GPUs'
16 KB of shared memory, so its compiler gives an empty plan; the port's
compile is saved and loaded into both).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.core import HARDWARE_REGISTRY as JAX_HARDWARE  # noqa: E402
from repro.core.plans import TilePlan as JaxTilePlan  # noqa: E402
from repro.launch import trace_report as jax_report  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.obs import Tracer as JaxTracer  # noqa: E402
from repro.obs import write_jsonl as jax_write_jsonl  # noqa: E402
from repro.obs import write_trace as jax_write_trace  # noqa: E402
from repro.serve import BucketPolicy as JaxBucketPolicy  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro.serve import ShapeBucketScheduler as JaxBucketScheduler  # noqa: E402
from repro_torch import configs, kernels  # noqa: E402
from repro_torch.core import (GEFORCE_8800GTS, TilePlan,  # noqa: E402
                              compile_plan, registry)
from repro_torch.launch import trace_report  # noqa: E402
from repro_torch.launch.compile_plans import serve_bucket_cells  # noqa: E402
from repro_torch.launch.trace_report import diff, main as report_main  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.obs import Tracer, load_trace, write_jsonl, write_trace  # noqa: E402
from repro_torch.obs.trace import LANE_LIFECYCLE, LANE_STEPS  # noqa: E402
from repro_torch.serve import (BucketPolicy, ServeEngine,  # noqa: E402
                               ShapeBucketScheduler)
from repro_torch.serve.metrics import (  # noqa: E402
    ServeMetrics, _LatencyStat, nearest_rank,
)

EDGES = (8, 64)
NEW_TOKENS = 3
MODES = ("unchunked", "chunked", "packed")


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# --------------------------------------------------------------------------
# Tracer core
# --------------------------------------------------------------------------

def test_deferred_step_spans_close_at_next_begin():
    clock = _Clock()
    tr = Tracer(clock=clock)
    p = tr.attach("eng")
    p.step_mark(0.0, {"prefill_tokens": 4}, 1)
    clock.t = 0.5
    p.step_mark(0.5, {"prefill_tokens": 0}, 2)
    spans = [e for e in tr.events if e["name"] == "step"]
    assert len(spans) == 1
    assert spans[0]["ts"] == 0.0 and spans[0]["dur"] == 0.5
    assert spans[0]["args"]["step"] == 1
    clock.t = 0.7
    tr.flush()
    spans = [e for e in tr.events if e["name"] == "step"]
    assert len(spans) == 2
    assert spans[1]["ts"] == 0.5 and abs(spans[1]["dur"] - 0.2) < 1e-12
    n = len(tr.events)
    tr.flush()
    assert len(tr.events) == n


def test_ttft_span_reproduces_metrics_sample():
    clock = _Clock()
    tr = Tracer(clock=clock)
    p = tr.attach("eng")
    clock.t = 1.25
    p.first_token(7, 64, 1.0)
    span = [e for e in tr.events if e["name"] == "ttft"][0]
    assert span["ts"] == 1.0 and span["dur"] == 0.25
    assert span["args"] == {"rid": 7, "bucket": 64}
    p.first_token(8, 64, None)
    assert len([e for e in tr.events if e["name"] == "ttft"]) == 1
    # An explicit time (the engine's one clock reading) ends the span there.
    p.first_token(9, 64, 1.0, now=1.5)
    span = [e for e in tr.events if e["name"] == "ttft"][-1]
    assert span["dur"] == 0.5
    assert [e["ts"] for e in tr.events if e["name"] == "first_token"] \
        == [1.25, 1.25, 1.5]


def _script(tr, clock):
    """One fixed sequence of tracer calls: every event method the engine
    and the pool make, on two processes."""
    p = tr.attach("engine-a", hardware="gtx260")
    q = tr.attach("refiner", kind="refiner")
    p.submit(1, 10, 8)
    p.queue_push(1, 8)
    p.queue_depth(1)
    clock.t = 0.5
    p.queue_pop(1, 8)
    p.admit(1, 10, 0.5)
    p.plan_resolve("prefill", "matmul", "k=64,m=8,n=128", (16, 64, 256),
                   "exact", 3)
    p.chunk(1, 1, 0.5, 0, 8, 2, 0.25)
    p.prefill(1, 0.5, 8)
    p.page_alloc(1, 2, 2, 16)
    p.prefix_hit(2, 8, 1)
    p.cow_split(2, 3, 4)
    p.pool_occupancy(3, 16)
    p.step_mark(0.5, {"prefill_tokens": 10, "packed_chunks": 2}, 1)
    clock.t = 1.0
    p.first_token(1, 8, 0.0)
    p.decode(0.75, [1, 2])
    p.shadow("flash_decode", "b=2,skv=80", (80,), (32,), 1e-5, 2e-5)
    p.plan_swap(3, {"entries": 5})
    q.refine_cell("kv_page", "skv=80", (80,), (32,), 1.25, 3)
    p.page_free(1, 2, 1, 16)
    p.finish(1, 3)
    p.reject("over_length", 99)
    clock.t = 1.5


def test_both_packages_export_byte_identical_files(tmp_path):
    """The same calls through either package's tracer: the same Chrome
    JSON and JSONL bytes (the schema version is the reference's)."""
    out = {}
    for name, tracer_cls, chrome, jsonl in (
            ("jax", JaxTracer, jax_write_trace, jax_write_jsonl),
            ("port", Tracer, write_trace, write_jsonl)):
        clock = _Clock()
        tr = tracer_cls(clock=clock)
        _script(tr, clock)
        chrome(tr, str(tmp_path / f"{name}.json"))
        jsonl(tr, str(tmp_path / f"{name}.jsonl"))
        out[name] = [(tmp_path / f"{name}.{ext}").read_bytes()
                     for ext in ("json", "jsonl")]
    assert out["jax"] == out["port"]
    assert len(load_trace(str(tmp_path / "port.jsonl"))["events"]) > 20


def _tiny_trace(tmp_path, name="t.json"):
    clock = _Clock()
    tr = Tracer(clock=clock)
    p = tr.attach("engine-a", hardware="h100_sxm")
    p.submit(1, 10, 8)
    clock.t = 0.5
    p.admit(1, 10, 0.5)
    p.step_mark(0.5, {"prefill_tokens": 10, "packed_chunks": 2}, 1)
    clock.t = 1.0
    p.first_token(1, 8, 0.0)
    p.finish(1, 3)
    path = str(tmp_path / name)
    write_trace(tr, path)
    return tr, path


def test_chrome_round_trip(tmp_path):
    tr, path = _tiny_trace(tmp_path)
    loaded = load_trace(path)
    assert loaded["procs"] == [{"pid": 1, "name": "engine-a",
                                "hardware": "h100_sxm"}]
    names = [e["name"] for e in loaded["events"]]
    for expected in ("submit", "admit", "step", "ttft", "finish", "req"):
        assert expected in names, f"{expected} lost in round-trip"
    ttft = [e for e in loaded["events"] if e["name"] == "ttft"][0]
    assert abs(ttft["ts"] - 0.0) < 1e-9 and abs(ttft["dur"] - 1.0) < 1e-9


def test_chrome_export_is_perfetto_shaped(tmp_path):
    _, path = _tiny_trace(tmp_path)
    doc = json.load(open(path))
    evs = doc["traceEvents"]
    meta = {(e["name"], e["pid"], e["tid"]) for e in evs if e["ph"] == "M"}
    assert ("process_name", 1, 0) in meta
    assert ("thread_name", 1, LANE_STEPS) in meta
    by_name = {}
    for e in evs:
        by_name.setdefault(e["name"], []).append(e)
    assert all(e.get("s") == "t" for e in by_name["submit"])
    assert {e["ph"] for e in by_name["req"]} == {"b", "e"}
    assert {e["id"] for e in by_name["req"]} == {1}
    assert doc["otherData"]["trace_schema"] == 1


def test_jsonl_round_trip(tmp_path):
    clock = _Clock()
    tr = Tracer(clock=clock)
    p = tr.attach("eng", kind="engine", hardware="gtx260")
    p.submit(3, 5, 8)
    clock.t = 0.25
    p.first_token(3, 8, 0.0)
    path = str(tmp_path / "t.jsonl")
    write_jsonl(tr, path)
    loaded = load_trace(path)
    assert loaded["procs"][0]["name"] == "eng"
    assert loaded["procs"][0]["hardware"] == "gtx260"
    ttft = [e for e in loaded["events"] if e["name"] == "ttft"][0]
    assert ttft["dur"] == 0.25


def test_ttft_window_flags_clipped_buffer():
    m = ServeMetrics(clock=lambda: 0.0)
    m.ttft[64] = _LatencyStat(sample_cap=4)
    for i in range(6):
        m.ttft[64].record(0.01 * (i + 1))
    samples, clipped = m.ttft_window()
    assert clipped and len(samples) == 4
    samples, clipped = m.ttft_window({64: 3})
    assert not clipped and len(samples) == 3
    assert samples == [0.04, 0.05, 0.06]
    assert m.ttft_p95({64: 3}) == nearest_rank(samples, 0.95)


# --------------------------------------------------------------------------
# trace_report + diff CLI
# --------------------------------------------------------------------------

def _trace_with_ttfts(tmp_path, name, durs, packed_steps=(), tracer=Tracer,
                      writer=write_trace):
    clock = _Clock()
    tr = tracer(clock=clock)
    p = tr.attach("eng")
    for i, d in enumerate(durs):
        clock.t = float(i) + d
        p.first_token(i, 64, float(i))
    for i, n in enumerate(packed_steps):
        p.step_mark(clock.t + i, {"packed_chunks": n}, i + 1)
    clock.t += len(packed_steps) + 1.0
    path = str(tmp_path / name)
    writer(tr, path)
    return path


def test_diff_flags_ttft_and_occupancy_regressions(tmp_path):
    base = load_trace(_trace_with_ttfts(
        tmp_path, "base.json", [0.01] * 10, packed_steps=[3, 3, 3]))
    slow = load_trace(_trace_with_ttfts(
        tmp_path, "slow.json", [0.10] * 10, packed_steps=[3, 3, 3]))
    sparse = load_trace(_trace_with_ttfts(
        tmp_path, "sparse.json", [0.01] * 10, packed_steps=[1, 1, 1]))
    assert diff(base, base) == []
    breaches = diff(base, slow)
    assert len(breaches) == 1 and "ttft p95" in breaches[0]
    breaches = diff(base, sparse)
    assert len(breaches) == 1 and "occupancy" in breaches[0]
    near = load_trace(_trace_with_ttfts(tmp_path, "near.json",
                                        [0.0105] * 10,
                                        packed_steps=[3, 3, 3]))
    assert diff(base, near) == []


def test_report_cli_exit_codes(tmp_path, capsys):
    base = _trace_with_ttfts(tmp_path, "base.json", [0.01] * 10)
    cand = _trace_with_ttfts(tmp_path, "cand.json", [0.10] * 10)
    for main in (report_main, jax_report.main):
        assert main([base]) == 0
        assert main([base, base, "--diff"]) == 0
        assert main([base, cand, "--diff"]) == 1
        assert main([cand, base, "--diff"]) == 0
        assert main([base, "--diff"]) == 2
        assert main([str(tmp_path / "missing.json")]) == 2
        capsys.readouterr()
        assert main([base, cand, "--diff", "--json"]) == 1
        out = json.loads(capsys.readouterr().out)
        assert out["breaches"] and out["base"]["ttft"]["n"] == 10


@pytest.mark.parametrize("ext", ["json", "jsonl"])
def test_each_report_reads_the_other_packages_files(tmp_path, ext):
    """A file either package writes, summarised by either package's
    report: the same summary, and the same render."""
    files = {}
    for name, tracer_cls, writer in (
            ("jax", JaxTracer,
             jax_write_trace if ext == "json" else jax_write_jsonl),
            ("port", Tracer, write_trace if ext == "json" else write_jsonl)):
        files[name] = _trace_with_ttfts(
            tmp_path, f"{name}.{ext}", [0.01 * (i + 1) for i in range(7)],
            packed_steps=[2, 1, 3], tracer=tracer_cls, writer=writer)
    for path in files.values():
        ours = trace_report.summarize(trace_report.load_trace(path))
        theirs = jax_report.summarize(jax_report.load_trace(path))
        assert ours == theirs
        # Chrome JSON keeps microseconds: seconds come back within 1e-12.
        assert ours["ttft"]["n"] == 7
        assert abs(ours["ttft"]["p95_s"] - 0.07) < 1e-12
        assert trace_report.render(load_trace(path)) == \
            jax_report.render(jax_report.load_trace(path))


# --------------------------------------------------------------------------
# The engine
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    cfg_j = jax_configs.get_smoke("qwen2-1.5b")
    cfg_t = configs.get_smoke("qwen2-1.5b")
    pj = jax_api.init_params(cfg_j, jax.random.PRNGKey(0))
    pt = params_from_jax(cfg_t, jax.tree.map(np.asarray, pj), device="cpu")
    return cfg_j, cfg_t, pj, pt


@pytest.fixture(scope="module")
def plan_path(tmp_path_factory):
    """A geforce_8800gts plan of the smoke serving cells, compiled by the
    port and saved for both packages to load."""
    kernels.register_all()
    cells = serve_bucket_cells(["qwen2-1.5b"], EDGES, slots=2,
                               max_len=max(EDGES) + 16, smoke=True)
    plan = compile_plan([(k, p, "float32", GEFORCE_8800GTS) for k, p in cells
                         if k in registry.names()])
    assert {e.kernel for e in plan.entries()} >= {
        "flash_attention", "flash_decode", "kv_page", "chunked_prefill",
        "packed_prefill"}
    path = tmp_path_factory.mktemp("plan") / "gts_plan.json"
    plan.save(str(path))
    return str(path)


def _prompts(n=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, 64, size=int(s)).astype(np.int32)
            for s in rng.integers(4, 40, size=n)]


def _engine_kw(mode, paged=False):
    return dict(max_len=max(EDGES) + 16, slots=2,
                chunk_prefill=mode != "unchunked",
                pack_prefill=mode == "packed", prefill_slots=3,
                step_token_budget=32 if mode != "unchunked" else 0,
                paged=paged, page_size=16 if paged else None)


def _drive(eng, clock, tracer):
    """The reference's drive: fixed arrivals on a virtual clock."""
    for i, prompt in enumerate(_prompts()):
        eng.add_request(prompt, max_new_tokens=NEW_TOKENS)
        if i % 3 == 2:
            eng.step()
            clock.t += 1e-3
    for _ in range(500):
        if not (eng.step() or eng.scheduler.pending()):
            break
        clock.t += 1e-3
    if tracer is not None:
        tracer.flush()
    return eng


def _drive_port(models, tracer, mode="packed", plan=None, paged=False,
                instance="eng"):
    _, cfg, _, params = models
    clock = _Clock()
    if tracer is not None:
        tracer.clock = clock
    eng = ServeEngine(
        cfg, params, device="cpu", clock=clock,
        scheduler=ShapeBucketScheduler(BucketPolicy(EDGES, max_queue=99)),
        plans=plan, hardware=GEFORCE_8800GTS,
        tracer=tracer, instance=instance, **_engine_kw(mode, paged))
    return _drive(eng, clock, tracer)


def _drive_jax(models, tracer, mode="packed", plan=None, paged=False,
               instance="eng"):
    cfg, _, params, _ = models
    clock = _Clock()
    tracer.clock = clock
    eng = JaxEngine(
        cfg, params, clock=clock,
        scheduler=JaxBucketScheduler(JaxBucketPolicy(EDGES, max_queue=99)),
        plans=plan, hardware=JAX_HARDWARE["geforce_8800gts"],
        tracer=tracer, instance=instance, **_engine_kw(mode, paged))
    return _drive(eng, clock, tracer)


def test_two_virtual_clock_runs_export_byte_identical(models, tmp_path):
    paths = []
    for run in ("a", "b"):
        tracer = Tracer()
        _drive_port(models, tracer)
        path = str(tmp_path / f"run_{run}.json")
        write_trace(tracer, path)
        paths.append(path)
    a, b = (open(p, "rb").read() for p in paths)
    assert a == b, "same seed-pinned virtual-clock run, different bytes"
    assert len(load_trace(paths[0])["events"]) > 0


@pytest.mark.parametrize("mode", MODES + ("paged",))
def test_tracing_on_off_leaves_service_bit_identical(models, mode):
    kw = (dict(mode="chunked", paged=True) if mode == "paged"
          else dict(mode=mode))
    eng_off = _drive_port(models, None, **kw)
    eng_on = _drive_port(models, Tracer(), **kw)
    tokens_off = {r.rid: tuple(r.out_tokens) for r in eng_off._finished}
    tokens_on = {r.rid: tuple(r.out_tokens) for r in eng_on._finished}
    assert tokens_on == tokens_off and tokens_off
    assert eng_on.metrics.as_dict() == eng_off.metrics.as_dict()


def test_disabled_tracing_makes_zero_tracer_calls(models, monkeypatch):
    calls = {"n": 0}
    real_record, real_defer = Tracer.record, Tracer.defer

    def counting_record(self, *a, **k):
        calls["n"] += 1
        return real_record(self, *a, **k)

    def counting_defer(self, *a, **k):
        calls["n"] += 1
        return real_defer(self, *a, **k)

    monkeypatch.setattr(Tracer, "record", counting_record)
    monkeypatch.setattr(Tracer, "defer", counting_defer)
    eng = _drive_port(models, None, mode="chunked", paged=True)
    assert eng._trace is None and eng.pool._trace is None
    assert eng.scheduler._trace is None
    assert eng.metrics.completed > 0
    assert calls["n"] == 0, "hot path touched the tracer while disabled"


def _normalised(events):
    """Each event as compared: a plan_resolve of an unresolved cell names
    its package's own default tile, so that tile is dropped."""
    out = []
    for ev in events:
        ev = dict(ev)
        args = ev.get("args")
        if ev["name"] == "plan_resolve" and args["source"] in (
                "fallback", "no_plan"):
            ev["args"] = {k: v for k, v in args.items() if k != "tile"}
        out.append(ev)
    return out


@pytest.mark.parametrize("planned", [False, True], ids=["no_plan", "plan"])
@pytest.mark.parametrize("mode", MODES)
def test_engine_events_equal_the_jax_engines(models, plan_path, mode,
                                             planned):
    plans = ((JaxTilePlan.load(plan_path), TilePlan.load(plan_path))
             if planned else (None, None))
    jt, pt = JaxTracer(), Tracer()
    _drive_jax(models, jt, mode=mode, plan=plans[0])
    _drive_port(models, pt, mode=mode, plan=plans[1])
    assert jt.procs == pt.procs
    want, got = _normalised(jt.events), _normalised(pt.events)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"event {i}: {g} != {w}"
    names = {e["name"] for e in got}
    assert {"submit", "admit", "first_token", "ttft", "finish", "decode",
            "step", "queue_depth", "queue_push", "queue_pop",
            "plan_resolve"} <= names
    if mode != "unchunked":
        assert "chunk" in names
    if planned:
        sources = {e["args"]["source"] for e in got
                   if e["name"] == "plan_resolve"}
        assert "exact" in sources


def test_paged_engine_events_equal_the_jax_engines_lane_by_lane(models):
    jt, pt = JaxTracer(), Tracer()
    _drive_jax(models, jt, mode="chunked", paged=True)
    _drive_port(models, pt, mode="chunked", paged=True)

    def lanes(events):
        by = {}
        for ev in events:
            by.setdefault(ev["tid"], []).append(ev)
        return by

    want, got = lanes(_normalised(jt.events)), lanes(_normalised(pt.events))
    assert sorted(got) == sorted(want)
    for tid in want:
        assert got[tid] == want[tid], f"lane {tid}"
    assert {e["name"] for e in pt.events} >= {"page_alloc", "page_free",
                                              "pool_occupancy"}
    # Whole sequences differ only in where a step's finish instants sit.
    assert sorted(map(json.dumps, got[LANE_LIFECYCLE])) == sorted(
        map(json.dumps, want[LANE_LIFECYCLE]))


def test_live_clock_trace_p95_equals_the_metrics(models):
    """On the wall clock (no virtual clock) the trace's TTFT p95 is the
    metrics' p95 to the bit: one clock reading serves both."""
    _, cfg, _, params = models
    tracer = Tracer()
    eng = ServeEngine(cfg, params, device="cpu", max_len=80, slots=2,
                      tracer=tracer)
    for prompt in _prompts(6, seed=3):
        eng.add_request(prompt, max_new_tokens=NEW_TOKENS)
    eng.run_until_done()
    tracer.flush()
    ttfts = trace_report.ttft_values({"events": tracer.events})
    assert len(ttfts) == 6
    assert nearest_rank(ttfts, 0.95) == eng.metrics.ttft_p95()
