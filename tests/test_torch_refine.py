"""Shadow execution and plan refinement in the port (``serve/refine.py`` and
the engine's shadow steps) on the CPU, against ``tests/test_refine.py``.

* Token parity: served tokens are bit-identical with shadowing on (every
  step diverted) or off, unchunked, chunked, packed and paged.
* The schedule is counter-based, and with the same ``fake_measure``, plan
  and requests it is the JAX engine's: the same cells, incumbents and
  candidates in the same order (the metrics' shadow section, the refiner's
  cells, the ``shadow`` trace events), and the same refined artifact.
* ``PlanRefiner`` fed the same observations gives the reference's refined
  entries, ``meta["measurements"]`` and ``drift_report``; its confidence
  gate and the schema-v3 round trip are the reference's.
* ``set_plans`` drops the plan-derived state (the slots' graphs and the
  shadow views included) and keeps the tokens, mid-flight too.
* ``test_refinement_recovers_from_wrong_plan`` with the paper's GTX260 in
  the reference's ``tpu_v5e`` role: an engine on a ``geforce_8800gts``
  plan (every resolution a cross-hardware transfer) re-ranks a cell from
  shadow evidence, and the refined cell resolves exactly.
* No silent cost model on the H100: a CPU engine on ``h100_sxm`` with no
  ``shadow_measure`` raises ``RuntimeError`` at its first timed cell; and a
  tile its wrapper would not launch as given measures ``inf`` untimed,
  which the refiner's gate handles as the module's docstring says.

The reference's four ``roll_plans`` tests are in ``test_torch_fleet.py``. The plans
are the port's compiles of the smoke serving cells for the paper's GPUs
(the JAX package's specs hold no tile of these cells within 16 KB of
shared memory); where both engines run, both load the same saved artifact
and name the same hardware, so every cell resolves exactly in both.
"""
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.core import HARDWARE_REGISTRY as JAX_HARDWARE  # noqa: E402
from repro.core.plans import TilePlan as JaxTilePlan  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.obs import Tracer as JaxTracer  # noqa: E402
from repro.serve import BucketPolicy as JaxBucketPolicy  # noqa: E402
from repro.serve import PlanRefiner as JaxRefiner  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro.serve import ShapeBucketScheduler as JaxBucketScheduler  # noqa: E402
from repro.serve import drift_report as jax_drift_report  # noqa: E402
from repro_torch import configs, kernels  # noqa: E402
from repro_torch.core import (GEFORCE_8800GTS, GTX260, H100_SXM,  # noqa: E402
                              PLAN_SCHEMA_VERSION, TilePlan, compile_plan,
                              registry)
from repro_torch.core.plans import PlanTransferWarning, score_tile  # noqa: E402
from repro_torch.core.tiling import TileShape  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.compile_plans import serve_bucket_cells  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.obs import Tracer  # noqa: E402
from repro_torch.serve import (BucketPolicy, PlanRefiner,  # noqa: E402
                               ServeEngine, ServeMetrics,
                               ShapeBucketScheduler, drift_report,
                               make_shadow_measure)

EDGES = (8, 64)
MAX_LEN = 80
SLOTS = 2
# A flash_decode cell of the smoke model: its curve holds three tiles.
PROB = dict(b=2, skv=80, d=16, hq=4, hkv=2, window=0)


@pytest.fixture(scope="module")
def models():
    kernels.register_all()
    cfg_j = jax_configs.get_smoke("qwen2-1.5b")
    cfg_t = configs.get_smoke("qwen2-1.5b")
    pj = jax_api.init_params(cfg_j, jax.random.PRNGKey(0))
    pt = params_from_jax(cfg_t, jax.tree.map(np.asarray, pj), device="cpu")
    return cfg_j, cfg_t, pj, pt


def _plan(hw):
    cells = serve_bucket_cells(["qwen2-1.5b"], EDGES, slots=SLOTS,
                               max_len=MAX_LEN, smoke=True)
    return compile_plan([(k, p, "float32", hw) for k, p in cells
                         if k in registry.names()])


@pytest.fixture(scope="module")
def donor_plan(models):
    """Only geforce_8800gts entries: on a gtx260 engine every resolution is
    a cross-hardware transfer, the wrong-plan start state."""
    return _plan(GEFORCE_8800GTS)


@pytest.fixture(scope="module")
def native_plan(models):
    return _plan(GTX260)


@pytest.fixture(scope="module")
def donor_path(donor_plan, tmp_path_factory):
    path = tmp_path_factory.mktemp("plans") / "donor.json"
    donor_plan.save(str(path))
    return str(path)


def fake_measure(kernel, problem, dtype, tile):
    """The reference's deterministic stand-in for the timing path."""
    return 1e-6 * (1 + sum(int(x) for x in tile) % 7) + 1e-9 * len(kernel)


def _mode_kw(mode):
    return dict(chunk_prefill=mode != "unchunked",
                pack_prefill=mode == "packed", paged=mode == "paged",
                prefill_slots=2,
                step_token_budget=32 if mode != "unchunked" else 0)


def _engine(models, mode="unchunked", plans=None, shadow=0.0, refiner=None,
            measure=fake_measure, hardware=GTX260, **kw):
    _, cfg, _, params = models
    return ServeEngine(
        cfg, params, max_len=MAX_LEN, slots=SLOTS, plans=plans,
        hardware=hardware, device="cpu",
        scheduler=ShapeBucketScheduler(BucketPolicy(EDGES, max_queue=99)),
        shadow_fraction=shadow, shadow_measure=measure, refiner=refiner,
        **_mode_kw(mode), **kw)


def _jax_engine(models, mode="unchunked", plans=None, shadow=0.0,
                refiner=None, **kw):
    cfg, _, params, _ = models
    return JaxEngine(
        cfg, params, max_len=MAX_LEN, slots=SLOTS, plans=plans,
        hardware=JAX_HARDWARE["geforce_8800gts"],
        scheduler=JaxBucketScheduler(JaxBucketPolicy(EDGES, max_queue=99)),
        shadow_fraction=shadow, shadow_measure=fake_measure, refiner=refiner,
        **_mode_kw(mode), **kw)


def _trace(cfg, seed=0, lens=(3, 10, 30, 5, 50, 12)):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32)
            for n in lens]


def _artifact(plan):
    """A plan as a saved dict, without the port's ``measured`` flag on its
    entries (a field the reference's entries do not have)."""
    d = plan.to_dict()
    for entry in d["entries"]:
        entry.pop("measured", None)
    return d


def _run(eng, trace, new_tokens=3):
    rids = [eng.add_request(p, max_new_tokens=new_tokens) for p in trace]
    assert all(r is not None for r in rids)
    done = eng.run_until_done()
    return {r.rid: tuple(r.out_tokens) for r in done}


# ---------------------------------------------------------------------------
# Shadow execution: token parity and the schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["unchunked", "chunked", "packed", "paged"])
def test_shadow_token_parity(mode, models, donor_plan):
    cfg = models[1]
    trace = _trace(cfg)
    off = _engine(models, mode, plans=donor_plan, shadow=0.0)
    ref = _run(off, trace)
    refiner = PlanRefiner()
    on = _engine(models, mode, plans=donor_plan, shadow=1.0, refiner=refiner)
    got = _run(on, trace)
    assert got == ref, f"{mode}: shadow execution changed served tokens"
    assert off.metrics.shadow_steps == 0
    assert on.metrics.shadow_steps > 0
    assert on.metrics.shadow_time
    assert refiner.n_samples() > 0
    assert on.metrics.as_dict()["shadow"]["samples"]


def test_shadow_schedule_is_counter_based(models, donor_plan):
    def one_run():
        refiner = PlanRefiner()
        eng = _engine(models, plans=donor_plan, shadow=0.5, refiner=refiner)
        _run(eng, _trace(models[1], lens=(5, 20)), new_tokens=8)
        return eng, refiner

    eng_a, ref_a = one_run()
    assert eng_a.steps_run > 2
    assert eng_a.metrics.shadow_steps == eng_a.steps_run // 2
    eng_b, ref_b = one_run()
    assert eng_b.steps_run == eng_a.steps_run
    assert (eng_b.metrics.as_dict()["shadow"]
            == eng_a.metrics.as_dict()["shadow"])
    assert ref_b.n_samples() == ref_a.n_samples()
    assert ref_b.cells() == ref_a.cells()


def test_shadow_fraction_validation(models):
    for bad in (-0.1, 1.5):
        with pytest.raises(ValueError, match="shadow_fraction"):
            _engine(models, shadow=bad)


@pytest.mark.parametrize("mode", ["unchunked", "chunked", "packed"])
def test_shadow_schedule_is_the_jax_engines(mode, models, donor_path):
    """The same artifact, requests and measure: the port visits the JAX
    engine's cells, incumbents and candidates in its order, and both
    refiners emit the same refined artifact."""
    cfg = models[1]
    trace = _trace(cfg)
    runs = {}
    for name, make, plan_cls, refiner_cls, tracer_cls in (
            ("jax", _jax_engine, JaxTilePlan, JaxRefiner, JaxTracer),
            ("port", lambda m, mode, **kw: _engine(
                m, mode, hardware=GEFORCE_8800GTS, **kw),
             TilePlan, PlanRefiner, Tracer)):
        plan = plan_cls.load(donor_path)
        refiner = refiner_cls(min_samples=2)
        tracer = tracer_cls(clock=lambda: 0.0)
        eng = make(models, mode, plans=plan, shadow=1.0, refiner=refiner,
                   tracer=tracer)
        _run(eng, trace)
        shadows = [e["args"] for e in tracer.events if e["name"] == "shadow"]
        runs[name] = (eng.metrics.as_dict()["shadow"], refiner.cells(),
                      refiner.n_samples(), shadows,
                      _artifact(refiner.refine(plan)), eng.steps_run)
    assert runs["port"] == runs["jax"]
    metrics, cells, samples, shadows, refined, _ = runs["port"]
    assert samples > 0 and shadows
    assert {s["kernel"] for s in shadows} >= {"flash_decode", "kv_page"}


def test_metrics_as_dict_golden():
    times = iter([0.0, 0.5])
    m = ServeMetrics(clock=lambda: next(times))
    m.record_submit(7)
    m.record_first_token(7, 64)
    m.record_queue_depth(2)
    m.record_shadow_step()
    m.record_shadow("matmul", (8, 64), 0.75, incumbent=True)
    m.record_shadow("matmul", (8, 64), 0.25, incumbent=True)
    m.record_shadow("matmul", (16, 64), 0.25)
    point5 = {"count": 1, "mean_s": 0.5, "max_s": 0.5,
              "p50_s": 0.5, "p95_s": 0.5, "p99_s": 0.5}
    d = m.as_dict()
    assert d["shadow"] == {
        "steps": 1,
        "incumbents": {"matmul": "(8, 64)"},
        "samples": {"matmul": {
            "(8, 64)": {"count": 2, "mean_s": 0.5, "max_s": 0.75,
                        "p50_s": 0.25, "p95_s": 0.75, "p99_s": 0.75},
            "(16, 64)": {"count": 1, "mean_s": 0.25, "max_s": 0.25,
                         "p50_s": 0.25, "p95_s": 0.25, "p99_s": 0.25},
        }},
    }
    assert d["ttft_s"] == {"64": point5}
    assert d["metrics_schema"] == 2
    json.dumps(d)


def test_metrics_ttft_windows():
    m = ServeMetrics(clock=lambda: 0.0)
    for v in (1.0, 2.0):
        m.ttft[8].record(v)
    mark = m.ttft_counts()
    assert mark == {8: 2}
    for v in (4.0, 8.0):
        m.ttft[8].record(v)
    m.ttft[64].record(16.0)
    assert sorted(m.ttft_since(mark)) == [4.0, 8.0, 16.0]
    assert m.ttft_p95(mark) == 16.0
    assert m.ttft_p95() == 16.0
    assert ServeMetrics().ttft_p95() == 0.0


# ---------------------------------------------------------------------------
# PlanRefiner: the confidence gate and re-ranking provenance
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def decode_donor(models):
    return compile_plan([("flash_decode", PROB, "float32", GEFORCE_8800GTS)])


def _observe(refiner, tile, dt, n, incumbent=False):
    for _ in range(n):
        refiner.observe("flash_decode", PROB, "float32", "gtx260", tile, dt,
                        incumbent=incumbent)


def test_refiner_param_validation():
    with pytest.raises(ValueError, match="min_samples"):
        PlanRefiner(min_samples=0)
    with pytest.raises(ValueError, match="min_speedup"):
        PlanRefiner(min_speedup=0.9)


def test_refiner_gate_needs_incumbent(decode_donor):
    refiner = PlanRefiner()
    _observe(refiner, (32,), 0.5, n=5)
    refined = refiner.refine(decode_donor)
    assert refined.meta["measurements"] == []
    assert len(refined) == len(decode_donor)


def test_refiner_gate_min_samples(decode_donor):
    refiner = PlanRefiner(min_samples=3)
    _observe(refiner, (80,), 1.0, n=3, incumbent=True)
    _observe(refiner, (32,), 0.5, n=2)
    assert refiner.refine(decode_donor).meta["measurements"] == []
    refiner = PlanRefiner(min_samples=3)
    _observe(refiner, (80,), 1.0, n=2, incumbent=True)
    _observe(refiner, (32,), 0.5, n=3)
    assert refiner.refine(decode_donor).meta["measurements"] == []


def test_refiner_gate_min_speedup(decode_donor):
    refiner = PlanRefiner(min_samples=3, min_speedup=1.05)
    _observe(refiner, (80,), 1.02, n=3, incumbent=True)
    _observe(refiner, (32,), 1.0, n=3)
    assert refiner.refine(decode_donor).meta["measurements"] == []


def test_refiner_confident_rerank(decode_donor):
    refiner = PlanRefiner(min_samples=3, min_speedup=1.05)
    _observe(refiner, (80,), 1.0, n=3, incumbent=True)
    _observe(refiner, (32,), 0.5, n=4)
    with pytest.warns(PlanTransferWarning):
        assert decode_donor.resolve("flash_decode", PROB, "float32",
                                    GTX260).source == "cross_hardware"
    refined = refiner.refine(decode_donor)
    entry = refined.lookup("flash_decode", PROB, "float32", "gtx260")
    assert entry is not None
    assert entry.tile.dims == (32,)
    assert entry.dominant == "measured"
    assert entry.score_s == 0.5
    assert entry.curve[0][0] == (32,)
    res = refined.resolve("flash_decode", PROB, "float32", GTX260)
    assert res.source == "exact"
    assert refined.meta["refined_from"]["schema_version"] \
        == PLAN_SCHEMA_VERSION
    assert refined.meta["refined_from"]["entries"] == len(decode_donor)
    assert refined.meta["shadow_samples"] == refiner.n_samples() == 7
    report = drift_report(refined)
    assert report["n_refined"] == 1
    cell = report["cells"][0]
    assert cell["incumbent"] == [80] and cell["refined"] == [32]
    assert cell["speedup"] == 2.0 and cell["samples"] == 4
    assert cell["cell"].endswith("|float32|gtx260")


def test_refined_artifact_roundtrip(tmp_path, decode_donor):
    refiner = PlanRefiner()
    _observe(refiner, (80,), 1.0, n=3, incumbent=True)
    _observe(refiner, (32,), 0.5, n=3)
    refined = refiner.refine(decode_donor)
    path = str(tmp_path / "refined.json")
    refined.save(path)
    assert json.load(open(path))["schema_version"] == PLAN_SCHEMA_VERSION == 3
    loaded = TilePlan.load(path)
    assert len(loaded) == len(refined) == 2
    assert loaded.meta["refined_from"] == refined.meta["refined_from"]
    assert drift_report(loaded) == drift_report(refined)
    assert loaded.resolve("flash_decode", PROB, "float32",
                          GTX260).source == "exact"


_OBSERVATIONS = [
    # (kernel, problem, tile, seconds, incumbent): three cells, one that
    # re-ranks, one held by min_speedup, one without an incumbent.
    ("flash_decode", PROB, (80,), 2e-5, True),
    ("flash_decode", PROB, (32,), 1.25e-5, False),
    ("flash_decode", PROB, (64,), 1.5e-5, False),
    ("kv_page", dict(skv=80, d=16, hkv=2), (80,), 1.0e-5, True),
    ("kv_page", dict(skv=80, d=16, hkv=2), (32,), 0.99e-5, False),
    ("flash_attention", dict(sq=8, skv=8, d=16, hq=4, hkv=2, window=0),
     (64, 32), 3e-6, False),
]


def test_refiner_equals_the_references_on_the_same_observations(
        donor_path):
    """Fed the same observations, in the same order, the port's refiner
    gives the reference's refined entries, measurements and drift report
    (the artifacts compared as saved dicts)."""
    out = {}
    for name, refiner_cls, plan_cls, report in (
            ("jax", JaxRefiner, JaxTilePlan, jax_drift_report),
            ("port", PlanRefiner, TilePlan, drift_report)):
        refiner = refiner_cls(min_samples=3, min_speedup=1.05)
        for _ in range(4):
            for kernel, problem, tile, dt, inc in _OBSERVATIONS:
                refiner.observe(kernel, problem, "float32", "gtx260", tile,
                                dt, incumbent=inc)
        refined = refiner.refine(plan_cls.load(donor_path))
        out[name] = (_artifact(refined), report(refined), refiner.cells(),
                     refiner.n_samples())
    assert out["port"] == out["jax"]
    assert out["port"][1]["n_refined"] == 1
    assert out["port"][1]["cells"][0]["refined"] == [32]


# ---------------------------------------------------------------------------
# A tile the wrapper would not launch measures inf
# ---------------------------------------------------------------------------

FULL_DECODE = dict(b=4, skv=1024, d=128, hq=12, hkv=2, window=0)


def test_an_unlaunchable_tile_measures_inf_untimed_on_the_h100():
    """``make_shadow_measure(h100_sxm)`` returns ``inf`` for a tile its
    wrapper would not launch as given — a decode block longer than the
    cache (clamped), a matmul or attention tile that is not compiled —
    without building a timer; a launchable tile goes to the card, which a
    CPU host does not have."""
    measure = make_shadow_measure(H100_SXM)
    full_mm = dict(m=600, k=1536, n=8960)
    unlaunchable = [("flash_decode", FULL_DECODE, (2048,)),
                    ("matmul", full_mm, (32, 32, 32)),
                    ("matmul", full_mm, (16, 64, 256)),   # skinny at M 600
                    ("flash_attention",
                     dict(sq=600, skv=600, d=128, hq=12, hkv=2, window=0),
                     (48, 48))]
    for kernel, problem, tile in unlaunchable:
        assert not specs.cell_launches(kernel, problem, "float32", tile)
        assert measure(kernel, problem, "float32", tile) == math.inf
    assert measure.timers == {}
    for kernel, problem, tile in (("flash_decode", FULL_DECODE, (64,)),
                                  ("matmul", full_mm, (128, 16, 128))):
        assert specs.cell_launches(kernel, problem, "float32", tile)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                measure(kernel, problem, "float32", tile)
    # A modelled GPU has no card to refuse a tile: the cost model scores it.
    modelled = make_shadow_measure(GTX260)
    assert modelled("kv_page", dict(skv=80, d=16, hkv=2), "float32",
                    (32,)) == score_tile("kv_page", TileShape((32,)),
                                         dict(skv=80, d=16, hkv=2),
                                         "float32", GTX260)


def test_the_gate_with_infinite_times(decode_donor):
    """An infinite incumbent is beaten by any finite candidate with enough
    samples (infinite speedup); an infinite candidate never wins; a cell
    whose every tile is infinite is not re-ranked; the refined curve keeps
    the infinite point and its sensitivity is over the finite ones."""
    refiner = PlanRefiner(min_samples=3)
    _observe(refiner, (80,), math.inf, n=3, incumbent=True)
    _observe(refiner, (64,), math.inf, n=3)
    _observe(refiner, (32,), 2e-5, n=3)
    refined = refiner.refine(decode_donor)
    (m,) = refined.meta["measurements"]
    assert m["tile"] == [32] and m["speedup"] == math.inf
    entry = refined.lookup("flash_decode", PROB, "float32", "gtx260")
    assert entry.curve[0] == ((32,), 2e-5)
    assert [s for _, s in entry.curve[1:]] == [math.inf, math.inf]
    assert entry.sensitivity == 1.0
    refiner = PlanRefiner(min_samples=3)
    _observe(refiner, (80,), 1e-5, n=3, incumbent=True)
    _observe(refiner, (32,), math.inf, n=3)
    assert refiner.refine(decode_donor).meta["measurements"] == []
    refiner = PlanRefiner(min_samples=3)
    _observe(refiner, (80,), math.inf, n=3, incumbent=True)
    _observe(refiner, (32,), math.inf, n=3)
    assert refiner.refine(decode_donor).meta["measurements"] == []


def test_a_cpu_engine_on_the_h100_raises_without_a_measure(models):
    """No silent cost model: with no ``shadow_measure`` an ``h100_sxm``
    engine times its cells on the card, and on a CPU host its first
    shadow step that reaches a launchable cell raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the cells would be timed")
    plan = _plan(H100_SXM)
    eng = _engine(models, plans=plan, shadow=1.0, measure=None,
                  hardware=H100_SXM)
    for p in _trace(models[1], lens=(5, 60)):
        eng.add_request(p, max_new_tokens=6)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eng.run_until_done()


# ---------------------------------------------------------------------------
# Live swap: ServeEngine.set_plans
# ---------------------------------------------------------------------------

def test_set_plans_live_swap(models, donor_plan, native_plan):
    trace = _trace(models[1], lens=(5, 30))
    eng = _engine(models, plans=donor_plan, shadow=1.0)
    assert "cross_hardware" in eng.tile_sources.values()
    ref = _run(eng, trace)
    assert eng._prefill_tiles and eng._shadow_views
    eng.set_plans(native_plan)
    assert not eng._prefill_tiles and not eng._shadow_views
    assert all(slot.graph is None for slot in eng._slots)
    assert eng.tile_sources
    assert {s for k, s in eng.tile_sources.items() if k != "matmul"} \
        == {"exact"}
    again = _run(eng, trace)
    assert sorted(again.values()) == sorted(ref.values())


def test_set_plans_mid_flight_token_parity(models, donor_plan, native_plan):
    trace = _trace(models[1], lens=(5, 30, 12))
    ref = _run(_engine(models, plans=donor_plan), trace, new_tokens=6)
    eng = _engine(models, plans=donor_plan)
    rids = [eng.add_request(p, max_new_tokens=6) for p in trace]
    assert all(r is not None for r in rids)
    eng.step()
    eng.step()
    assert eng.in_flight()
    eng.set_plans(native_plan)
    done = eng.run_until_done()
    assert {r.rid: tuple(r.out_tokens) for r in done} == ref


# ---------------------------------------------------------------------------
# End to end: wrong plan -> shadow evidence -> exact refined resolution
# ---------------------------------------------------------------------------

def test_refinement_recovers_from_wrong_plan(models, donor_plan):
    """An engine believing gtx260 starts on a geforce_8800gts-only plan
    under a measured truth the gtx260 ranking does not match (the card
    times each tile as the 8800 GTS's model scores it, which prefers the
    donor's decode block to the one the transfer re-ranked to); shadow
    evidence re-ranks at least one cell, and the refined cell resolves
    exactly, with no transfer."""

    def truth(kernel, problem, dtype, tile):
        t = TileShape(tuple(int(x) for x in tile))
        return score_tile(kernel, t, dict(problem), dtype, GEFORCE_8800GTS)

    refiner = PlanRefiner(min_samples=3, min_speedup=1.05)
    eng = _engine(models, plans=donor_plan, shadow=1.0, refiner=refiner,
                  measure=truth)
    refined = None
    for round_ in range(12):
        _run(eng, _trace(models[1], seed=round_), new_tokens=4)
        refined = refiner.refine(donor_plan)
        if refined.meta["measurements"]:
            break
    assert refined is not None and refined.meta["measurements"], \
        f"no cell re-ranked after {eng.metrics.shadow_steps} shadow steps"
    for m in refined.meta["measurements"]:
        res = refined.resolve(m["kernel"], m["problem"], m["dtype"], GTX260)
        assert res.source == "exact"
        assert m["speedup"] >= 1.05
        with pytest.warns(PlanTransferWarning):
            donor = donor_plan.resolve(m["kernel"], m["problem"], m["dtype"],
                                       GTX260)
        assert donor.source == "cross_hardware"
