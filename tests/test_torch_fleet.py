"""The port's FleetRouter on the CPU: routing by the cost model, the
chunk-aware load, and the versioned plan rollout, against the reference's
fleet tests (``tests/test_scheduler.py``'s fleet section,
``tests/test_serve_chunked.py``'s fleet tests, ``tests/test_refine.py``'s
four ``roll_plans`` tests and ``tests/test_obs_trace.py``'s clipped-window
test).

* Routing (plans and the cost model only; no engine runs the model): a
  fleet of two engines whose hardware trades off, so the cheapest
  instance differs between bucket edges. The port's registry holds no such
  pair (the H100 leads both paper GPUs on every rate), so the test builds
  two descriptors from the H100's: one with 1/96 of its bandwidth, one
  with 1/1024 of its float32 SIMT rate. At the smoke shapes these make
  the 16-token bucket cheapest on the second and the longer ones on the
  first. They are test data; the package's registry gains nothing. The
  same prefill shape wants different tiles on the H100 and the GTX260
  (the paper's claim, on the registry's own descriptors).
* The chunk-aware load and the route's reject reasons, with the JAX
  fleet's numbers.
* ``roll_plans``: keep a better artifact, revert a regression, never revert
  on a thin or clipped probe window, swap unguarded without a probe. Each
  rollout runs in both packages (the same port-compiled artifacts loaded
  into each, both engines on the GTX260) and gives the same decisions.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import repro.serve as jax_serve  # noqa: E402
import repro_torch.serve as torch_serve  # noqa: E402
from repro import configs as jax_configs  # noqa: E402
from repro import kernels as jax_kernels  # noqa: E402
from repro.core import HARDWARE_REGISTRY as JAX_HARDWARE  # noqa: E402
from repro.core.plans import TilePlan as JaxTilePlan  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.serve.metrics import _LatencyStat as JaxLatencyStat  # noqa: E402
from repro_torch import configs, kernels  # noqa: E402
from repro_torch.core import (GEFORCE_8800GTS, GTX260, H100_SXM,  # noqa: E402
                              compile_plan, registry)
from repro_torch.launch.compile_plans import serve_bucket_cells  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve import (BucketPolicy, FleetRouter,  # noqa: E402
                               ServeEngine, ShapeBucketScheduler)
from repro_torch.serve.metrics import _LatencyStat  # noqa: E402

# Test-local hardware whose rates trade off (see the module docstring).
SLOW_HBM = dataclasses.replace(H100_SXM, name="h100_slow_hbm",
                               hbm_bw=H100_SXM.hbm_bw / 96)
SLOW_SIMT = dataclasses.replace(H100_SXM, name="h100_slow_simt",
                                simt_flops=H100_SXM.simt_flops / 1024)
ROUTE_EDGES = (16, 64, 256, 1024)
ROUTE_SLOTS, ROUTE_MAX_LEN = 2, 1040


@pytest.fixture(scope="module")
def models():
    kernels.register_all()
    jax_kernels.register_all()
    cfg_j = jax_configs.get_smoke("qwen2-1.5b")
    cfg_t = configs.get_smoke("qwen2-1.5b")
    pj = jax_api.init_params(cfg_j, jax.random.PRNGKey(0))
    pt = params_from_jax(cfg_t, jax.tree.map(np.asarray, pj), device="cpu")
    return cfg_j, cfg_t, pj, pt


def _route_fleet(models, hws):
    _, cfg, _, params = models
    cells = serve_bucket_cells(["qwen2-1.5b"], ROUTE_EDGES, ROUTE_SLOTS,
                               ROUTE_MAX_LEN, smoke=True)
    plan = compile_plan([(k, p, "float32", hw) for k, p in cells
                         for hw in hws if k in registry.names()])
    policy = BucketPolicy(ROUTE_EDGES)
    engines = {hw.name: ServeEngine(cfg, params, max_len=ROUTE_MAX_LEN,
                                    slots=ROUTE_SLOTS, plans=plan,
                                    hardware=hw, device="cpu",
                                    scheduler=ShapeBucketScheduler(policy))
               for hw in hws}
    return FleetRouter(engines, policy)


@pytest.fixture(scope="module")
def fleet(models):
    return _route_fleet(models, (SLOW_HBM, SLOW_SIMT))


# ---------------------------------------------------------------------------
# Routing (the plan and the cost model; the model never runs)
# ---------------------------------------------------------------------------

def test_fleet_routes_to_cost_model_optimum(fleet):
    d = fleet.route(np.arange(10, dtype=np.int32), max_new_tokens=4)
    assert d is not None and d.bucket == 16
    # Every instance idle: the choice is the pure cost-model argmin.
    best = min(d.scores, key=lambda kv: (kv[1], kv[0]))[0]
    assert d.instance == best
    assert d.instance == fleet.placement_table(4)[16]


def test_fleet_placement_differs_across_buckets(fleet):
    table = fleet.placement_table(4)
    assert set(table) == set(ROUTE_EDGES)
    # The bandwidth-starved and the compute-starved model each win some
    # buckets: the per-model optimum, at placement granularity.
    assert len(set(table.values())) >= 2, table


def test_fleet_tiles_differ_per_hardware(models):
    paper = _route_fleet(models, (H100_SXM, GTX260))
    diff = [b for b in paper.policy.edges
            if len({tuple(sorted(t.items()))
                    for t in paper.tile_table(b).values()}) > 1]
    assert diff, "no bucket resolved different tiles across hardware models"


def test_fleet_tables_exclude_unroutable(fleet):
    """A fresh router over the same engines (status is per router) drops
    dead and stalled members from both tables."""
    r = FleetRouter(fleet.engines, fleet.policy)
    names = set(fleet.engines)
    assert set(r.placement_table(4).values()) <= names
    assert set(r.tile_table(16)) == names
    r.status[SLOW_HBM.name] = "dead"
    assert set(r.placement_table(4).values()) == {SLOW_SIMT.name}
    assert set(r.tile_table(16)) == {SLOW_SIMT.name}
    r.status[SLOW_SIMT.name] = "stalled"
    assert r.placement_table(4) == {}
    assert r.tile_table(16) == {}


def test_fleet_load_spreads_routing(fleet):
    # Loading the cheap instance's slots and queue must divert a request
    # of the same bucket to the other instance.
    seen = set()
    for _ in range(12):
        d = fleet.route(np.arange(10, dtype=np.int32), max_new_tokens=4)
        assert d is not None
        seen.add(d.instance)
    assert len(seen) == 2
    assert fleet.pending() > 0


def test_fleet_rejects_overlong_prompt(fleet):
    assert fleet.route(np.zeros(4096, np.int32)) is None


# ---------------------------------------------------------------------------
# The chunk-aware load and the route's reject reasons, against JAX
# ---------------------------------------------------------------------------

def _chunk_load(s, cfg, params, kw):
    policy = s.BucketPolicy((8, 64), max_queue=64)

    def fleet(chunked):
        engines = {h: s.ServeEngine(cfg, params, max_len=160, slots=2,
                                    scheduler=s.ShapeBucketScheduler(policy),
                                    chunk_prefill=chunked,
                                    step_token_budget=10 if chunked else 0,
                                    **kw)
                   for h in ("a", "b")}
        return s.FleetRouter(engines, policy), engines

    router_c, eng_c = fleet(True)
    router_u, eng_u = fleet(False)
    prompt = np.arange(2, 62, dtype=np.int32)
    for eng in (eng_c["a"], eng_u["a"]):
        eng.add_request(prompt, max_new_tokens=2)
    # The queued long prompt is a whole slot unit unchunked, its chunk
    # fraction chunked.
    assert router_u._load("a") == pytest.approx(0.5)
    assert 0.0 < router_c._load("a") < router_u._load("a")
    assert router_c._load("b") == 0.0
    return router_u._load("a"), router_c._load("a")


def test_fleet_load_counts_chunks_not_whole_prompts(models):
    cfg_j, cfg_t, pj, pt = models
    assert (_chunk_load(torch_serve, cfg_t, pt, {"device": "cpu"})
            == _chunk_load(jax_serve, cfg_j, pj, {}))


def _reject(s, cfg, params, kw):
    policy = s.BucketPolicy((8,), max_queue=4)
    router = s.FleetRouter(
        {"a": s.ServeEngine(cfg, params, max_len=32, slots=1,
                            scheduler=s.ShapeBucketScheduler(policy), **kw)},
        policy)
    assert router.route(np.zeros(99, np.int32)) is None
    assert router.rejects == {"over_length": 1}
    assert router.metrics()["router"]["rejects"] == {"over_length": 1}
    return router.metrics()["router"]


def test_fleet_route_records_reject_reason(models):
    cfg_j, cfg_t, pj, pt = models
    assert (_reject(torch_serve, cfg_t, pt, {"device": "cpu"})
            == _reject(jax_serve, cfg_j, pj, {}))


# ---------------------------------------------------------------------------
# roll_plans: the p95-TTFT rollback guard, against the JAX fleet
# ---------------------------------------------------------------------------

ROLL_EDGES = (8, 64)
ROLL_MAX_LEN, ROLL_SLOTS = 80, 2


@pytest.fixture(scope="module")
def roll_plans(models, tmp_path_factory):
    """(donor, native) artifacts for each package: the port's compiles of
    the smoke serving cells for the 8800 GTS (on a GTX260 engine every
    resolution a cross-hardware transfer) and for the GTX260, saved and
    loaded into both packages."""
    cells = serve_bucket_cells(["qwen2-1.5b"], ROLL_EDGES, slots=ROLL_SLOTS,
                               max_len=ROLL_MAX_LEN, smoke=True)
    out = {"torch": [], "jax": []}
    tmp = tmp_path_factory.mktemp("roll")
    for hw in (GEFORCE_8800GTS, GTX260):
        plan = compile_plan([(k, p, "float32", hw) for k, p in cells
                             if k in registry.names()])
        path = str(tmp / f"{hw.name}.json")
        plan.save(path)
        out["torch"].append(plan)
        out["jax"].append(JaxTilePlan.load(path))
    return out


def _roll_fleet(models, pkg, plan):
    cfg_j, cfg_t, pj, pt = models
    if pkg == "torch":
        s, cfg, params, hw, kw = torch_serve, cfg_t, pt, GTX260, {
            "device": "cpu"}
    else:
        s, cfg, params, hw, kw = jax_serve, cfg_j, pj, JAX_HARDWARE[
            "gtx260"], {}
    policy = s.BucketPolicy(ROLL_EDGES, max_queue=99)
    eng = s.ServeEngine(cfg, params, max_len=ROLL_MAX_LEN, slots=ROLL_SLOTS,
                        plans=plan, hardware=hw,
                        scheduler=s.ShapeBucketScheduler(policy), **kw)
    return s.FleetRouter({"a": eng}, policy)


def _probe(router, artifact, on_artifact_s, otherwise_s, n=5):
    """Records ``n`` TTFT samples whose value depends on the plan the
    engine serves: probe traffic on a virtual clock."""
    def drive(name):
        eng = router.engines[name]
        val = on_artifact_s if eng.plans is artifact else otherwise_s
        for _ in range(n):
            eng.metrics.ttft[64].record(val)
    return drive


# (on the new artifact s, otherwise s, probe samples, roll_plans kwargs,
#  rolled back?, the engine on the new artifact after the roll?)
ROLLS = {
    "keeps_a_better_artifact": (0.5, 1.0, 5, {}, False, True),
    "reverts_a_regression": (5.0, 1.0, 5, {"tolerance": 1.10}, True, False),
    "thin_window_never_reverts": (5.0, 1.0, 2, {"min_window": 4}, False,
                                  True),
    "unguarded_without_probe": (None, None, 0, {}, False, True),
}


def _roll(models, roll_plans, pkg, case):
    donor, native = roll_plans[pkg]
    on_s, off_s, n, kw, back, on_new = ROLLS[case]
    router = _roll_fleet(models, pkg, donor)
    drive = (_probe(router, native, on_s, off_s, n=n)
             if on_s is not None else None)
    (decision,) = router.roll_plans(native, drive_fn=drive, **kw)
    assert decision.rolled_back is back
    assert (router.engines["a"].plans is native) is on_new
    assert (router.engines["a"].plans is donor) is (not on_new)
    assert router.roll_history == [decision]
    if drive is None:
        assert decision.pre_p95 == 0.0 and decision.post_p95 == 0.0
    return dataclasses.astuple(decision)


@pytest.mark.parametrize("case", sorted(ROLLS))
def test_roll_plans_decides_as_the_jax_fleet(models, roll_plans, case):
    got = _roll(models, roll_plans, "torch", case)
    assert got == _roll(models, roll_plans, "jax", case)
    if case == "keeps_a_better_artifact":
        assert got[1:3] == (1.0, 0.5)        # pre p95, post p95
    if case == "reverts_a_regression":
        assert got[2] == 5.0


class _StubEngine:
    """A duck-typed engine for roll_plans: metrics, plans, set_plans."""

    def __init__(self, s, stat, sample_cap):
        self.metrics = s.ServeMetrics(clock=lambda: 0.0)
        self.metrics.ttft[64] = stat(sample_cap=sample_cap)
        self.plans = object()
        self.swaps = []

    def set_plans(self, plans):
        self.swaps.append(plans)
        self.plans = plans


def _clipped_roll(s, stat, sample_cap, n_probe, want_clipped, want_rollback):
    """One rollout whose post window regresses 100x."""
    eng = _StubEngine(s, stat, sample_cap)
    phase = {"n": 0}

    def probe(name):
        phase["n"] += 1
        dt = 0.01 if phase["n"] == 1 else 1.0
        for _ in range(n_probe):
            eng.metrics.ttft[64].record(dt)

    router = s.FleetRouter({"a": eng}, policy=None)
    new = object()
    (decision,) = router.roll_plans(new, drive_fn=probe, tolerance=1.10)
    assert decision.clipped is want_clipped
    assert decision.rolled_back is want_rollback
    if want_rollback:
        assert eng.swaps[-1] is not new and eng.plans is not new
    else:
        # Clipped: the swap stands unguarded; nothing was reverted.
        assert eng.swaps == [new] and eng.plans is new
    return dataclasses.astuple(decision), len(eng.swaps)


@pytest.mark.parametrize("sample_cap,n_probe,want_clipped,want_rollback", [
    (8192, 6, False, True),   # a healthy window: a 100x regression reverts
    (4, 6, True, False),      # the window outgrew the buffer: inconclusive
])
def test_roll_plans_treats_clipped_windows_as_thin(
        sample_cap, n_probe, want_clipped, want_rollback):
    args = (sample_cap, n_probe, want_clipped, want_rollback)
    assert (_clipped_roll(torch_serve, _LatencyStat, *args)
            == _clipped_roll(jax_serve, JaxLatencyStat, *args))


# ---------------------------------------------------------------------------
# Serving cells without a plan, and the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["chunked", "packed", "paged"])
def test_serving_cells_without_a_plan_price_finite(models, mode):
    """The reference's default chunked / packed tile names a bkv the H100
    regime may not compile; the router prices the bkv its calls launch, so
    the scores stay finite and the load term spreads the requests."""
    _, cfg, _, params = models
    policy = BucketPolicy((16, 64), max_queue=99)
    engines = {n: ServeEngine(cfg, params, max_len=80, slots=2,
                              device="cpu",
                              scheduler=ShapeBucketScheduler(policy),
                              chunk_prefill=True,
                              pack_prefill=mode == "packed",
                              paged=mode == "paged", step_token_budget=32)
               for n in ("a", "b")}
    router = FleetRouter(engines, policy)
    seen = []
    for n in (10, 40, 12, 50):
        d = router.route(np.arange(2, 2 + n, dtype=np.int32),
                         max_new_tokens=4)
        assert all(np.isfinite(score) for _, score in d.scores), d.scores
        seen.append(d.instance)
    assert set(seen) == {"a", "b"}, seen
    router.run_until_done()
    assert len(router.results()) == 4 and router.lost == 0


def test_launcher_serves_through_the_fleet_on_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--device", "cpu", "--fleet", "h100_sxm,gtx260",
                "--scheduler", "bucket", "--requests", "12",
                "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert "12 requests (0 rejected)" in out
    assert "placements: {'16':" in out
    assert "instance gtx260 (gtx260, live)" in out
    assert "instance h100_sxm (h100_sxm, live)" in out
    serve.main(["--device", "cpu", "--fleet", "h100_sxm", "--scheduler",
                "bucket", "--autoscale", "--requests", "24",
                "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert "24 requests (0 rejected)" in out
    assert "autoscale: 1 join(s)" in out and "join h100_sxm2" in out
    with pytest.raises(SystemExit, match="--scheduler bucket"):
        serve.main(["--device", "cpu", "--fleet", "h100_sxm"])
    with pytest.raises(SystemExit, match="--fleet"):
        serve.main(["--device", "cpu", "--autoscale"])
