"""The port's fleet fault tolerance on the CPU, against the JAX fleet
(``tests/test_serve_faults.py``'s 19 cases).

* The injector (``serve/faults.py``): the same scripts fire the same
  events in both packages, with the reference's validation.
* Every fleet scenario of the reference (kill, stall, the retry budget,
  drain, join, steal, route failover, a dead fleet, exhaustion, a rejoin
  under a dead name, the placement tables, a recover mid-drain, orphan
  churn) runs once on two JAX engines and once on two port engines, "a"
  and "b", without plans: every cost-model score ties, so routing depends
  only on load and name. The reference's assertions hold on both, and the
  two fleets agree on ``results()`` (fid -> tokens; a token may differ
  only where the reference's top-2 logit margin is within 1e-4, float32
  ties of a random-init smoke model), recoveries, steals, lost, discarded
  tokens, statuses, rejects, and the router's trace events on a virtual
  clock that ticks once a ``step_all`` (the ``route`` score left out and
  the engines' hardware named alike: the two packages' default hardware
  models differ, so the score's value does).

The engines serve the qwen2-1.5b smoke config, the JAX parameters converted
through numpy.
"""
import dataclasses
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.obs as jax_obs  # noqa: E402
import repro.serve as jax_serve  # noqa: E402
import repro_torch.obs as torch_obs  # noqa: E402
import repro_torch.serve as torch_serve  # noqa: E402
from repro import configs as jax_configs  # noqa: E402
from repro import kernels as jax_kernels  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.serve import faults as jax_faults  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve import faults as torch_faults  # noqa: E402

EDGES = (8, 64)
NEW_TOKENS = 3
MARGIN_TOL = 1e-4


# ---------------------------------------------------------------------------
# The injector (no model)
# ---------------------------------------------------------------------------

def _script_order(f):
    script = f.FaultScript([f.FaultEvent(5, "stall", "b"),
                            f.FaultEvent(2, "kill", "a")])
    script.add(f.FaultEvent(2, "degrade", "c", factor=3.0))
    assert [e.step for e in script.events] == [2, 2, 5]
    # Same-step events keep their scripted order (a stable sort).
    assert [e.action for e in script.events_at(2)] == ["kill", "degrade"]
    inj = f.FaultInjector(script)
    fired = [e.action for e in inj.advance(2)]
    assert fired == ["kill", "degrade"]
    assert inj.is_killed("a") and inj.latency_factor("c") == 3.0
    assert inj.advance(2) == []             # each event fires exactly once
    later = [e.action for e in inj.advance(9)]
    assert later == ["stall"] and inj.is_stalled("b")
    return fired, later, script.max_step(), sorted(inj.killed)


def _recover_and_kill(f):
    inj = f.FaultInjector(f.FaultScript([
        f.FaultEvent(1, "stall", "a"),
        f.FaultEvent(2, "kill", "a"),        # a kill supersedes the stall
        f.FaultEvent(3, "recover", "a"),
    ]))
    states = []
    for step in (1, 2, 3):
        inj.advance(step)
        states.append((inj.is_killed("a"), inj.is_stalled("a"),
                       inj.latency_factor("a")))
    assert states == [(False, True, 1.0), (True, False, 1.0),
                      (False, False, 1.0)]
    return states


def _validation(f):
    refused = []
    for args, kw in [((0, "explode", "a"), {}), ((-1, "kill", "a"), {}),
                     ((0, "degrade", "a"), {"factor": 0.0}),
                     ((0, "join", "a"), {})]:
        with pytest.raises(ValueError):
            f.FaultEvent(*args, **kw)
        refused.append(args[1])
    assert f.EngineFault("x").instance == "x"
    assert "dead" in str(f.EngineFault("x"))
    return refused, f.ACTIONS


@pytest.mark.parametrize("case", [_script_order, _recover_and_kill,
                                  _validation],
                         ids=["script_ordered_fires_once",
                              "recover_clears_kill_overrides_stall",
                              "event_validation"])
def test_injector_matches_the_jax_injector(case):
    assert case(torch_faults) == case(jax_faults)


# ---------------------------------------------------------------------------
# Two fleets, one per package
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Pkg:
    """One package's serving API and its smoke model."""

    serve: types.ModuleType
    obs: types.ModuleType
    cfg: object
    params: object
    engine_kw: dict


@pytest.fixture(scope="module")
def pkgs():
    jax_kernels.register_all()  # the JAX router scores default tiles
    cfg_j = jax_configs.get_smoke("qwen2-1.5b")
    cfg_t = configs.get_smoke("qwen2-1.5b")
    pj = jax_api.init_params(cfg_j, jax.random.PRNGKey(0))
    pt = params_from_jax(cfg_t, jax.tree.map(np.asarray, pj), device="cpu")
    return (Pkg(jax_serve, jax_obs, cfg_j, pj, {}),
            Pkg(torch_serve, torch_obs, cfg_t, pt, {"device": "cpu"}))


class Clock:
    t = 0.0

    def __call__(self):
        return self.t


def _prompts(cfg, n, seed=3, lo=4, hi=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, cfg.vocab_size,
                         size=rng.integers(lo, hi)).astype(np.int32)
            for _ in range(n)]


def _engine(pkg, policy, clock, slots=2, instance=None):
    s = pkg.serve
    return s.ServeEngine(pkg.cfg, pkg.params, max_len=max(EDGES) + 16,
                         slots=slots, scheduler=s.ShapeBucketScheduler(policy),
                         clock=clock, instance=instance, **pkg.engine_kw)


def _fleet(pkg, names=("a", "b"), watchdog=3, budget=2, events=None,
           max_queue=99, slots=2):
    """A traced fleet on a virtual clock that ticks once a ``step_all``;
    ``events`` is a list of ``FaultEvent`` argument tuples, or a function
    of the package and clock giving one (for join factories)."""
    s = pkg.serve
    clock = Clock()
    policy = s.BucketPolicy(EDGES, max_queue=max_queue)
    if callable(events):
        events = events(pkg, clock, policy)
    injector = (s.FaultInjector(s.FaultScript(
        [s.FaultEvent(*e) if isinstance(e, tuple) else e for e in events]))
        if events is not None else None)
    tracer = pkg.obs.Tracer(clock=clock)
    router = s.FleetRouter(
        {n: _engine(pkg, policy, clock, slots=slots, instance=n)
         for n in names}, policy, tracer=tracer,
        watchdog_threshold=watchdog, retry_budget=budget, injector=injector)
    real = router.step_all

    def step_all():
        clock.t += 1.0
        return real()

    router.step_all = step_all
    router.test_clock, router.test_tracer = clock, tracer
    return router


def _route_all(router, prompts):
    for p in prompts:
        assert router.route(p, max_new_tokens=NEW_TOKENS) is not None


def _record(router, **extra):
    """What the two fleets must agree on (the engines' hardware named
    ``default`` in the events: each package has its own default)."""
    hw = {eng.hardware.name for eng in router.engines.values()}
    events = []
    for ev in router.test_tracer.events:
        args = {k: "default" if k == "hardware" and v in hw else v
                for k, v in (ev.get("args") or {}).items()
                if not (ev["name"] == "route" and k == "score")}
        events.append((ev["name"], ev["cat"], ev["tid"], ev["ts"], args))
    fleet = router.metrics()["fleet"]
    return dict(results=router.results(),
                prompts={fid: fr.prompt.tolist()
                         for fid, fr in router._fleet.items()},
                recoveries=router.recoveries, steals=router.steals,
                lost=router.lost, tokens_discarded=fleet["tokens_discarded"],
                orphans=fleet["orphans"],
                instance_steps=fleet["instance_steps"],
                status=dict(router.status), rejects=dict(router.rejects),
                events=events, **extra)


def _jax_margin(pkg, tokens) -> float:
    logits = jax_api.prefill(pkg.params, pkg.cfg,
                             {"tokens": jnp.asarray(tokens)[None]},
                             max_len=len(tokens))[0][0, :pkg.cfg.vocab_size]
    top = np.sort(np.asarray(logits))[-2:]
    return float(top[1] - top[0])


def _assert_same_results(jpkg, got, want, prompts):
    assert sorted(got) == sorted(want)
    for fid, ref in want.items():
        out = got[fid]
        assert len(out) == len(ref)
        for i, (a, b) in enumerate(zip(out, ref)):
            if a != b:
                ctx = np.concatenate([prompts[fid], ref[:i]]).astype(np.int32)
                margin = _jax_margin(jpkg, ctx)
                assert margin <= MARGIN_TOL, \
                    f"fid {fid} token {i}: {a} != {b}, margin {margin:.3g}"
                break     # past a tie the two streams may rightly part


def _assert_fleets_agree(jpkg, want, got):
    for key in [k for k in want if k.endswith("results")]:
        _assert_same_results(jpkg, got[key], want[key], want["prompts"])
    assert got["prompts"] == want["prompts"]
    rest = [k for k in want if not k.endswith("results")]
    assert {k: got[k] for k in rest} == {k: want[k] for k in rest}


# ---------------------------------------------------------------------------
# The scenarios (each asserts the reference's contract and returns a record)
# ---------------------------------------------------------------------------

def kill_recovery_zero_loss_token_parity(pkg):
    prompts = _prompts(pkg.cfg, 6)

    def run(events):
        router = _fleet(pkg, events=events)
        _route_all(router, prompts)
        router.run_until_done(max_steps=500)
        return router

    base = run(None)
    chaos = run([(2, "kill", "b")])
    assert chaos.status["b"] == "dead"
    assert chaos.recoveries >= 1, "kill never forced a recovery"
    assert chaos.lost == 0
    assert set(chaos.results()) == set(base.results()) == set(range(6))
    assert chaos.results() == base.results(), \
        "recovered requests did not reproduce the undisturbed greedy tokens"
    return _record(chaos, base_results=base.results())


def kill_recovery_preserves_submit_anchor(pkg):
    """A recovered request's TTFT runs from its original submit."""
    router = _fleet(pkg, events=[(3, "kill", "b")])
    _route_all(router, _prompts(pkg.cfg, 6))
    for _ in range(500):
        if not router.step_all() and not router.pending():
            break
    assert router.recoveries >= 1
    samples = sorted(s for eng in router.engines.values()
                     for s in eng.metrics.ttft_since(None))
    # The kill fires at t = 3; a recovered request's first token comes
    # later, so an anchor reset at the re-queue would give a smaller max.
    assert max(samples) > 3.0, samples
    return _record(router, ttft=samples)


def engine_fault_exception_marks_dead(pkg):
    """An engine whose step raises EngineFault is found dead and its work
    recovered, with or without an injector."""
    router = _fleet(pkg)
    _route_all(router, _prompts(pkg.cfg, 4))
    blown = router.engines["b"]

    def dying_step():
        raise pkg.serve.EngineFault("b")

    blown.step = dying_step
    router.step_all()
    assert router.status["b"] == "dead"
    router.run_until_done(max_steps=500)
    done = sum(len(e._finished) for e in router.engines.values())
    assert done == 4 and router.lost == 0
    return _record(router)


def stall_watchdog_detects_and_recovers(pkg):
    router = _fleet(pkg, watchdog=3, events=[(1, "stall", "b")])
    _route_all(router, _prompts(pkg.cfg, 6))
    router.run_until_done(max_steps=500)
    assert router.status["b"] == "stalled"
    assert router.recoveries >= 1
    assert set(router.results()) == set(range(6)) and router.lost == 0
    return _record(router)


def retry_budget_bounds_recovery(pkg):
    """retry_budget=0: the first failure is terminal, counted and traced."""
    router = _fleet(pkg, budget=0, events=[(2, "kill", "b")])
    _route_all(router, _prompts(pkg.cfg, 6))
    placed_on_b = {d.fid for d in router.decisions if d.instance == "b"}
    router.run_until_done(max_steps=500)
    assert placed_on_b, "routing sent nothing to b; the kill had no victims"
    assert router.lost == len(placed_on_b)
    assert router.rejects.get("retry_budget", 0) == router.lost
    assert set(router.results()) == set(range(6)) - placed_on_b
    return _record(router, placed_on_b=sorted(placed_on_b))


def graceful_drain_hands_off_queue(pkg):
    router = _fleet(pkg, slots=1)
    _route_all(router, _prompts(pkg.cfg, 8))
    queued_on_b = router.engines["b"].scheduler.pending()
    handoff = router.drain("b")
    assert handoff == queued_on_b
    assert router.status["b"] == "draining"
    d = router.route(_prompts(pkg.cfg, 1, seed=9)[0],
                     max_new_tokens=NEW_TOKENS)
    assert d is not None and d.instance != "b"   # no new work on b
    router.run_until_done(max_steps=500)
    assert router.status["b"] == "drained"       # finished in place
    assert len(router.results()) == 9 and router.lost == 0
    assert all(fr.retries == 0 for fr in router._fleet.values())
    return _record(router, handoff=handoff)


def join_mid_run_takes_work(pkg):
    router = _fleet(pkg, names=("a",), slots=1)
    _route_all(router, _prompts(pkg.cfg, 8))
    router.step_all()
    joiner = _engine(pkg, router.policy, router.test_clock, slots=1,
                     instance="b")
    router.join("b", joiner)
    assert router.status["b"] == "live"
    with pytest.raises(ValueError):
        router.join("b", joiner)             # a live name is not reusable
    router.run_until_done(max_steps=500)
    done = sum(len(e._finished) for e in router.engines.values())
    assert done == 8 and router.lost == 0
    assert len(joiner._finished) >= 1 and router.steals >= 1
    return _record(router, joiner_done=len(joiner._finished))


def steal_rebalances_direct_backlog(pkg):
    """Requests added on one engine directly are still rebalanced."""
    router = _fleet(pkg, slots=1)
    for p in _prompts(pkg.cfg, 6):
        assert router.engines["a"].add_request(
            p, max_new_tokens=NEW_TOKENS) is not None
    router.run_until_done(max_steps=500)
    assert router.steals >= 1
    assert sum(len(e._finished) for e in router.engines.values()) == 6
    assert len(router.engines["b"]._finished) >= 1
    return _record(router, finished={
        n: sorted(r.rid for r in e._finished)
        for n, e in router.engines.items()})


def route_fails_over_on_engine_reject(pkg):
    router = _fleet(pkg, max_queue=1)
    prompts = _prompts(pkg.cfg, 3, seed=5)
    d1 = router.route(prompts[0], max_new_tokens=NEW_TOKENS)
    d2 = router.route(prompts[1], max_new_tokens=NEW_TOKENS)
    assert d1 is not None and d2 is not None
    assert {d1.instance, d2.instance} == {"a", "b"}
    assert router.route(prompts[2], max_new_tokens=NEW_TOKENS) is None
    assert sum(router.rejects.values()) == 1, router.rejects
    router.run_until_done(max_steps=500)
    assert len(router.results()) == 2
    return _record(router)


def dead_fleet_rejects_with_reason(pkg):
    router = _fleet(pkg, events=[(1, "kill", "a"), (1, "kill", "b")])
    router.step_all()
    assert router.route(_prompts(pkg.cfg, 1)[0],
                        max_new_tokens=NEW_TOKENS) is None
    assert router.rejects.get("no_healthy_instance") == 1
    return _record(router)


def run_until_done_raises_fleet_exhausted(pkg):
    router = _fleet(pkg, names=("a",), watchdog=10 ** 6,
                    events=[(1, "stall", "a")])
    assert router.route(_prompts(pkg.cfg, 1)[0],
                        max_new_tokens=NEW_TOKENS) is not None
    with pytest.raises(pkg.serve.FleetExhausted) as exc:
        router.run_until_done(max_steps=8)
    assert exc.value.max_steps == 8 and "a" in exc.value.pending
    counts = exc.value.pending["a"]
    assert counts["in_flight"] + counts["queued"] >= 1
    assert math.isfinite(exc.value.orphans)
    return _record(router, pending=exc.value.pending, message=str(exc.value))


def rejoin_dead_name_preserves_finished_results(pkg):
    router = _fleet(pkg, slots=1, events=[(4, "kill", "b")])
    _route_all(router, _prompts(pkg.cfg, 6))
    router.run_until_done(max_steps=500)
    assert router.status["b"] == "dead"
    assert router.engines["b"]._finished, "nothing finished on b"
    before = router.results()
    assert set(before) == set(range(6)) and router.lost == 0
    router.join("b", _engine(pkg, router.policy, router.test_clock, slots=1,
                             instance="b"))
    assert router.status["b"] == "live"
    assert router.results() == before, \
        "rejoin under a dead name discarded the old engine's finished work"
    assert router.route(_prompts(pkg.cfg, 1, seed=9)[0],
                        max_new_tokens=NEW_TOKENS) is not None
    router.run_until_done(max_steps=500)
    assert set(router.results()) == set(range(7))
    return _record(router, before_results=before)


def placement_tables_exclude_unroutable(pkg):
    router = _fleet(pkg, events=[(1, "kill", "b")])
    tables = [router.placement_table()]
    assert set(tables[0]) == set(EDGES)
    assert set(tables[0].values()) <= {"a", "b"}
    router.step_all()                        # the kill lands
    assert router.status["b"] == "dead" and "b" in router.engines
    tables.append(router.placement_table())
    assert set(tables[1]) == set(EDGES) and set(tables[1].values()) == {"a"}
    router.drain("a")                        # draining is not routable
    assert router.placement_table() == {}
    assert router.tile_table(min(EDGES)) == {}
    return _record(router, tables=tables)


def recover_while_draining_resumes_drain(pkg):
    router = _fleet(pkg, slots=1, watchdog=2,
                    events=[(3, "stall", "b"), (9, "recover", "b")])
    _route_all(router, _prompts(pkg.cfg, 6))
    router.step_all()
    router.step_all()
    router.drain("b")
    assert router.status["b"] == "draining"
    seen = []
    for _ in range(200):
        progressed = router.step_all()
        seen.append(router.status["b"])
        assert router.status["b"] != "live", \
            "recover flipped a draining instance back into rotation"
        if not progressed and not router.pending():
            break
    assert "stalled" in seen, "b finished draining before the stall"
    assert router.status["b"] == "drained"
    assert set(router.results()) == set(range(6)) and router.lost == 0
    return _record(router, statuses=seen)


def _churn_events(pkg, clock, policy):
    s = pkg.serve

    def mk():
        return _engine(pkg, policy, clock, slots=1, instance="b")

    return [s.FaultEvent(2, "kill", "b"), s.FaultEvent(6, "recover", "b"),
            s.FaultEvent(6, "join", "b", make_engine=mk),
            s.FaultEvent(9, "kill", "b")]


def orphan_churn_accounting_consistent(pkg):
    """Kill / rejoin / kill on one name: a fid is lost at most once, lost
    equals the retry-budget rejects, discarded tokens add up."""
    router = _fleet(pkg, slots=1, budget=1, events=_churn_events)
    _route_all(router, _prompts(pkg.cfg, 8))
    router.run_until_done(max_steps=500)
    m = router.metrics()["fleet"]
    lost_fids = {fid for fid, fr in router._fleet.items() if fr.lost}
    assert len(lost_fids) == router.lost == m["lost"]
    assert router.rejects.get("retry_budget", 0) == router.lost
    assert m["tokens_discarded"] == sum(
        fr.tokens_discarded for fr in router._fleet.values())
    assert m["recoveries"] == router.recoveries >= 1
    assert m["orphans"] == 0
    assert set(router.results()) == set(range(8)) - lost_fids
    assert all(fr.retries <= 2 for fr in router._fleet.values())
    return _record(router, lost_fids=sorted(lost_fids),
                   retries={fid: fr.retries
                            for fid, fr in router._fleet.items()})


def fleet_exhausted_orphans_match_metrics(pkg):
    router = _fleet(pkg, events=[(2, "kill", "a"), (2, "kill", "b")])
    _route_all(router, _prompts(pkg.cfg, 4))
    with pytest.raises(pkg.serve.FleetExhausted) as exc:
        router.run_until_done(max_steps=8)
    assert exc.value.orphans > 0
    assert exc.value.orphans == router.metrics()["fleet"]["orphans"]
    assert exc.value.orphans == router.orphan_count()
    return _record(router, exhausted_orphans=exc.value.orphans)


SCENARIOS = [
    kill_recovery_zero_loss_token_parity,
    kill_recovery_preserves_submit_anchor,
    engine_fault_exception_marks_dead,
    stall_watchdog_detects_and_recovers,
    retry_budget_bounds_recovery,
    graceful_drain_hands_off_queue,
    join_mid_run_takes_work,
    steal_rebalances_direct_backlog,
    route_fails_over_on_engine_reject,
    dead_fleet_rejects_with_reason,
    run_until_done_raises_fleet_exhausted,
    rejoin_dead_name_preserves_finished_results,
    placement_tables_exclude_unroutable,
    recover_while_draining_resumes_drain,
    orphan_churn_accounting_consistent,
    fleet_exhausted_orphans_match_metrics,
]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[f.__name__ for f in SCENARIOS])
def test_fleet_scenario_matches_the_jax_fleet(scenario, pkgs):
    jpkg, tpkg = pkgs
    want = scenario(jpkg)
    got = scenario(tpkg)
    _assert_fleets_agree(jpkg, want, got)
