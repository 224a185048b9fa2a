"""The port's autoscaler on the CPU, against the JAX one
(``tests/test_autoscale.py``'s 13 cases).

* The policy (``serve/autoscale.py``): each of the reference's eleven
  scripted cases drives both packages' ``AutoscalePolicy`` through the
  same fake fleet (the adapter protocol with signals set by hand). The
  reference's assertions hold on both, and the two policies make the same
  decisions (``as_dict()``: every decision with its signal snapshot, the
  counters, the streak and the cooldown) and the same joins and drains.
* The router (``serve/fleet.py``): a backlogged one-instance fleet of the
  port's engines joins a second one, serves everything and drains back to
  one, with the JAX fleet's decisions, results and counters on a virtual
  clock; and the router's side of the adapter protocol (traffic mix, TTFT
  windows, pool occupancy, candidate pricing) against the JAX router's.

The engines serve the qwen2-1.5b smoke config, the JAX parameters converted
through numpy.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import repro.serve as jax_serve  # noqa: E402
import repro_torch.serve as torch_serve  # noqa: E402
from repro import configs as jax_configs  # noqa: E402
from repro import kernels as jax_kernels  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.serve import autoscale as jax_autoscale  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve import autoscale as torch_autoscale  # noqa: E402

EDGES = (8, 64)
NEW_TOKENS = 3


# ---------------------------------------------------------------------------
# A scripted fake fleet (no model)
# ---------------------------------------------------------------------------

class FakeFleet:
    """The adapter protocol with signals set by hand."""

    def __init__(self, members=(("a", "hw_base"),), cand_cost=None):
        self.members = dict(members)          # name -> hardware
        self.queues = {n: 0 for n in self.members}
        self.ttfts = []
        self.mix = {}
        self.nt_sum = 0
        self.nt_n = 0
        self.occupancy = 0.0
        self.orphans = 0
        # hardware -> mix-weighted seconds a request (what the pricing
        # calls report; the cases steer selection through it).
        self.cand_cost = dict(cand_cost or {})
        self.joined = []
        self.drained = []
        self.recorded = []

    def live_instances(self):
        return sorted(n for n in self.members if n not in self.drained)

    def known_instances(self):
        return set(self.members)

    def instance_hardware(self, name):
        return self.members.get(name)

    def queue_depths(self):
        return dict(self.queues)

    def ttft_marks(self):
        return len(self.ttfts)

    def ttft_window_since(self, mark):
        return list(self.ttfts[mark or 0:]), False

    def traffic_mix(self):
        return dict(self.mix), self.nt_sum, self.nt_n

    def pool_occupancy(self):
        return self.occupancy

    def orphan_count(self):
        return self.orphans

    def price_instance(self, name, mix, nt):
        return self.cand_cost.get(self.members[name], 1.0)

    def price_candidate(self, cand, mix, nt):
        return self.cand_cost.get(cand.hardware, 1.0)

    def scale_join(self, name, engine):
        self.members[name] = engine["hw"]
        self.queues[name] = 0
        self.joined.append(name)

    def scale_drain(self, name):
        self.drained.append(name)

    def record_autoscale(self, decision):
        self.recorded.append(decision)

    def state(self):
        return (self.joined, self.drained,
                [d.as_dict() for d in self.recorded])


def _cand(m, hw, price=1.0, name=None):
    return m.ScaleCandidate(name=name or hw, hardware=hw,
                            make_engine=lambda n, hw=hw: {"name": n, "hw": hw},
                            price=price)


def _policy(m, **kw):
    defaults = dict(min_instances=1, max_instances=4, interval=1, cooldown=0,
                    queue_high=4.0, queue_low=1.0, low_evals=2,
                    min_ttft_samples=2)
    defaults.update(kw)
    cands = defaults.pop("candidates", None) or (_cand(m, "hw_fast"),)
    return m.AutoscalePolicy(cands, **defaults)


def policy_validation(m):
    refused = 0
    for kw in [dict(min_instances=0), dict(min_instances=3, max_instances=2),
               dict(interval=0), dict(cooldown=-1), dict(low_evals=0),
               dict(queue_high=1.0, queue_low=2.0),
               dict(ttft_high=1.0, ttft_low=2.0),
               dict(candidates=(_cand(m, "hw_a"), _cand(m, "hw_a")))]:
        with pytest.raises(ValueError):
            _policy(m, **kw)
        refused += 1
    with pytest.raises(ValueError):
        _cand(m, "hw_a", price=0.0)
    return refused


def interval_gates_evaluations(m):
    fleet = FakeFleet()
    pol = _policy(m, interval=4)
    for step in range(8):
        pol.observe(fleet, step)
    assert pol.as_dict()["evaluations"] == 2      # steps 0 and 4
    return pol.as_dict(), fleet.state()


def scale_up_on_queue_depth_with_cooldown(m):
    fleet = FakeFleet()
    fleet.queues["a"] = 9
    pol = _policy(m, cooldown=1)
    d = pol.observe(fleet, 0)
    assert len(d) == 1 and d[0].action == "join"
    assert d[0].reason == "queue_depth"
    assert d[0].signals["queue_per_instance"] == 9.0
    assert fleet.joined == ["hw_fast"] and fleet.recorded == d
    assert pol.instance_price["hw_fast"] == 1.0
    fleet.queues["a"] = 9
    assert pol.observe(fleet, 1) == []            # the cooldown
    assert len(pol.observe(fleet, 2)) == 1
    return pol.as_dict(), fleet.state()


def scale_up_priority_order_and_bounds(m):
    fleet = FakeFleet()
    fleet.queues["a"] = 9
    fleet.occupancy = 0.99
    fleet.orphans = 2
    fleet.ttfts = [5.0] * 8
    pol = _policy(m, ttft_high=1.0, max_instances=5)
    assert pol.observe(fleet, 0)[0].reason == "orphans"
    fleet.orphans = 0
    fleet.ttfts += [5.0] * 8
    fleet.queues = {n: 9 for n in fleet.members}
    assert pol.observe(fleet, 1)[0].reason == "p95_ttft"
    fleet.ttfts += [0.0] * 8
    fleet.queues = {n: 9 for n in fleet.members}
    assert pol.observe(fleet, 2)[0].reason == "queue_depth"
    fleet.queues = {n: 0 for n in fleet.members}
    assert pol.observe(fleet, 3)[0].reason == "pool_occupancy"
    fleet.orphans = 5
    assert pol.observe(fleet, 4) == []            # at max_instances
    assert pol.as_dict()["joins"] == 4
    return pol.as_dict(), fleet.state()


def ttft_trigger_needs_min_samples(m):
    fleet = FakeFleet()
    fleet.ttfts = [9.0]
    pol = _policy(m, ttft_high=1.0, min_ttft_samples=4)
    assert pol.observe(fleet, 0) == []            # loud but thin
    fleet.ttfts += [9.0] * 4
    d = pol.observe(fleet, 1)
    assert len(d) == 1 and d[0].reason == "p95_ttft"
    return pol.as_dict(), fleet.state()


def candidate_selection_is_price_weighted_by_mix(m):
    cands = (_cand(m, "hw_fast", price=3.0), _cand(m, "hw_cheap", price=1.0))
    fleet = FakeFleet(cand_cost={"hw_fast": 1.0, "hw_cheap": 2.0})
    fleet.queues["a"] = 9
    pol = _policy(m, candidates=cands)
    assert pol.observe(fleet, 0)[0].hardware == "hw_cheap"   # 3.0 vs 2.0
    fleet2 = FakeFleet(cand_cost={"hw_fast": 0.25, "hw_cheap": 2.0})
    fleet2.queues["a"] = 9
    pol2 = _policy(m, candidates=cands)
    d = pol2.observe(fleet2, 0)
    assert d[0].hardware == "hw_fast"                        # 0.75 vs 2.0
    assert pol2.instance_price[d[0].instance] == 3.0
    return pol.as_dict(), pol2.as_dict(), fleet.state(), fleet2.state()


def join_names_never_collide(m):
    fleet = FakeFleet()
    pol = _policy(m, max_instances=3)
    fleet.queues["a"] = 9
    assert pol.observe(fleet, 0)[0].instance == "hw_fast"
    fleet.queues["hw_fast"] = 9
    assert pol.observe(fleet, 1)[0].instance == "hw_fast2"
    return pol.as_dict(), fleet.state()


def scale_down_needs_consecutive_low_evals(m):
    fleet = FakeFleet((("a", "hw_base"), ("b", "hw_base")),
                      cand_cost={"hw_base": 1.0})
    pol = _policy(m, low_evals=3)
    assert pol.observe(fleet, 0) == [] and pol.observe(fleet, 1) == []
    fleet.queues["a"] = 3                         # the dead band
    assert pol.observe(fleet, 2) == []
    assert pol.as_dict()["low_streak"] == 0
    fleet.queues["a"] = 0
    assert pol.observe(fleet, 4) == [] and pol.observe(fleet, 5) == []
    d = pol.observe(fleet, 6)
    assert len(d) == 1 and d[0].action == "drain"
    assert d[0].reason == "low_load" and fleet.drained == [d[0].instance]
    for step in range(7, 20):
        assert pol.observe(fleet, step) == []     # min_instances=1
    assert len(fleet.live_instances()) == 1
    return pol.as_dict(), fleet.state()


def scale_down_drains_worst_price_cost_member(m):
    fleet = FakeFleet((("a", "hw_cheap"), ("b", "hw_fast")),
                      cand_cost={"hw_cheap": 1.0, "hw_fast": 0.9})
    pol = _policy(m, low_evals=1, instance_prices={"a": 1.0, "b": 3.0})
    d = pol.observe(fleet, 0)
    assert d[0].action == "drain" and d[0].instance == "b"
    assert d[0].hardware == "hw_fast"
    return pol.as_dict(), fleet.state()


def max_instances_blocks_join_but_tracks_streak(m):
    fleet = FakeFleet((("a", "hw_base"),))
    pol = _policy(m, max_instances=1, low_evals=2)
    fleet.queues["a"] = 9
    assert pol.observe(fleet, 0) == []
    fleet.queues["a"] = 0
    assert pol.observe(fleet, 1) == [] and pol.observe(fleet, 2) == []
    assert pol.as_dict()["joins"] == 0
    return pol.as_dict(), fleet.state()


def decision_export_shape(m):
    fleet = FakeFleet()
    fleet.queues["a"] = 9
    pol = _policy(m)
    pol.observe(fleet, 7)
    out = pol.as_dict()
    assert out["joins"] == 1 and out["drains"] == 0
    (entry,) = out["log"]
    assert entry["step"] == 7 and entry["action"] == "join"
    assert set(entry["signals"]) >= {
        "queue_depth", "queue_per_instance", "p95_ttft", "pool_occupancy",
        "orphans", "instances"}
    bare = m.ScaleDecision(step=1, action="drain", instance="x",
                           hardware=None, reason="low_load", signals={})
    return out, bare.as_dict(), m.AUTOSCALE_SCHEMA_VERSION, m.UP_REASONS


POLICY_CASES = [
    policy_validation, interval_gates_evaluations,
    scale_up_on_queue_depth_with_cooldown,
    scale_up_priority_order_and_bounds, ttft_trigger_needs_min_samples,
    candidate_selection_is_price_weighted_by_mix, join_names_never_collide,
    scale_down_needs_consecutive_low_evals,
    scale_down_drains_worst_price_cost_member,
    max_instances_blocks_join_but_tracks_streak, decision_export_shape,
]


@pytest.mark.parametrize("case", POLICY_CASES,
                         ids=[f.__name__ for f in POLICY_CASES])
def test_policy_decides_as_the_jax_policy(case):
    assert case(torch_autoscale) == case(jax_autoscale)


# ---------------------------------------------------------------------------
# Inside a FleetRouter (real engines)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jax_kernels.register_all()
    cfg_j = jax_configs.get_smoke("qwen2-1.5b")
    cfg_t = configs.get_smoke("qwen2-1.5b")
    pj = jax_api.init_params(cfg_j, jax.random.PRNGKey(0))
    pt = params_from_jax(cfg_t, jax.tree.map(np.asarray, pj), device="cpu")
    return {"jax": (jax_serve, cfg_j, pj, {}),
            "torch": (torch_serve, cfg_t, pt, {"device": "cpu"})}


def _prompts(cfg, n, seed=3, lo=4, hi=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, cfg.vocab_size,
                         size=rng.integers(lo, hi)).astype(np.int32)
            for _ in range(n)]


class Clock:
    t = 0.0

    def __call__(self):
        return self.t


def _factory(model, policy, clock, slots):
    s, cfg, params, kw = model

    def make_engine(name):
        return s.ServeEngine(cfg, params, max_len=max(EDGES) + 16,
                             slots=slots, scheduler=s.ShapeBucketScheduler(
                                 policy), instance=name, clock=clock, **kw)
    return make_engine


def _autoscale_run(model):
    s, cfg, _, _ = model
    clock = Clock()
    policy = s.BucketPolicy(EDGES, max_queue=99)
    make_engine = _factory(model, policy, clock, slots=1)
    hw = make_engine("probe").hardware.name
    scaler = s.AutoscalePolicy(
        (s.ScaleCandidate(name="b", hardware=hw, make_engine=make_engine),),
        min_instances=1, max_instances=2, interval=1, cooldown=0,
        queue_high=2.0, queue_low=0.0, low_evals=3)
    router = s.FleetRouter({"a": make_engine("a")}, policy,
                           autoscaler=scaler)
    for p in _prompts(cfg, 6):
        assert router.route(p, max_new_tokens=NEW_TOKENS) is not None
    clock.t += 1.0
    router.step_all()                 # the backlog's first evaluation joins
    assert [d.action for d in scaler.decisions] == ["join"]
    join = scaler.decisions[0]
    assert join.instance == "b" and join.reason == "queue_depth"
    assert router.status["b"] == "live"
    assert scaler.instance_price["b"] == 1.0
    for _ in range(200):
        clock.t += 1.0
        router.step_all()
        if any(d.action == "drain" for d in scaler.decisions):
            break
    assert [d.action for d in scaler.decisions] == ["join", "drain"]
    drained = scaler.decisions[1].instance
    clock.t += 1.0
    router.step_all()                 # the empty drainer retires
    assert router.status[drained] == "drained"
    assert len(router.live_instances()) == 1
    assert router.lost == 0 and len(router.results()) == 6
    m = router.metrics()
    assert m["autoscale"]["joins"] == 1 and m["autoscale"]["drains"] == 1
    assert len(m["autoscale"]["log"]) == 2
    assert m["fleet"]["instance_steps"] > 0
    assert len(router.engines["b"]._finished) >= 1
    log = [dict(e, hardware="default" if e["hardware"] == hw
                else e["hardware"]) for e in m["autoscale"]["log"]]
    return dict(results=router.results(), log=log, fleet=m["fleet"],
                status=dict(router.status),
                finished={n: sorted(r.rid for r in e._finished)
                          for n, e in router.engines.items()})


def test_router_autoscales_up_then_back_down(models):
    got = _autoscale_run(models["torch"])
    want = _autoscale_run(models["jax"])
    assert got == want


def _protocol_run(model):
    s, cfg, _, _ = model
    clock = Clock()
    policy = s.BucketPolicy(EDGES, max_queue=99)
    make_engine = _factory(model, policy, clock, slots=2)
    engines = {n: make_engine(n) for n in ("a", "b")}
    router = s.FleetRouter(engines, policy)
    assert router.live_instances() == ["a", "b"]
    assert router.known_instances() == {"a", "b"}
    assert router.instance_hardware("a") == engines["a"].hardware.name
    assert router.instance_hardware("zz") is None
    assert router.traffic_mix() == ({}, 0, 0)
    for p in _prompts(cfg, 4):
        assert router.route(p, max_new_tokens=NEW_TOKENS) is not None
    mix, nt_sum, n = router.traffic_mix()
    assert n == 4 and nt_sum == 4 * NEW_TOKENS
    assert sum(mix.values()) == 4 and set(mix) <= set(EDGES)
    depths = router.queue_depths()
    mark = router.ttft_marks()
    for _ in range(100):
        clock.t += 1.0
        if not router.step_all() and not router.pending():
            break
    samples, clipped = router.ttft_window_since(mark)
    assert len(samples) == 4 and not clipped
    assert router.ttft_window_since(router.ttft_marks()) == ([], False)
    assert router.pool_occupancy() == 0.0
    assert router.orphan_count() == 0
    # A member and a candidate of the same factory price alike.
    cand = s.ScaleCandidate(name="c", hardware="any",
                            make_engine=make_engine)
    got = router.price_candidate(cand, mix, NEW_TOKENS)
    want = router.price_instance("a", mix, NEW_TOKENS)
    assert got == pytest.approx(want, rel=1e-9)
    assert router.price_instance("a", {}, NEW_TOKENS) > 0.0
    return dict(mix=(mix, nt_sum, n), depths=depths,
                samples=sorted(samples), results=router.results())


def test_router_adapter_protocol_surface(models):
    assert _protocol_run(models["torch"]) == _protocol_run(models["jax"])
