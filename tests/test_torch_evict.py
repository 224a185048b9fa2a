"""The port engine's eviction hooks (``cancel``, ``evict_all``,
``extract_queued``, ``_evict_state``) on the CPU.

* Against the JAX engine, ``tests/test_serve_paged.py``'s three teardown
  cases: a request cancelled mid-prefill, ``evict_all`` over a full
  pipeline (decoding, prefilling, ready, queued) then a re-admission, and a
  prefix donor cancelled under a live recipient. The same tokens (a token
  may differ only where the reference's top-2 logit margin is within 1e-4)
  and the same pool counters; allocs = frees.
* The port's own state: an evicted decode slot keeps every tensor (the
  ``data_ptr`` of its caches, token, logits, next token and table) and its
  graph, so the card replays what it captured, and the trace records no
  ``finish`` for it; every cache set goes back to
  the free list (``cache_sets_made`` flat over five kill/re-admit cycles,
  cancels from each stage included); a paged slot re-filled after an
  eviction holds the new request's page table.

The engines serve the qwen2-1.5b smoke config, the JAX parameters converted
through numpy.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.serve as jax_serve  # noqa: E402
import repro_torch.serve as torch_serve  # noqa: E402
from repro import configs as jax_configs  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.obs import Tracer  # noqa: E402

EDGES = (8, 64)
NEW_TOKENS = 3
PAGE = 16
MARGIN_TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    cfg_j = jax_configs.get_smoke("qwen2-1.5b")
    cfg_t = configs.get_smoke("qwen2-1.5b")
    pj = jax_api.init_params(cfg_j, jax.random.PRNGKey(0))
    pt = params_from_jax(cfg_t, jax.tree.map(np.asarray, pj), device="cpu")
    return {"jax": (jax_serve, cfg_j, pj, {}),
            "torch": (torch_serve, cfg_t, pt, {"device": "cpu"})}


def _engine(model, mode="chunked", paged=True, budget=8, slots=2,
            prefill_slots=3, **kw):
    s, cfg, params, dev = model
    return s.ServeEngine(
        cfg, params, max_len=max(EDGES) + 16, slots=slots,
        scheduler=s.ShapeBucketScheduler(s.BucketPolicy(EDGES, max_queue=99)),
        chunk_prefill=mode != "unchunked", pack_prefill=mode == "packed",
        prefill_slots=prefill_slots,
        step_token_budget=budget if mode != "unchunked" else 0,
        paged=paged, page_size=PAGE if paged else None, **dev, **kw)


def _drain(eng, max_steps=200):
    for _ in range(max_steps):
        eng.step()
        if not eng.in_flight() and not eng.scheduler.pending():
            return
    pytest.fail("engine did not drain")


def _pool(eng):
    eng.pool.check_balanced()
    pm = eng.metrics.as_dict()["pool"]
    assert pm["page_allocs"] == pm["page_frees"]
    return pm


def _jax_margin(model, tokens) -> float:
    _, cfg, params, _ = model
    logits = jax_api.prefill(params, cfg, {"tokens": jnp.asarray(tokens)[None]},
                             max_len=len(tokens))[0][0, :cfg.vocab_size]
    top = np.sort(np.asarray(logits))[-2:]
    return float(top[1] - top[0])


def _hold(model, prompts, got, want):
    """Token streams keyed alike: equal, or parting after a tie."""
    assert set(got) == set(want)
    for key, ref in want.items():
        for i, (a, b) in enumerate(zip(got[key], ref)):
            if a != b:
                ctx = np.concatenate([prompts[key], ref[:i]]).astype(np.int32)
                assert _jax_margin(model, ctx) <= MARGIN_TOL
                break


def cancel_mid_prefill_teardown(model):
    """A request cancelled mid-chunked-prefill: its pages go back balanced,
    the cancel is idempotent, and the survivor's tokens equal a run that
    never saw the cancelled request."""
    _, cfg, _, _ = model
    rng = np.random.default_rng(11)
    long_p = rng.integers(2, cfg.vocab_size, size=40).astype(np.int32)
    short_p = rng.integers(2, cfg.vocab_size, size=6).astype(np.int32)
    eng = _engine(model)
    victim = eng.add_request(long_p, max_new_tokens=NEW_TOKENS)
    other = eng.add_request(short_p, max_new_tokens=NEW_TOKENS)
    eng.step()                   # budget 8 << 40: the victim is mid-prefill
    assert any(j.req.rid == victim for j in eng._chunking)
    req = eng.cancel(victim)
    assert req is not None and req.rid == victim
    assert eng.cancel(victim) is None        # gone: no double free
    _drain(eng)
    pm = _pool(eng)
    tokens = {r.rid: tuple(r.out_tokens) for r in eng._finished}
    assert victim not in tokens and other in tokens
    solo = _engine(model)
    solo_rid = solo.add_request(short_p, max_new_tokens=NEW_TOKENS)
    _drain(solo)
    solo_tokens = {r.rid: tuple(r.out_tokens) for r in solo._finished}
    assert tokens[other] == solo_tokens[solo_rid]
    return {"other": tokens[other]}, {"other": short_p}, pm, None


def evict_all_mid_flight_balanced(model):
    """evict_all over decoding, prefilling, ready and queued requests
    returns every unfinished one, balances the pool, and leaves the engine
    serviceable: a re-admitted evicted prompt gives a fresh engine's
    tokens (re-prefilled from its prompt, not from the torn-down state)."""
    _, cfg, _, _ = model
    rng = np.random.default_rng(12)
    prompts = [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32)
               for n in (6, 40, 30, 5)]
    eng = _engine(model, prefill_slots=2)
    for p in prompts:
        assert eng.add_request(p, max_new_tokens=NEW_TOKENS) is not None
    eng.step()
    eng.step()                   # decode slots, a partial, queued work
    finished = {r.rid for r in eng._finished}
    stages = (sum(r is not None for r in eng._active), len(eng._chunking),
              len(eng._ready), eng.scheduler.pending())
    evicted = eng.evict_all()
    assert {r.rid for r in evicted} == set(range(len(prompts))) - finished
    assert eng.in_flight() == 0 and eng.scheduler.pending() == 0
    pm_evicted = _pool(eng)
    rid = eng.add_request(prompts[1], max_new_tokens=NEW_TOKENS)
    assert rid is not None
    _drain(eng)
    pm = _pool(eng)
    redone = next(r for r in eng._finished if r.rid == rid)
    fresh = _engine(model)
    fresh_rid = fresh.add_request(prompts[1], max_new_tokens=NEW_TOKENS)
    _drain(fresh)
    want = next(r for r in fresh._finished if r.rid == fresh_rid)
    assert tuple(redone.out_tokens) == tuple(want.out_tokens)
    evicted_tokens = {r.rid: tuple(r.out_tokens) for r in evicted}
    return (dict(evicted_tokens, redone=tuple(redone.out_tokens)),
            dict({r.rid: r.prompt for r in evicted}, redone=prompts[1]),
            (pm_evicted, pm), stages)


def cancel_shared_prefix_donor(model):
    """A donor cancelled while a recipient maps its pages: the refcounts
    keep them, the recipient's tokens equal a run without sharing, and the
    drained pool balances."""
    s, cfg, params, dev = model
    assert s.supports_prefix_sharing(cfg)
    rng = np.random.default_rng(7)
    donor = rng.integers(2, cfg.vocab_size, size=10).astype(np.int32)
    recipient = np.concatenate(
        [donor, rng.integers(2, cfg.vocab_size, size=5).astype(np.int32)])

    def run(sharing, cancel_donor):
        eng = s.ServeEngine(cfg, params, max_len=64, slots=2,
                            prefill_slots=2, paged=True, page_size=4,
                            prefix_sharing=sharing, **dev)
        d = eng.add_request(donor, max_new_tokens=8)
        eng.step()               # the donor prefills and registers
        eng.add_request(recipient, max_new_tokens=8)
        eng.step()               # the recipient maps the donor's pages
        if cancel_donor:
            assert eng.cancel(d) is not None
        _drain(eng)
        eng.pool.check_balanced()
        return ({r.rid: tuple(r.out_tokens) for r in eng._finished},
                eng.metrics.as_dict()["pool"])

    cancelled, shared_pool = run(True, True)
    plain, _ = run(False, False)
    assert 0 not in cancelled, "a cancelled donor must not finish"
    assert cancelled[1] == plain[1]
    assert shared_pool["prefix_hits"] >= 1
    assert shared_pool["page_allocs"] == shared_pool["page_frees"]
    return {1: cancelled[1]}, {1: recipient}, shared_pool, None


CASES = [cancel_mid_prefill_teardown, evict_all_mid_flight_balanced,
         cancel_shared_prefix_donor]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_paged_teardown_matches_the_jax_engine(case, models):
    tok_t, prompts, pool_t, extra_t = case(models["torch"])
    tok_j, _, pool_j, extra_j = case(models["jax"])
    _hold(models["jax"], prompts, tok_t, tok_j)
    assert pool_t == pool_j
    assert extra_t == extra_j


# ---------------------------------------------------------------------------
# The port's own state: slots, cache sets, page tables
# ---------------------------------------------------------------------------

def _slot_ptrs(slot):
    ptrs = [slot.token.data_ptr(), slot.logits.data_ptr(),
            slot.next_token.data_ptr()]
    if slot.table is not None:
        ptrs.append(slot.table.data_ptr())
    for cache in slot.caches:
        ptrs += [cache[k].data_ptr() for k in sorted(cache)]
    return ptrs


@pytest.mark.parametrize("mode,paged", [("unchunked", False),
                                        ("chunked", False),
                                        ("chunked", True)])
def test_an_evicted_slot_keeps_its_tensors_and_graph(models, mode, paged):
    model = models["torch"]
    _, cfg, _, _ = model
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32)
               for n in (6, 20, 7, 12)]
    tracer = Tracer()
    eng = _engine(model, mode=mode, paged=paged, budget=32, tracer=tracer)
    for p in prompts[:2]:
        eng.add_request(p, max_new_tokens=6)
    while not all(r is not None for r in eng._active):
        eng.step()
    ptrs = [_slot_ptrs(s) for s in eng._slots]
    # A stand-in for each slot's captured graph: eviction must not drop
    # it, or the card would recapture the slot.
    graphs = [object() for _ in eng._slots]
    for slot, g in zip(eng._slots, graphs):
        slot.graph = g
    evicted = eng.evict_all()
    assert len(evicted) == 2 and all(len(r.out_tokens) >= 1 for r in evicted)
    assert eng._active == [None] * eng.slots
    for p in prompts[2:]:
        eng.add_request(p, max_new_tokens=6)
    _drain(eng)
    assert [s.graph for s in eng._slots] == graphs
    assert [_slot_ptrs(s) for s in eng._slots] == ptrs
    # The re-filled slots served what a fresh engine serves.
    fresh = _engine(model, mode=mode, paged=paged, budget=32)
    for p in prompts[2:]:
        fresh.add_request(p, max_new_tokens=6)
    _drain(fresh)
    assert ([r.out_tokens for r in eng._finished]
            == [r.out_tokens for r in fresh._finished])
    # The trace finishes the requests served, never the evicted ones.
    finished = [ev["args"]["rid"] for ev in tracer.events
                if ev["name"] == "finish"]
    assert sorted(finished) == sorted(r.rid for r in eng._finished)
    assert not {r.rid for r in evicted} & set(finished)
    if paged:
        _pool(eng)


def test_cache_sets_return_to_the_free_list(models):
    """Five kill / re-admit cycles, each evicting a finished prefill
    waiting for the slot and one in flight, then cancels from both: every
    cache set comes back, and no new one is made after the first cycle."""
    model = models["torch"]
    _, cfg, _, _ = model
    rng = np.random.default_rng(6)
    prompts = [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32)
               for n in (40, 6, 30, 5, 50)]
    eng = _engine(model, paged=False, slots=1, prefill_slots=2, budget=12)

    def fill():
        for p in prompts:                   # long enough to hold the slot
            assert eng.add_request(p, max_new_tokens=12) is not None
        for _ in range(40):
            if eng._ready and any(j.state is not None for j in eng._chunking):
                return
            eng.step()
        pytest.fail("no prefill waiting for the slot beside one in flight")

    made = []
    for _ in range(5):
        fill()
        eng.evict_all()
        assert len(eng._free_sets) == eng.cache_sets_made
        made.append(eng.cache_sets_made)
    assert made == [made[0]] * 5
    assert made[0] <= eng.slots + eng.prefill_slots
    fill()
    req = eng._ready[0][0]
    assert eng.cancel(req.rid) is req
    job = next(j for j in eng._chunking if j.state is not None)
    assert eng.cancel(job.req.rid) is job.req
    _drain(eng)
    assert len(eng._free_sets) == eng.cache_sets_made == made[0]


def test_a_refilled_paged_slot_holds_the_new_table(models):
    model = models["torch"]
    _, cfg, _, _ = model
    rng = np.random.default_rng(8)
    first = rng.integers(2, cfg.vocab_size, size=30).astype(np.int32)
    second = rng.integers(2, cfg.vocab_size, size=5).astype(np.int32)
    eng = _engine(model, slots=1, budget=40, prefix_sharing=False)
    eng.add_request(first, max_new_tokens=8)
    while eng._active[0] is None:
        eng.step()
    eng.step()
    slot = eng._slots[0]
    stale = list(slot.table_host)            # bucket 64: 5 pages of 16
    eng.evict_all()
    _pool(eng)
    rid = eng.add_request(second, max_new_tokens=8)
    while eng._active[0] is None:
        eng.step()
    eng.step()
    table = eng.pool.tables[rid]
    assert slot.table_host == table and len(table) < len(stale)
    n = len(table)
    assert slot.table[:n].tolist() == table
    assert slot.table[n:].tolist() == [0] * (eng.pool.n_pt - n)
