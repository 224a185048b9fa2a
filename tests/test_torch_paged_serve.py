"""The port's paged ServeEngine on the CPU: against its own unpaged engine
and against the JAX paged engine (``tests/test_serve_paged.py``'s suite).

* Token parity, the port's paged engine against its unpaged one, on every
  ``benchmarks/traces.py`` family in all three modes (unchunked, chunked,
  packed) at page 16, with the drained pool balanced (``check_balanced``,
  page allocs equal to frees) after every drain.
* The port's paged engine against the JAX paged engine on two families
  and all three modes: the same tokens (where the reference's top-2 logit
  margin exceeds 1e-4; float32, a random-init smoke model can tie), the
  same pool counters and the same ``last_step_stats`` every step.
* Occupancy: the paged engine holds more prefills in flight than
  ``prefill_slots``.
* Copy-on-write: a recipient maps a decoding donor's pages, its partial
  tail page included; tokens equal a run without sharing, with at least
  one prefix hit and one split.
* The lifecycle property (``hypothesis``): every family x mode x seed
  drains to a balanced pool.

The engines serve the qwen2-1.5b smoke config, the JAX parameters converted
through numpy. The fleet's cancel and eviction hooks
(``tests/test_serve_paged.py``'s last tests) come with the fleet.
"""
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                       / "benchmarks"))
import traces as trace_lib  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.serve import BucketPolicy as JaxBucketPolicy  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro.serve import ShapeBucketScheduler as JaxBucketScheduler  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve import (BucketPolicy, ServeEngine,  # noqa: E402
                               ShapeBucketScheduler, supports_prefix_sharing)

EDGES = (8, 64)
NEW_TOKENS = 3
PAGE = 16            # small pages so requests span several table entries
MODES = ("unchunked", "chunked", "packed")
MARGIN_TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    cfg_j = jax_configs.get_smoke("qwen2-1.5b")
    cfg_t = configs.get_smoke("qwen2-1.5b")
    pj = jax_api.init_params(cfg_j, jax.random.PRNGKey(0))
    pt = params_from_jax(cfg_t, jax.tree.map(np.asarray, pj), device="cpu")
    return cfg_j, cfg_t, pj, pt


def _kwargs(mode, paged, budget=32, edges=EDGES, slots=2, prefill_slots=3,
            allow_overflow=False, max_queue=99):
    top = max(edges)
    return dict(
        max_len=(2 * top + 16) if allow_overflow else top + 16, slots=slots,
        chunk_prefill=mode != "unchunked", pack_prefill=mode == "packed",
        prefill_slots=prefill_slots,
        step_token_budget=budget if mode != "unchunked" else 0,
        paged=paged, page_size=PAGE if paged else None), dict(
        edges=edges, max_queue=max_queue, allow_overflow=allow_overflow)


def _engine(models, mode, paged=False, **kw):
    _, cfg, _, params = models
    engine_kw, policy_kw = _kwargs(mode, paged, **kw)
    return ServeEngine(cfg, params, device="cpu",
                       scheduler=ShapeBucketScheduler(
                           BucketPolicy(**policy_kw)), **engine_kw)


def _jax_engine(models, mode, **kw):
    cfg, _, params, _ = models
    engine_kw, policy_kw = _kwargs(mode, True, **kw)
    return JaxEngine(cfg, params, scheduler=JaxBucketScheduler(
        JaxBucketPolicy(**policy_kw)), **engine_kw)


def _serve(eng, trace, max_new_tokens=NEW_TOKENS, max_steps=2000):
    """Drive to drain: ``({rid: tokens}, peak prefills in flight, the
    step stats of every step)``."""
    rids = [eng.add_request(p, max_new_tokens=max_new_tokens) for p in trace]
    assert all(r is not None for r in rids), "pinned trace request rejected"
    peak, stats = 0, []
    for _ in range(max_steps):
        eng.step()
        stats.append(dict(eng.last_step_stats))
        peak = max(peak, len(eng._chunking))
        if not eng.in_flight() and not eng.scheduler.pending():
            break
    else:
        pytest.fail("engine did not drain (starvation?)")
    return {r.rid: tuple(r.out_tokens) for r in eng._finished}, peak, stats


def _trace(cfg, family, seed=0, n=8):
    return trace_lib.make_trace(family, seed=seed, vocab=cfg.vocab_size,
                                edges=EDGES, n=n)


def _assert_balanced(eng):
    eng.pool.check_balanced()
    pm = eng.metrics.as_dict()["pool"]
    assert pm["page_allocs"] == pm["page_frees"] > 0


# ---------------------------------------------------------------------------
# The differential suite: the port's own caches against its pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", trace_lib.FAMILIES)
def test_paged_matches_unpaged_per_family(family, models):
    overflow = family == "overflow_heavy"
    trace = _trace(models[1], family)
    for mode in MODES:
        base, _, _ = _serve(_engine(models, mode, allow_overflow=overflow),
                            trace)
        assert len(base) == len(trace)
        eng = _engine(models, mode, paged=True, allow_overflow=overflow)
        paged, _, _ = _serve(eng, trace)
        assert paged == base, f"{family}/{mode}: paged tokens diverged"
        _assert_balanced(eng)


# ---------------------------------------------------------------------------
# Against the JAX paged engine
# ---------------------------------------------------------------------------

def _jax_margin(models, tokens) -> float:
    cfg_j, _, pj, _ = models
    logits = jax_api.prefill(pj, cfg_j, {"tokens": jnp.asarray(tokens)[None]},
                             max_len=len(tokens))[0][0, :cfg_j.vocab_size]
    top = np.sort(np.asarray(logits))[-2:]
    return float(top[1] - top[0])


@pytest.mark.parametrize("family", ["bimodal", "head_of_line"])
def test_paged_matches_the_jax_paged_engine(family, models):
    _against_jax(models, family, MODES)


def test_paged_moe_matches_the_jax_paged_engine():
    """deepseek-moe-16b smoke on the pool, chunked: its experts route each
    chunk's tokens together, capacity counted as the JAX engine counts it."""
    cfg_j = jax_configs.get_smoke("deepseek-moe-16b")
    cfg_t = configs.get_smoke("deepseek-moe-16b")
    pj = jax.jit(jax_api.init_params, static_argnums=0)(
        cfg_j, jax.random.PRNGKey(0))
    pt = params_from_jax(cfg_t, jax.tree.map(np.asarray, pj), device="cpu")
    _against_jax((cfg_j, cfg_t, pj, pt), "bimodal", ("chunked",))


def _against_jax(models, family, modes):
    trace = _trace(models[1], family, n=6)
    for mode in modes:
        eng_t = _engine(models, mode, paged=True)
        eng_j = _jax_engine(models, mode)
        got, _, stats_t = _serve(eng_t, trace)
        want, _, stats_j = _serve(eng_j, trace)
        assert sorted(got) == sorted(want)
        for rid, prompt in enumerate(trace):
            a, b = got[rid], want[rid]
            for i, (x, y) in enumerate(zip(a, b)):
                if x != y:
                    ctx = np.concatenate([prompt, np.asarray(b[:i])])
                    assert _jax_margin(models, ctx.astype(np.int32)) \
                        <= MARGIN_TOL, (family, mode, rid, i)
                    break
        assert stats_t == stats_j, (family, mode)
        assert eng_t.metrics.as_dict()["pool"] == \
            eng_j.metrics.as_dict()["pool"], (family, mode)
        _assert_balanced(eng_t)


# ---------------------------------------------------------------------------
# Occupancy and shared prefixes
# ---------------------------------------------------------------------------

def test_paged_occupancy_exceeds_prefill_slots(models):
    """Under a burst of shorts the paged engine holds more prefills in
    flight than ``prefill_slots``, the whole-cache engine's ceiling."""
    trace = _trace(models[1], "all_short", n=10)
    _, base_peak, _ = _serve(_engine(models, "chunked", prefill_slots=2),
                             trace)
    assert base_peak <= 2
    eng = _engine(models, "chunked", paged=True, prefill_slots=2)
    _, peak, _ = _serve(eng, trace)
    assert peak > 2, f"paged engine never exceeded prefill_slots ({peak})"
    _assert_balanced(eng)


def test_prefix_sharing_cow_token_parity(models):
    """A recipient maps a decoding donor's pages, its shared partial tail
    page included, so both split on their next writes: the tokens equal a
    run without sharing, and the hit and the splits fire."""
    _, cfg, _, params = models
    assert supports_prefix_sharing(cfg)
    rng = np.random.default_rng(7)
    donor = rng.integers(2, cfg.vocab_size, size=10).astype(np.int32)
    recipient = np.concatenate(
        [donor, rng.integers(2, cfg.vocab_size, size=5).astype(np.int32)])

    def run(sharing):
        eng = ServeEngine(cfg, params, max_len=64, slots=2, prefill_slots=2,
                          paged=True, page_size=4, prefix_sharing=sharing,
                          device="cpu")
        eng.add_request(donor, max_new_tokens=8)
        eng.step()                  # the donor prefills and registers
        eng.add_request(recipient, max_new_tokens=8)
        for _ in range(200):        # the donor decodes beside the recipient
            eng.step()
            if not eng.in_flight() and not eng.scheduler.pending():
                break
        eng.pool.check_balanced()
        return ({r.rid: tuple(r.out_tokens) for r in eng._finished},
                eng.metrics.as_dict()["pool"])

    shared_tokens, shared_pool = run(True)
    plain_tokens, plain_pool = run(False)
    assert shared_tokens == plain_tokens
    assert shared_pool["prefix_hits"] >= 1, "prefix reuse never fired"
    assert shared_pool["prefix_tokens_reused"] >= 8
    assert shared_pool["cow_splits"] >= 1, "no copy-on-write was exercised"
    assert plain_pool["prefix_hits"] == 0 and plain_pool["cow_splits"] == 0


def test_hybrids_share_no_prefix(models):
    """RG-LRU layers carry state a prefix hit would skip: recurrentgemma
    prefills every token, its pages (local attention) still paged."""
    cfg = configs.get_smoke("recurrentgemma-9b")
    assert not supports_prefix_sharing(cfg)
    from repro_torch.models import api

    params = api.init_params(cfg, 0, device="cpu")
    prompt = np.arange(2, 14, dtype=np.int32)
    eng = ServeEngine(cfg, params, max_len=40, slots=2, paged=True,
                      page_size=4, device="cpu")
    for _ in range(2):
        eng.add_request(prompt, max_new_tokens=4)
    done = eng.run_until_done()
    assert done[0].out_tokens == done[1].out_tokens
    pool = eng.metrics.as_dict()["pool"]
    assert pool["prefix_hits"] == 0 and pool["page_allocs"] > 0
    eng.pool.check_balanced()


# ---------------------------------------------------------------------------
# Property: lifecycle balance across families x modes x seeds
# ---------------------------------------------------------------------------

@settings(max_examples=6, deadline=None)
@given(family=st.sampled_from(trace_lib.FAMILIES),
       mode=st.sampled_from(MODES), seed=st.integers(0, 3))
def test_paged_lifecycle_property(models, family, mode, seed):
    trace = _trace(models[1], family, seed=seed, n=6)
    eng = _engine(models, mode, paged=True,
                  allow_overflow=family == "overflow_heavy")
    tokens, _, _ = _serve(eng, trace)
    assert len(tokens) == len(trace)
    _assert_balanced(eng)
