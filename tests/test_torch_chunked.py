"""Chunked prefill in the port against the JAX package, on the CPU.

* ``attn_prefill_chunk`` against the reference's over successive chunks: a
  linear cache (qwen2 smoke, 13 tokens in chunks of 4 and 13) and a ring
  that wraps (gemma2 smoke, 30 tokens in chunks of 7, 16-slot window);
  outputs and caches within 1e-5 (float32 sums in another order). The
  card's tile translation (``impl="kernel"``, whose wrapper runs the plain
  version on CPU tensors) and its ``fallback`` event for a bkv no regime
  compiles.
* ``api.prefill_chunk`` against the reference's on the qwen2, gemma2,
  recurrentgemma and mamba2 smoke models: logits within 2e-5 and every
  state tensor within 5e-4 (the reference's own chunk-parity bounds;
  recurrentgemma's logits within 1e-4, where its whole prefill already
  lies), and against the port's own whole-prompt prefill within 2e-5.
* The port's chunked engine against the JAX one on one bucketed trace
  (``benchmarks/traces.py``): the same tokens (up to a top-2 tie within
  1e-4), the same ``last_step_stats`` every step, the same chunk and plan
  counters (mamba2 counts no ``chunked_prefill``).
* The scheduling rules ``tests/test_serve_chunked.py`` pins: a short
  prompt overtakes a long one, one multi-chunk prefill at a time, the
  ready backlog stalls admission, aging.
* State ownership: a slot keeps the tensors it was made with (the ones a
  captured graph holds) across requests, cache sets are reused, and a
  reused set serves what a fresh one does.

Inputs come from a numpy seed; parameters from the reference's
``init_params`` through ``params_from_jax``.
"""
import pathlib
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                       / "benchmarks"))
import traces as trace_lib  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.core.tiling import TileShape as JaxTile  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.serve import BucketPolicy as JaxBucketPolicy  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro.serve import ShapeBucketScheduler as JaxBucketScheduler  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.tiling import TileShape  # noqa: E402
from repro_torch.models import api, attention  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve import (BucketPolicy, ServeEngine,  # noqa: E402
                               ShapeBucketScheduler)

ATTN_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=2e-5, atol=2e-5)
STATE_TOL = dict(rtol=5e-4, atol=5e-4)
MARGIN_TOL = 1e-4
TIMING_KEYS = ("ttft_s", "tpot_s")


# ---------------------------------------------------------------------------
# One attention block, chunk by chunk
# ---------------------------------------------------------------------------

def _attn_pair(name, seed):
    cfg_j, cfg_t = jax_configs.get_smoke(name), configs.get_smoke(name)
    pj = jax_layers.init_tree(jax_attn.attn_defs(cfg_j),
                              jax.random.PRNGKey(seed), jnp.float32)
    pt = {k: torch.from_numpy(np.array(v)) for k, v in pj.items()}
    return cfg_j, cfg_t, pj, pt


def _chunked_attn(name, s, chunk, max_len, window, impl="auto", tile=None):
    cfg_j, cfg_t, pj, pt = _attn_pair(name, seed=2)
    x = np.random.default_rng(s + chunk).standard_normal(
        (1, s, cfg_t.d_model)).astype(np.float32)
    ring = window is not None
    length = min(max_len, window) if ring else max_len
    cj = jax_attn.make_kv_cache(cfg_j, 1, length, jnp.float32, ring=ring)
    ct = attention.make_kv_cache(cfg_t, 1, length, torch.float32, ring=ring,
                                 device="cpu")
    for start in range(0, s, chunk):
        c = min(chunk, s - start)
        pos = np.arange(start, start + c)[None]
        yj, cj = jax_attn.attn_prefill_chunk(
            pj, cfg_j, jnp.asarray(x[:, start:start + c]), jnp.asarray(pos),
            cache=cj, start=start, window=window,
            tile=JaxTile(tuple(tile)) if tile else None)
        yt, ct = attention.attn_prefill_chunk(
            pt, cfg_t, torch.from_numpy(x[:, start:start + c]),
            torch.from_numpy(pos), cache=ct, start=start, window=window,
            impl=impl, tile=TileShape(tuple(tile)) if tile else None)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **ATTN_TOL,
                                   err_msg=f"chunk at {start}")
    for key in cj:
        np.testing.assert_allclose(ct[key].numpy(), np.asarray(cj[key]),
                                   **ATTN_TOL, err_msg=key)


@pytest.mark.parametrize("chunk", [4, 13])
def test_chunked_attn_matches_reference_linear(chunk):
    # 13 is prime: chunk 4 leaves an uneven tail.
    _chunked_attn("qwen2-1.5b", s=13, chunk=chunk, max_len=16, window=None)


def test_chunked_attn_matches_reference_ring_wraparound():
    # Window 16 < 30 tokens: the ring wraps while the chunks are written.
    _chunked_attn("gemma2-9b", s=30, chunk=7, max_len=64, window=16)


def test_chunked_attn_kernel_route_matches_reference():
    """The card's route on CPU tensors: the tile's bkv with a bq of 64 or
    128 (the wrapper then runs the plain version at that bkv)."""
    _chunked_attn("qwen2-1.5b", s=13, chunk=4, max_len=16, window=None,
                  impl="kernel", tile=(4, 64))


@pytest.mark.parametrize("chunk", [7, 8])
def test_chunked_attn_kernel_route_on_a_ring(chunk):
    """The card's route over a ring of 16 slots: before the wrap its slots
    in place, after it (and at start == 16 with chunk 8) the survivors
    rotated into position order, at q_offset 16."""
    _chunked_attn("gemma2-9b", s=30, chunk=chunk, max_len=64, window=16,
                  impl="kernel", tile=(chunk, 64))


def test_chunked_tile_events():
    """The plain path reports the bkv it used as the reference does; the
    kernel path reports the flash-attention tile it launches, a
    ``fallback`` where the regime compiles no such bkv and it snaps."""
    _, cfg, _, p = _attn_pair("qwen2-1.5b", 0)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 4, cfg.d_model)).astype(np.float32))
    positions = (4 + torch.arange(4))[None]

    def events(tile, impl):
        got = []
        cache = attention.make_kv_cache(cfg, 1, 16, torch.float32,
                                        device="cpu")
        with attention.capture_tile_events(got.append):
            attention.attn_prefill_chunk(p, cfg, x, positions, cache=cache,
                                         start=4, tile=TileShape(tile),
                                         impl=impl)
        assert len(got) == 1 and got[0]["kernel"] == "chunked_prefill"
        return got[0]

    ev = events((4, 4), "reference")
    assert ev["effective"] == 4 and not ev["fallback"]
    ev = events((4, 3), "reference")
    assert ev["fallback"] and ev["effective"] != 3
    ev = events((4, 64), "kernel")
    assert ev["effective"] == (64, 64) and not ev["fallback"]
    ev = events((4, 48), "kernel")
    assert ev["fallback"] and ev["effective"] == (64, 32)


# ---------------------------------------------------------------------------
# The model, chunk by chunk
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["qwen2-1.5b", "gemma2-9b",
                                        "recurrentgemma-9b", "mamba2-2.7b"])
def model(request):
    cfg_j = jax_configs.get_smoke(request.param)
    cfg_t = configs.get_smoke(request.param)
    pj = jax_api.init_params(cfg_j, jax.random.PRNGKey(0))
    pt = params_from_jax(cfg_t, jax.tree.map(np.asarray, pj), device="cpu")
    return cfg_j, cfg_t, pj, pt


CHUNKING = {"qwen2-1.5b": (13, 5), "gemma2-9b": (30, 7),
            "recurrentgemma-9b": (12, 5), "mamba2-2.7b": (12, 5)}
# recurrentgemma's whole-prompt prefill already lies 9.5e-5 from the
# reference's in its logits and 1.1e-3 x (1 + |value|) in its states at 12
# tokens (``tests/test_torch_rglru_model.py`` holds its logits at 1e-4), so
# its chunks are held there against the reference, and at 2e-5 and 5e-4
# against the port's own whole prefill (the test below).
REF_LOGIT_TOL = {"recurrentgemma-9b": dict(rtol=1e-4, atol=1e-4)}
REF_STATE_TOL = {"recurrentgemma-9b": dict(rtol=2e-3, atol=2e-3)}


def test_prefill_chunk_matches_reference(model):
    cfg_j, cfg_t, pj, pt = model
    s, chunk = CHUNKING[cfg_t.name]
    toks = np.random.default_rng(0).integers(
        2, cfg_t.vocab_size, size=(1, s)).astype(np.int32)
    ring = bool(cfg_t.attn_window)
    sj = jax_api.make_serve_state(cfg_j, 1, s + 8, jnp.float32,
                                  ring_local=ring)
    st = api.make_serve_state(cfg_t, 1, s + 8, torch.float32, device="cpu",
                              ring_local=ring)
    for start in range(0, s, chunk):
        c = toks[:, start:start + chunk]
        lj, sj = jax_api.prefill_chunk(pj, cfg_j, jnp.asarray(c), sj, start)
        lt, st = api.prefill_chunk(pt, cfg_t, c, st, start)
        np.testing.assert_allclose(
            lt.numpy(), np.asarray(lj),
            **REF_LOGIT_TOL.get(cfg_t.name, LOGIT_TOL),
            err_msg=f"chunk at {start}")
    layers_j = _layer_states(cfg_t, sj)
    assert len(layers_j) == len(st)
    for li, (cj, ct) in enumerate(zip(layers_j, st)):
        assert sorted(cj) == sorted(ct)
        for key in ct:
            np.testing.assert_allclose(
                ct[key].numpy().astype(np.float32),
                np.asarray(cj[key], np.float32),
                **REF_STATE_TOL.get(cfg_t.name, STATE_TOL),
                err_msg=f"layer {li} {key}")


def _layer_states(cfg, state):
    """The reference's serve state (stacked per scanned segment) as one
    dict per layer, in layer order."""
    from repro_torch.models.transformer import decompose

    layers = []
    for seg, group in zip(decompose(cfg), state):
        if seg[0] == "seq":
            layers += list(group)
        else:
            for r in range(seg[2]):
                layers += [{k: np.asarray(v)[r] for k, v in unit.items()}
                           for unit in group]
    return layers


def test_prefill_chunk_continues_and_matches_whole_prefill(model):
    """Chunks on a used state emptied once (the engine's first chunk) give
    the whole-prompt prefill's logits; a chunk itself resets nothing."""
    _, cfg, _, pt = model
    s, chunk = CHUNKING[cfg.name]
    toks = np.random.default_rng(1).integers(2, cfg.vocab_size, size=(1, s))
    ring = bool(cfg.attn_window)
    whole, whole_state = api.prefill(pt, cfg, {"tokens": toks},
                                     max_len=s + 8, ring_local=ring)
    st = api.make_serve_state(cfg, 1, s + 8, torch.float32, device="cpu",
                              ring_local=ring)
    api.prefill(pt, cfg, {"tokens": toks[:, ::-1].copy()}, max_len=s + 8,
                caches=st)
    from repro_torch.models import transformer
    transformer.reset_caches(st)
    for start in range(0, s, chunk):
        logits, _ = api.prefill_chunk(pt, cfg, toks[:, start:start + chunk],
                                      st, start)
    np.testing.assert_allclose(logits.numpy(), whole.numpy(), **LOGIT_TOL)
    for li, (a, b) in enumerate(zip(st, whole_state)):
        for key in a:
            if key in ("k", "v"):   # rows past the prompt: stale vs zero
                rows = min(s, a[key].shape[2])
                a_t, b_t = a[key][:, :, :rows], b[key][:, :, :rows]
            else:
                a_t, b_t = a[key], b[key]
            np.testing.assert_allclose(a_t.numpy(), b_t.numpy(), **STATE_TOL,
                                       err_msg=f"layer {li} {key}")


# ---------------------------------------------------------------------------
# The engines on one trace
# ---------------------------------------------------------------------------

EDGES = (8, 32)


def _engines(cfg_j, cfg_t, pj, pt, packed: bool, budget: int = 16,
             slots: int = 2, prefill_slots: int = 3):
    kw = dict(max_len=EDGES[-1] * 2 + 8, slots=slots, chunk_prefill=True,
              pack_prefill=packed, step_token_budget=budget,
              prefill_slots=prefill_slots)
    ej = JaxEngine(cfg_j, pj, scheduler=JaxBucketScheduler(JaxBucketPolicy(
        EDGES, allow_overflow=True)), **kw)
    et = ServeEngine(cfg_t, pt, scheduler=ShapeBucketScheduler(BucketPolicy(
        EDGES, allow_overflow=True)), device="cpu", **kw)
    return ej, et


def _untimed(metrics: dict) -> dict:
    out = {k: v for k, v in metrics.items() if k not in TIMING_KEYS}
    out["chunked_prefill"] = {k: v for k, v in out["chunked_prefill"].items()
                              if k != "chunk_age_s"}
    return out


def _margin(pj, cfg_j, ctx) -> float:
    logits = jax_api.prefill(pj, cfg_j, {"tokens": jnp.asarray(ctx)[None]},
                             max_len=len(ctx))[0][0, :cfg_j.vocab_size]
    top = np.sort(np.asarray(logits))[-2:]
    return float(top[1] - top[0])


def serve_both(models, packed: bool, trace, new_tokens: int = 3, **kw):
    """Both engines on ``trace`` in lockstep: the same rids, the same
    ``last_step_stats`` every step, the same tokens up to a reference tie
    within MARGIN_TOL, the same non-timing metrics. Returns the port's
    engine."""
    cfg_j, cfg_t, pj, pt = models
    ej, et = _engines(cfg_j, cfg_t, pj, pt, packed, **kw)
    for prompt in trace:
        assert (et.add_request(prompt, max_new_tokens=new_tokens)
                == ej.add_request(prompt, max_new_tokens=new_tokens))
    for _ in range(500):
        if not ej.in_flight() and not ej.scheduler.pending():
            break
        assert et.step() == ej.step()
        assert et.last_step_stats == ej.last_step_stats, et.steps_run
    assert not et.in_flight() and not et.scheduler.pending()
    done_j = {r.rid: r for r in ej._finished}
    done_t = {r.rid: r for r in et._finished}
    assert sorted(done_t) == sorted(done_j) == list(range(len(trace)))
    sched = JaxBucketScheduler(JaxBucketPolicy(EDGES, allow_overflow=True))
    for rid, prompt in enumerate(trace):
        got, want = done_t[rid].out_tokens, done_j[rid].out_tokens
        assert len(got) == len(want) == new_tokens
        padded = sched.prepare(types.SimpleNamespace(
            prompt=np.asarray(prompt, np.int32), bucket=done_j[rid].bucket))
        for i, (a, b) in enumerate(zip(got, want)):
            if a != b:
                ctx = np.concatenate([padded, want[:i]]).astype(np.int32)
                assert _margin(pj, cfg_j, ctx) <= MARGIN_TOL, (rid, i)
                break
    got, want = (_untimed(e.metrics.as_dict()) for e in (et, ej))
    assert got == want
    return et


def _trace(cfg, n=5, family="head_of_line"):
    return trace_lib.make_trace(family, seed=0, vocab=cfg.vocab_size,
                                edges=EDGES, n=n)


def test_chunked_engine_matches_reference(model):
    cfg_t = model[1]
    eng = serve_both(model, packed=False, trace=_trace(cfg_t))
    m = eng.metrics
    assert max(m.chunks_per_prefill) > 1       # a long prompt chunked
    # No phantom counter for the attention-free model.
    assert ("chunked_prefill" in m.plan_by_kernel) == (
        cfg_t.name != "mamba2-2.7b")


def test_chunked_moe_engine_matches_reference():
    """deepseek-moe-16b smoke: each chunk routes its own tokens, capacity
    counted over the chunk as in the JAX engine."""
    cfg_j = jax_configs.get_smoke("deepseek-moe-16b")
    cfg_t = configs.get_smoke("deepseek-moe-16b")
    pj = jax.jit(jax_api.init_params, static_argnums=0)(
        cfg_j, jax.random.PRNGKey(0))
    pt = params_from_jax(cfg_t, jax.tree.map(np.asarray, pj), device="cpu")
    eng = serve_both((cfg_j, cfg_t, pj, pt), packed=False,
                     trace=_trace(cfg_t))
    assert max(eng.metrics.chunks_per_prefill) > 1


def test_overflow_prompt_is_served_by_chunking(model):
    """A prompt past the largest edge is admitted at an edge multiple and
    chunked, in both engines alike."""
    cfg_t = model[1]
    rng = np.random.default_rng(4)
    trace = [rng.integers(2, cfg_t.vocab_size, size=n).astype(np.int32)
             for n in (40, 5)]
    eng = serve_both(model, packed=False, trace=trace, new_tokens=2)
    assert max(eng.metrics.chunks_per_prefill) >= 3


# ---------------------------------------------------------------------------
# Scheduling rules (the reference's tests/test_serve_chunked.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def qwen():
    cfg = configs.get_smoke("qwen2-1.5b")
    return cfg, api.init_params(cfg, 0, device="cpu")


def _engine(cfg, params, budget=10, edges=(8, 64), slots=2, max_len=None,
            clock=None, prefill_slots=2):
    kw = dict(clock=clock) if clock is not None else {}
    return ServeEngine(cfg, params, max_len=max_len or max(edges) + 16,
                       slots=slots, device="cpu", chunk_prefill=True,
                       step_token_budget=budget, prefill_slots=prefill_slots,
                       scheduler=ShapeBucketScheduler(BucketPolicy(edges)),
                       **kw)


def _prompt(rng, cfg, n):
    return rng.integers(2, cfg.vocab_size, size=n).astype(np.int32)


def _first_tokens(eng, step, first):
    live = (eng._finished + [r for r in eng._active if r is not None]
            + [j.req for j in eng._chunking] + [e[0] for e in eng._ready])
    for r in live:
        if r.out_tokens and r.rid not in first:
            first[r.rid] = step


def test_short_prompt_overtakes_long_prefill(qwen):
    cfg, params = qwen
    eng = _engine(cfg, params)
    rng = np.random.default_rng(1)
    rid_long = eng.add_request(_prompt(rng, cfg, 60), max_new_tokens=2)
    rid_short = eng.add_request(_prompt(rng, cfg, 5), max_new_tokens=2)
    first = {}
    for step in range(200):
        eng.step()
        _first_tokens(eng, step, first)
        if rid_long in first and rid_short in first:
            break
    assert first[rid_short] < first[rid_long]


def test_single_multi_chunk_prefill_at_a_time(qwen):
    cfg, params = qwen
    eng = _engine(cfg, params)
    rng = np.random.default_rng(3)
    for n in (60, 60, 5, 5):
        assert eng.add_request(_prompt(rng, cfg, n),
                               max_new_tokens=2) is not None
    eng.step()
    assert sum(len(j.prompt) > j.chunk_len for j in eng._chunking) == 1
    assert not eng._held
    assert 64 in eng.scheduler.queued_buckets()
    eng.run_until_done()
    assert eng.metrics.completed == 4


def test_ready_backlog_backpressures_admission(qwen):
    """Finished prefills waiting for a slot stall admission, so live cache
    sets stay bounded (the reference's bound), and the engine never makes
    more than ``slots + prefill_slots`` of them."""
    cfg, params = qwen
    eng = _engine(cfg, params, budget=16, edges=(8,), slots=1, max_len=64)
    rng = np.random.default_rng(6)
    for _ in range(8):
        assert eng.add_request(_prompt(rng, cfg, 5),
                               max_new_tokens=8) is not None
    max_live = 0
    for _ in range(200):
        eng.step()
        live = (sum(r is not None for r in eng._active)
                + sum(j.state is not None for j in eng._chunking)
                + len(eng._ready))
        max_live = max(max_live, live)
        if not eng.in_flight() and not eng.scheduler.pending():
            break
    assert eng.metrics.completed == 8
    assert max_live <= 2 * eng.slots + 2 * eng.prefill_slots
    assert eng.cache_sets_made <= eng.slots + eng.prefill_slots
    assert len(eng._free_sets) == eng.cache_sets_made


def test_aging_keeps_long_prefill_progressing(qwen):
    cfg, params = qwen
    eng = _engine(cfg, params, max_len=160)
    rng = np.random.default_rng(7)
    rid_long = eng.add_request(_prompt(rng, cfg, 60), max_new_tokens=2)
    for step in range(120):
        eng.add_request(_prompt(rng, cfg, 5), max_new_tokens=2)
        eng.step()
        if any(r.rid == rid_long for r in eng._finished):
            break
    else:
        pytest.fail("long prefill starved by the short stream")


# ---------------------------------------------------------------------------
# State ownership
# ---------------------------------------------------------------------------

def _slot_ptrs(eng):
    return [[(k, t.data_ptr()) for c in s.caches for k, t in sorted(c.items())]
            + [("token", s.token.data_ptr()), ("logits", s.logits.data_ptr())]
            for s in eng._slots]


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma2-9b", "mamba2-2.7b"])
def test_slots_keep_their_tensors_and_sets_are_reused(arch):
    cfg = configs.get_smoke(arch)
    params = api.init_params(cfg, 0, device="cpu")
    eng = _engine(cfg, params, budget=12, edges=(8, 32), slots=2,
                  max_len=48)
    before = _slot_ptrs(eng)
    rng = np.random.default_rng(8)
    for n in (30, 5, 7, 20, 3, 9):
        eng.add_request(_prompt(rng, cfg, n), max_new_tokens=4)
    done = eng.run_until_done()
    assert len(done) == 6
    assert _slot_ptrs(eng) == before
    assert eng.cache_sets_made <= eng.slots + eng.prefill_slots < 6


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma2-9b",
                                  "recurrentgemma-9b", "mamba2-2.7b"])
def test_a_reused_cache_set_serves_what_a_fresh_one_does(arch):
    """One prefill slot and one decode slot: the second request prefills
    into the set the first used (and decodes in the slot it left); its
    tokens and logits equal a fresh engine's."""
    cfg = configs.get_smoke(arch)
    params = api.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(9)
    first, second = _prompt(rng, cfg, 30), _prompt(rng, cfg, 19)

    def serve(prompts):
        eng = _engine(cfg, params, budget=8, edges=(32,), slots=1,
                      max_len=48, prefill_slots=1)
        for p in prompts:
            eng.add_request(p, max_new_tokens=6)
        done = {r.rid: r.out_tokens for r in eng.run_until_done()}
        return eng, done[len(prompts) - 1]

    eng, reused = serve([first, second])
    assert eng.cache_sets_made == 1
    _, fresh = serve([second])
    assert reused == fresh


def test_move_state_copies_into_the_slot_tensors():
    from repro_torch.serve.engine import _move_state

    cfg = configs.get_smoke("gemma2-9b")
    params = api.init_params(cfg, 0, device="cpu")
    src = api.make_serve_state(cfg, 1, 40, torch.float32, device="cpu",
                               ring_local=True)
    dst = api.make_serve_state(cfg, 1, 40, torch.float32, device="cpu",
                               ring_local=True)
    for c in dst:
        for t in c.values():
            t.fill_(7)
    ptrs = [t.data_ptr() for c in dst for t in c.values()]
    toks = np.random.default_rng(0).integers(2, cfg.vocab_size, (1, 21))
    api.prefill(params, cfg, {"tokens": toks}, max_len=40, caches=src)
    _move_state(src, dst, 21)
    assert [t.data_ptr() for c in dst for t in c.values()] == ptrs
    for s, d in zip(src, dst):
        rows = min(21, s["k"].shape[2])
        assert torch.equal(d["k"][:, :, :rows], s["k"][:, :, :rows])
        assert torch.equal(d["v"][:, :, :rows], s["v"][:, :, :rows])
        assert int(d["pos"]) == 21
        if "slot_pos" in s:
            assert torch.equal(d["slot_pos"], s["slot_pos"])
    tok = torch.tensor([[5]])
    a, _ = api.decode_step(params, cfg, tok, src)
    b, _ = api.decode_step(params, cfg, tok, dst)
    assert torch.equal(a, b)
