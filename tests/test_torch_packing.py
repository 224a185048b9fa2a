"""Step-packed prefill in the port against the JAX package, on the CPU.

* ``flash_prefill_packed_ref`` / ``flash_prefill_chunk_ref`` against the
  reference's (segments with their own positions, unwritten ring slots,
  window and softcap, a bkv that does not divide), within 1e-5.
* ``attn_prefill_packed`` against the reference's on linear caches (qwen2
  smoke) and rings (gemma2 smoke), each segment at its own offset, within
  1e-5; on linear caches also the card's route (one flash-attention call a
  segment, which on CPU tensors runs the plain version).
* ``api.prefill_packed`` against the same chunks run one by one through
  ``prefill_chunk`` (qwen2, mamba2) and against the reference's.
* The port's packed engine against the JAX one on a bucketed trace of
  short prompts: equal tokens (up to a top-2 tie within 1e-4), equal
  ``last_step_stats`` every step, equal chunk, pack and plan counters.
* The launcher's ``--chunk-prefill`` / ``--pack-prefill`` and a serving
  plan's ``chunked_prefill`` / ``packed_prefill`` cells, which the engine
  resolves exactly.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.kernels.flash_attention import chunked as jax_chunked  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels.flash_attention import chunked  # noqa: E402
from repro_torch.models import api, attention  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

from test_torch_chunked import serve_both  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=2e-5, atol=2e-5)
STATE_TOL = dict(rtol=5e-4, atol=5e-4)


# ---------------------------------------------------------------------------
# The plain packed attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window,softcap,bkv", [(None, None, 512),
                                                (5, 30.0, 7), (None, None, 4)])
def test_packed_ref_matches_reference(window, softcap, bkv):
    rng = np.random.default_rng(0)
    # Three segments: a fresh chunk, one over 6 written keys, one over a
    # ring with two unwritten slots.
    q_pos = np.concatenate([np.arange(4), 6 + np.arange(3), 9 + np.arange(5)])
    q_seg = np.repeat([0, 1, 2], [4, 3, 5])
    kv_pos = np.concatenate([np.arange(4), np.arange(9),
                             [8, -1, 2, 3, 4, 5, 6, 7, -1], 9 + np.arange(5)])
    kv_seg = np.repeat([0, 1, 2], [4, 9, 14])
    q = rng.standard_normal((1, 4, 12, 16)).astype(np.float32)
    k, v = (rng.standard_normal((1, 2, 27, 16)).astype(np.float32)
            for _ in range(2))
    kw = dict(window=window, softcap=softcap, scale=0.3, bkv=bkv)
    want = jax_chunked.flash_prefill_packed_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_pos=q_pos,
        q_seg=q_seg, kv_pos=kv_pos, kv_seg=kv_seg, **kw)
    got = chunked.flash_prefill_packed_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_pos=q_pos, q_seg=q_seg, kv_pos=kv_pos, kv_seg=kv_seg, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # One segment is the chunk reference.
    want = jax_chunked.flash_prefill_chunk_ref(
        jnp.asarray(q[:, :, 4:7]), jnp.asarray(k[:, :, 4:13]),
        jnp.asarray(v[:, :, 4:13]), q_pos=q_pos[4:7], kv_pos=kv_pos[4:13],
        **kw)
    got = chunked.flash_prefill_chunk_ref(
        torch.from_numpy(q[:, :, 4:7]), torch.from_numpy(k[:, :, 4:13]),
        torch.from_numpy(v[:, :, 4:13]), q_pos=q_pos[4:7],
        kv_pos=kv_pos[4:13], **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# One attention block, packed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,window,impl", [
    ("qwen2-1.5b", None, "auto"), ("qwen2-1.5b", None, "kernel"),
    ("gemma2-9b", 16, "auto"), ("gemma2-9b", 16, "kernel")])
def test_packed_attn_matches_reference(arch, window, impl):
    """Three requests: two continue (one past the ring's wrap), one
    starts; written through chunks first, then packed."""
    cfg_j, cfg_t = jax_configs.get_smoke(arch), configs.get_smoke(arch)
    pj = jax_layers.init_tree(jax_attn.attn_defs(cfg_j),
                              jax.random.PRNGKey(3), jnp.float32)
    pt = {k: torch.from_numpy(np.array(v)) for k, v in pj.items()}
    ring = window is not None
    length = 16 if ring else 40
    rng = np.random.default_rng(5)
    history = (7, 20 if ring else 12, 0)
    caches_j, caches_t = [], []
    for n in history:
        cj = jax_attn.make_kv_cache(cfg_j, 1, length, jnp.float32, ring=ring)
        ct = attention.make_kv_cache(cfg_t, 1, length, torch.float32,
                                     ring=ring, device="cpu")
        if n:
            x = rng.standard_normal((1, n, cfg_t.d_model)).astype(np.float32)
            pos = np.arange(n)[None]
            _, cj = jax_attn.attn_prefill_chunk(
                pj, cfg_j, jnp.asarray(x), jnp.asarray(pos), cache=cj,
                start=0, window=window)
            attention.attn_prefill_chunk(
                pt, cfg_t, torch.from_numpy(x), torch.from_numpy(pos),
                cache=ct, start=0, window=window)
        caches_j.append(cj)
        caches_t.append(ct)
    layout = ((7, 5), (history[1], 3), (0, 6))
    x = rng.standard_normal((1, 14, cfg_t.d_model)).astype(np.float32)
    pos = np.concatenate([s + np.arange(n) for s, n in layout])[None]
    yj, new_j = jax_attn.attn_prefill_packed(
        pj, cfg_j, jnp.asarray(x), jnp.asarray(pos), caches=tuple(caches_j),
        layout=layout, window=window)
    yt, new_t = attention.attn_prefill_packed(
        pt, cfg_t, torch.from_numpy(x), torch.from_numpy(pos),
        caches=tuple(caches_t), layout=layout, window=window, impl=impl)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    for cj, ct in zip(new_j, new_t):
        for key in cj:
            np.testing.assert_allclose(ct[key].numpy(), np.asarray(cj[key]),
                                       **TOL, err_msg=key)


# ---------------------------------------------------------------------------
# The model, packed
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["qwen2-1.5b", "mamba2-2.7b"])
def model(request):
    cfg_j = jax_configs.get_smoke(request.param)
    cfg_t = configs.get_smoke(request.param)
    pj = jax_api.init_params(cfg_j, jax.random.PRNGKey(0))
    pt = params_from_jax(cfg_t, jax.tree.map(np.asarray, pj), device="cpu")
    return cfg_j, cfg_t, pj, pt


def test_prefill_packed_matches_sequential_chunks_and_reference(model):
    cfg_j, cfg_t, pj, pt = model
    rng = np.random.default_rng(6)
    prompts = [rng.integers(2, cfg_t.vocab_size, size=n).astype(np.int32)
               for n in (11, 6, 9)]
    # Request 0 has prefilled 5 tokens, request 1 none, request 2 4.
    done = (5, 0, 4)
    layout = tuple((d, len(p) - d) for d, p in zip(done, prompts))

    def states():
        out = []
        for d, p in zip(done, prompts):
            st = api.make_serve_state(cfg_t, 1, 24, torch.float32,
                                      device="cpu")
            if d:
                api.prefill_chunk(pt, cfg_t, p[None, :d], st, 0)
            out.append(st)
        return out

    packed_states = states()
    toks = np.concatenate([p[d:] for d, p in zip(done, prompts)])[None]
    logits, _ = api.prefill_packed(pt, cfg_t, toks, packed_states, layout)
    assert logits.shape == (3, cfg_t.padded_vocab)
    seq_states = states()
    for i, ((start, n), p) in enumerate(zip(layout, prompts)):
        want, _ = api.prefill_chunk(pt, cfg_t, p[None, start:], seq_states[i],
                                    start)
        np.testing.assert_allclose(logits[i].numpy(), want[0].numpy(),
                                   **LOGIT_TOL)
        for a, b in zip(packed_states[i], seq_states[i]):
            for key in a:
                np.testing.assert_allclose(a[key].numpy(), b[key].numpy(),
                                           **STATE_TOL)
    # The reference's packed step from its own chunked states.
    sj = []
    for d, p in zip(done, prompts):
        st = jax_api.make_serve_state(cfg_j, 1, 24, jnp.float32)
        if d:
            _, st = jax_api.prefill_chunk(pj, cfg_j, jnp.asarray(p[None, :d]),
                                          st, 0)
        sj.append(st)
    lj, _ = jax_api.prefill_packed(pj, cfg_j, jnp.asarray(toks), tuple(sj),
                                   layout)
    np.testing.assert_allclose(logits.numpy(), np.asarray(lj), **LOGIT_TOL)


# ---------------------------------------------------------------------------
# The engines on one trace
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["qwen2-1.5b", "gemma2-9b",
                                        "mamba2-2.7b"])
def models(request):
    cfg_j = jax_configs.get_smoke(request.param)
    cfg_t = configs.get_smoke(request.param)
    pj = jax_api.init_params(cfg_j, jax.random.PRNGKey(0))
    pt = params_from_jax(cfg_t, jax.tree.map(np.asarray, pj), device="cpu")
    return cfg_j, cfg_t, pj, pt


def test_packed_engine_matches_reference(models):
    _packed_against_reference(models)


def test_packed_moe_engine_matches_reference():
    """deepseek-moe-16b smoke: a packed step routes the whole pack's tokens
    together, capacity counted over the pack as in the JAX engine."""
    cfg_j = jax_configs.get_smoke("deepseek-moe-16b")
    cfg_t = configs.get_smoke("deepseek-moe-16b")
    pj = jax.jit(jax_api.init_params, static_argnums=0)(
        cfg_j, jax.random.PRNGKey(0))
    pt = params_from_jax(cfg_t, jax.tree.map(np.asarray, pj), device="cpu")
    _packed_against_reference((cfg_j, cfg_t, pj, pt))


def _packed_against_reference(models):
    cfg_t = models[1]
    rng = np.random.default_rng(11)
    # Shorts that pack beside a long that chunks.
    trace = [rng.integers(2, cfg_t.vocab_size, size=n).astype(np.int32)
             for n in (30, 5, 3, 8, 6, 2)]
    eng = serve_both(models, packed=True, trace=trace, budget=24,
                     prefill_slots=3)
    m = eng.metrics
    assert max(int(k) for k in m.as_dict()["chunked_prefill"][
        "packed_chunks_per_step"]) >= 2


# ---------------------------------------------------------------------------
# The launcher and serving plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["--chunk-prefill", "--pack-prefill"])
def test_launcher_serves_chunked_on_cpu(capsys, mode):
    from repro_torch.launch import serve

    serve.main(["--device", "cpu", mode, "--step-token-budget", "40",
                "--scheduler", "bucket", "--requests", "6",
                "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "6 requests (0 rejected), 18 tokens" in out
    assert "chunked prefill: 6 chunks" in out
    assert ("step packing: chunks/step" in out) == (mode == "--pack-prefill")


def test_launcher_admits_an_overflow_prompt_by_chunking(capsys):
    from repro_torch.launch import serve

    serve.main(["--device", "cpu", "--chunk-prefill", "--step-token-budget",
                "10", "--scheduler", "bucket", "--bucket-policy", "4,8",
                "--requests", "4", "--new-tokens", "2", "--max-len", "32"])
    out = capsys.readouterr().out
    assert "4 requests (0 rejected), 8 tokens" in out


def test_serve_plan_cells_resolve_exactly(tmp_path, capsys):
    from repro_torch.launch import compile_plans
    from repro_torch.serve import (BucketPolicy, ServeEngine,
                                   ShapeBucketScheduler)

    out = str(tmp_path / "serve.json")
    compile_plans.main(["--measure", "analytic", "--archs", "qwen2-1.5b",
                        "--dtypes", "float32", "--serve-buckets", "64,128",
                        "--serve-smoke", "--serve-max-len", "160", "--out",
                        out])
    assert "cells left out" not in capsys.readouterr().out
    art = json.loads(open(out).read())
    assert art["meta"]["unported_kernels"] == []
    kernels = {(e["kernel"], e["hardware"]) for e in art["entries"]}
    assert {("chunked_prefill", "h100_sxm"),
            ("packed_prefill", "h100_sxm")} <= kernels
    from repro_torch.core import TilePlan

    plan = TilePlan.load(out)
    cfg = configs.get_smoke("qwen2-1.5b")
    params = api.init_params(cfg, 0, device="cpu")
    for packed in (False, True):
        eng = ServeEngine(cfg, params, max_len=160, slots=2, plans=plan,
                          device="cpu", chunk_prefill=True,
                          pack_prefill=packed, step_token_budget=140,
                          prefill_slots=3,
                          scheduler=ShapeBucketScheduler(
                              BucketPolicy((64, 128))))
        rng = np.random.default_rng(2)
        for n in (100, 20, 50, 9):
            eng.add_request(rng.integers(2, cfg.vocab_size, size=n),
                            max_new_tokens=3)
        assert len(eng.run_until_done()) == 4
        # Every admitted length's cell resolved exactly (the plain path's
        # KV split may still snap: tile_fallback events, as the
        # reference's).
        counts = eng.metrics.plan_by_kernel
        assert counts["chunked_prefill"]["exact"] == 4
        assert set(counts["chunked_prefill"]) <= {"exact", "tile_fallback"}
        if packed:
            assert counts["packed_prefill"]["exact"] >= 1
            assert set(counts["packed_prefill"]) <= {"exact",
                                                     "tile_fallback"}


def test_a_compiled_plan_chunks_at_the_reference_default(tmp_path, capsys):
    """The sweep holds a serving cell's first dim at the reference's
    default (chunk min(512, sq), pack min(1024, 8 sq)) and ranks bkv
    alone, so with a compiled plan and no step budget (the launcher's
    default) a 1024-token bucket prefills in 512-token chunks."""
    from repro_torch.core import TilePlan
    from repro_torch.launch import compile_plans
    from repro_torch.serve import (BucketPolicy, ServeEngine,
                                   ShapeBucketScheduler)

    out = str(tmp_path / "serve.json")
    compile_plans.main(["--measure", "analytic", "--archs", "qwen2-1.5b",
                        "--dtypes", "float32", "--serve-buckets", "64,1024",
                        "--serve-smoke", "--serve-max-len", "1100", "--out",
                        out])
    capsys.readouterr()
    widths = {"chunked_prefill": lambda sq: min(512, sq),
              "packed_prefill": lambda sq: min(1024, 8 * sq)}
    cells = [e for e in json.loads(open(out).read())["entries"]
             if e["kernel"] in widths and e["hardware"] == "h100_sxm"]
    assert {e["problem"]["sq"] for e in cells} == {64, 1024}
    for e in cells:
        assert e["tile"][0] == widths[e["kernel"]](e["problem"]["sq"]), e
    cfg = configs.get_smoke("qwen2-1.5b")
    eng = ServeEngine(cfg, api.init_params(cfg, 0, device="cpu"),
                      max_len=1100, slots=2, plans=TilePlan.load(out),
                      device="cpu", chunk_prefill=True,
                      scheduler=ShapeBucketScheduler(BucketPolicy((64, 1024))))
    assert eng.chunk_len_for(1024) == 512
    assert eng.chunk_len_for(64) == 64
    assert eng._chunk_plan(1024)[2]["chunked_prefill"] == "exact"
