"""The port's ServeEngine against the JAX ServeEngine, on the CPU.

The same prompts go through both engines (the qwen2 smoke config, the
windowed gemma2 and h2o-danube smoke configs, whose local layers keep ring
caches of 16 slots that the longer requests wrap, the attention-free
mamba2 smoke config, whose SSD layers carry only a recurrent state, and the
recurrentgemma one, RG-LRU layers beside local attention on 16-slot rings,
and the two MoE ones, deepseek-moe-16b with its dense first layer and shared
experts and qwen3-moe-235b-a22b with renormalised gates and q/k norms; the
JAX parameters converted through numpy). Tokens must be equal wherever the
reference's top-2 logit margin exceeds the tolerance (1e-4, float32: a
random-init smoke model can tie); after the first token where the margin is
within it, the two streams may rightly part. Admission and rejection
reasons and every non-timing field of ``metrics.as_dict()`` must be equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.serve import BucketPolicy as JaxBucketPolicy  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro.serve import ShapeBucketScheduler as JaxBucketScheduler  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve import (BucketPolicy, ServeEngine,  # noqa: E402
                               ShapeBucketScheduler)

MARGIN_TOL = 1e-4
TIMING_KEYS = ("ttft_s", "tpot_s")


ARCHS = ["qwen2-1.5b", "gemma2-9b", "h2o-danube-1.8b", "mamba2-2.7b",
         "recurrentgemma-9b", "deepseek-moe-16b", "qwen3-moe-235b-a22b"]


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    cfg_j = jax_configs.get_smoke(request.param)
    cfg_t = configs.get_smoke(request.param)
    pj = jax_api.init_params(cfg_j, jax.random.PRNGKey(0))
    pt = params_from_jax(cfg_t, jax.tree.map(np.asarray, pj), device="cpu")
    return cfg_j, cfg_t, pj, pt


def _untimed(metrics: dict) -> dict:
    out = {k: v for k, v in metrics.items() if k not in TIMING_KEYS}
    out["chunked_prefill"] = {k: v for k, v in out["chunked_prefill"].items()
                              if k != "chunk_age_s"}
    return out


def _jax_margin(pj, cfg_j, tokens) -> float:
    """The reference's top-2 margin of the next token after ``tokens``."""
    logits = jax_api.prefill(pj, cfg_j, {"tokens": jnp.asarray(tokens)[None]},
                             max_len=len(tokens))[0][0, :cfg_j.vocab_size]
    top = np.sort(np.asarray(logits))[-2:]
    return float(top[1] - top[0])


def _assert_same_tokens(pj, cfg_j, prompt, got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            ctx = np.concatenate([np.asarray(prompt), np.asarray(want[:i])])
            margin = _jax_margin(pj, cfg_j, ctx.astype(np.int32))
            assert margin <= MARGIN_TOL, \
                f"token {i}: {a} != {b} with reference margin {margin:.3g}"
            return        # past a tie the two streams may rightly part


def _serve(make_engine, submissions):
    eng = make_engine()
    rids, reasons = [], []
    for prompt, new in submissions:
        rid = eng.add_request(prompt, max_new_tokens=new)
        rids.append(rid)
        reasons.append(eng.last_reject_reason if rid is None else "ok")
    done = {r.rid: r for r in eng.run_until_done()}
    return eng, rids, reasons, done


def _compare(models, make_jax, make_port, submissions):
    cfg_j, _, pj, _ = models
    ej, rids_j, reasons_j, done_j = _serve(make_jax, submissions)
    et, rids_t, reasons_t, done_t = _serve(make_port, submissions)
    assert rids_t == rids_j
    assert reasons_t == reasons_j
    assert sorted(done_t) == sorted(done_j)
    for rid, (prompt, _) in zip(rids_j, submissions):
        if rid is None:
            continue
        assert done_t[rid].bucket == done_j[rid].bucket
        _assert_same_tokens(pj, cfg_j, prompt, done_t[rid].out_tokens,
                            done_j[rid].out_tokens)
    assert _untimed(et.metrics.as_dict()) == _untimed(ej.metrics.as_dict())
    assert et.steps_run == ej.steps_run
    assert et.last_step_stats == ej.last_step_stats
    return reasons_t


def test_fifo_engine_matches_reference(models):
    cfg_j, cfg_t, pj, pt = models
    rng = np.random.default_rng(0)
    subs = [(rng.integers(2, cfg_t.vocab_size, size=n), new)
            for n, new in ((5, 6), (11, 4), (3, 1), (17, 8), (40, 6), (9, 5))]
    reasons = _compare(
        models,
        lambda: JaxEngine(cfg_j, pj, max_len=44, slots=2),
        lambda: ServeEngine(cfg_t, pt, max_len=44, slots=2, device="cpu"),
        subs)
    assert reasons == ["ok", "ok", "ok", "ok", "cache_overflow", "ok"]


def test_bucketed_engine_matches_reference(models):
    cfg_j, cfg_t, pj, pt = models
    rng = np.random.default_rng(1)
    lengths = (3, 12, 20, 7, 16, 5, 9)
    subs = [(rng.integers(2, cfg_t.vocab_size, size=n), 4) for n in lengths]
    reasons = _compare(
        models,
        lambda: JaxEngine(cfg_j, pj, max_len=32, slots=2,
                          scheduler=JaxBucketScheduler(
                              JaxBucketPolicy((8, 16), max_queue=4))),
        lambda: ServeEngine(cfg_t, pt, max_len=32, slots=2, device="cpu",
                            scheduler=ShapeBucketScheduler(
                                BucketPolicy((8, 16), max_queue=4))),
        subs)
    assert reasons[2] == "over_length"
    assert "queue_full" in reasons


def test_engine_is_reusable_and_deterministic(models):
    _, cfg_t, _, pt = models
    eng = ServeEngine(cfg_t, pt, max_len=32, slots=2, device="cpu")
    p = np.asarray([9, 8, 7, 6])
    eng.add_request(p, max_new_tokens=6)
    a = eng.run_until_done()[0].out_tokens
    eng.add_request(p, max_new_tokens=6)
    b = eng.run_until_done()[0].out_tokens
    assert a == b and len(a) == 6 and eng.in_flight() == 0


@pytest.mark.parametrize("option", [
    dict(pack_prefill=True, tracer=True),
    dict(shadow_fraction=0.5), dict(refiner=True),
    dict(tracer=True),
])
def test_unported_engine_options_raise(models, option):
    """The options that raised NotImplementedError before tracing and
    shadow refinement were ported now construct and serve, with the tokens
    of the engine without them."""
    from repro_torch.obs import Tracer
    from repro_torch.serve.refine import PlanRefiner

    _, cfg_t, _, pt = models
    made = {"tracer": Tracer, "refiner": PlanRefiner}
    kw = {k: made[k]() if k in made else v for k, v in option.items()}
    p = np.asarray([9, 8, 7, 6])
    want = ServeEngine(cfg_t, pt, max_len=32, slots=2, device="cpu",
                       pack_prefill=kw.get("pack_prefill", False))
    want.add_request(p, max_new_tokens=4)
    eng = ServeEngine(cfg_t, pt, max_len=32, slots=2, device="cpu", **kw)
    eng.add_request(p, max_new_tokens=4)
    assert (eng.run_until_done()[0].out_tokens
            == want.run_until_done()[0].out_tokens)
    if "tracer" in kw:
        assert kw["tracer"].events


@pytest.mark.parametrize("option", [
    dict(chunk_prefill=True, paged=True), dict(paged=True),
])
def test_paged_engine_options_construct_and_serve(models, option):
    """The options that raised before the paged pool was ported: they
    construct and serve on the CPU, the tokens the unpaged engine's and the
    pool drained."""
    _, cfg_t, _, pt = models
    subs = [(np.arange(2, 2 + n) % cfg_t.vocab_size, 4) for n in (5, 11)]
    eng, _, _, got = _serve(lambda: ServeEngine(
        cfg_t, pt, max_len=32, device="cpu", page_size=8, **option), subs)
    _, _, _, want = _serve(lambda: ServeEngine(cfg_t, pt, max_len=32,
                                               device="cpu"), subs)
    assert {r: q.out_tokens for r, q in got.items()} == \
        {r: q.out_tokens for r, q in want.items()}
    assert eng.pool.page == 8 and eng.metrics.pool_page_allocs > 0
    eng.pool.check_balanced()


def test_launcher_serves_on_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--device", "cpu", "--requests", "3", "--new-tokens", "3",
                "--scheduler", "bucket", "--bucket-policy", "8,16"])
    out = capsys.readouterr().out
    assert "3 requests (0 rejected), 9 tokens" in out
    assert "'matmul': 0" in out      # the plain versions ran, no kernel


@pytest.mark.parametrize("arch", ["gemma2-9b", "h2o-danube-1.8b",
                                  "recurrentgemma-9b"])
def test_launcher_serves_the_windowed_archs_on_cpu(capsys, arch):
    """Ring caches of 16 slots at the default max_len: 20 new tokens wrap
    them."""
    from repro_torch.launch import serve

    serve.main(["--device", "cpu", "--arch", arch, "--requests", "3",
                "--new-tokens", "20"])
    out = capsys.readouterr().out
    assert "3 requests (0 rejected), 60 tokens" in out
    assert "'flash_decode': 0" in out   # the plain versions ran, no kernel
    assert "'rglru': 0" in out


def test_launcher_serves_mamba2_on_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--device", "cpu", "--arch", "mamba2-2.7b", "--requests", "3",
                "--new-tokens", "20"])
    out = capsys.readouterr().out
    assert "3 requests (0 rejected), 60 tokens" in out
    assert "'ssd': 0" in out


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen3-moe-235b-a22b"])
def test_launcher_serves_the_moe_archs_on_cpu(capsys, arch):
    from repro_torch.launch import serve

    serve.main(["--device", "cpu", "--arch", arch, "--requests", "3",
                "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert "3 requests (0 rejected), 12 tokens" in out
    assert "'matmul': 0" in out      # the plain versions ran, no kernel


def test_encoder_decoder_is_refused_by_the_engine_and_launcher():
    """whisper's requests need encoder frames; the engine takes tokens. The
    reference fails on the missing 'frames' key; the port says why."""
    from repro_torch.launch import serve
    from repro_torch.models import api

    cfg = configs.get_smoke("whisper-large-v3")
    params = api.init_params(cfg, 0, device="cpu")
    for start in (lambda: ServeEngine(cfg, params, max_len=32, device="cpu"),
                  lambda: serve.main(["--device", "cpu", "--arch",
                                      "whisper-large-v3"])):
        with pytest.raises(NotImplementedError, match="encoder frames"):
            start()


def test_vision_model_serves_its_text_as_the_reference():
    """internvl2's requests are text in both engines (no patches)."""
    cfg_j = jax_configs.get_smoke("internvl2-1b")
    cfg_t = configs.get_smoke("internvl2-1b")
    pj = jax.jit(jax_api.init_params, static_argnums=0)(
        cfg_j, jax.random.PRNGKey(0))
    pt = params_from_jax(cfg_t, jax.tree.map(np.asarray, pj), device="cpu")
    rng = np.random.default_rng(3)
    subs = [(rng.integers(2, cfg_t.vocab_size, size=n), 4) for n in (5, 9)]
    _compare((cfg_j, cfg_t, pj, pt),
             lambda: JaxEngine(cfg_j, pj, max_len=32, slots=2),
             lambda: ServeEngine(cfg_t, pt, max_len=32, slots=2,
                                 device="cpu"), subs)
