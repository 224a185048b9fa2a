"""Tile plans in the port's ServeEngine, on the CPU.

Smoke configs serve through the port's engine with an analytic ``h100_sxm``
plan compiled over the serving scheduler's cells (``serve_bucket_cells``),
beside the JAX engine with its own ``tpu_v5e`` plan of the same cells:

* plan sources: the bucketed scheduler hits every cell exactly, raw FIFO
  lengths between edges resolve by nearest shape — the same per-phase
  counts in both engines, the paged pool's ``kv_page`` decode cell
  included;
* the plan's tiles reach the kernel call sites (monkeypatched spies);
* tokens with a plan equal tokens without one and the JAX engine's, where
  the reference's top-2 logit margin exceeds 1e-4 (float32; a plan's KV
  chunk changes the order of the sums);
* a tile that does not apply counts once as ``tile_fallback``: a
  non-dividing attention chunk on the CPU, and a matmul or decode tile that
  its kernel would not launch, which the engine replaces by the default;
* ``set_plans`` drops the plan-derived state and leaves the tokens;
* the CLIs: ``launch.serve --tile-plans`` and ``compile_plans
  --serve-buckets``;
* with no card and no weights: every tile the engine would resolve for
  full-width qwen2-1.5b, h2o-danube-1.8b and gemma2-9b, at every prompt
  length up to ``max_len``, is one the kernels launch; and for mamba2-2.7b
  and recurrentgemma-9b, whose SSD and RG-LRU tiles are held against the
  scans too (an SSD chunk above the kernel's longest, an RG-LRU block of
  more than 1024 features: each replaced once, the tokens unchanged).
"""
import ast
import dataclasses
import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro import kernels as jax_kernels  # noqa: E402
from repro.core import HARDWARE_REGISTRY as JAX_HARDWARE  # noqa: E402
from repro.core.plans import compile_plan as jax_compile_plan  # noqa: E402
from repro.launch.compile_plans import (  # noqa: E402
    serve_bucket_cells as jax_serve_bucket_cells,
)
from repro.models import api as jax_api  # noqa: E402
from repro.serve import BucketPolicy as JaxBucketPolicy  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro.serve import ShapeBucketScheduler as JaxBucketScheduler  # noqa: E402
from repro_torch import configs, kernels  # noqa: E402
from repro_torch.core import (  # noqa: E402
    GTX260, H100_SXM, TilePlan, compile_plan, registry,
)
from repro_torch.core.tiling import TileShape  # noqa: E402
from repro_torch.kernels.flash_attention import decode as fa_decode  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.matmul import ops as mm_ops  # noqa: E402
from repro_torch.kernels.rglru import ops as rglru_ops  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.launch import compile_plans, specs  # noqa: E402
from repro_torch.launch.compile_plans import serve_bucket_cells  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import rglru as rglru_mod  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve import (BucketPolicy, ServeEngine,  # noqa: E402
                               ShapeBucketScheduler)

MARGIN_TOL = 1e-4
EDGES = (8, 16)
SLOTS, MAX_LEN = 2, 32
# Prompt lengths: 3 and 11 lie between edges, 8 and 16 are edges.
LENGTHS = (3, 11, 8, 16)

jax_kernels.register_all()
kernels.register_all()


def h100_plan(arch="qwen2-1.5b", edges=EDGES, slots=SLOTS, max_len=MAX_LEN,
              dtypes=("float32",), smoke=True):
    """An analytic h100_sxm plan of the serving cells the port runs."""
    cells = serve_bucket_cells([arch], edges, slots, max_len, smoke=smoke)
    return compile_plan([(k, p, dt, H100_SXM) for k, p in cells
                         if k in registry.names() for dt in dtypes])


def jax_plan(arch="qwen2-1.5b"):
    """The reference's own plan of the same cells (``tests/test_serve.py``)."""
    cells = jax_serve_bucket_cells([arch], EDGES, SLOTS, MAX_LEN, smoke=True)
    return jax_compile_plan([(k, p, "float32", JAX_HARDWARE["tpu_v5e"])
                             for k, p in cells])


@pytest.fixture(scope="module")
def models():
    cfg_j = jax_configs.get_smoke("qwen2-1.5b")
    cfg_t = configs.get_smoke("qwen2-1.5b")
    pj = jax_api.init_params(cfg_j, jax.random.PRNGKey(0))
    pt = params_from_jax(cfg_t, jax.tree.map(np.asarray, pj), device="cpu")
    return cfg_j, cfg_t, pj, pt


@pytest.fixture(scope="module")
def plan():
    return h100_plan()


def _prompts(cfg, seed=0, lengths=LENGTHS):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, cfg.vocab_size, size=n) for n in lengths]


def _serve(eng, prompts, new=4):
    rids = [eng.add_request(p, max_new_tokens=new) for p in prompts]
    assert all(r is not None for r in rids)
    done = {r.rid: r.out_tokens for r in eng.run_until_done()}
    return [done[r] for r in rids]


def _engine(models, plan=None, bucket=False, **kw):
    _, cfg, _, params = models
    sched = ShapeBucketScheduler(BucketPolicy(EDGES)) if bucket else None
    return ServeEngine(cfg, params, max_len=MAX_LEN, slots=SLOTS, plans=plan,
                       scheduler=sched, device="cpu", **kw)


def _jax_margin(pj, cfg_j, tokens) -> float:
    logits = jax_api.prefill(pj, cfg_j, {"tokens": jnp.asarray(tokens)[None]},
                             max_len=len(tokens))[0][0, :cfg_j.vocab_size]
    top = np.sort(np.asarray(logits))[-2:]
    return float(top[1] - top[0])


def _assert_same_tokens(models, prompt, got, want):
    cfg_j, _, pj, _ = models
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            ctx = np.concatenate([np.asarray(prompt), np.asarray(want[:i])])
            margin = _jax_margin(pj, cfg_j, ctx.astype(np.int32))
            assert margin <= MARGIN_TOL, \
                f"token {i}: {a} != {b} with reference margin {margin:.3g}"
            return        # past a tie the two streams may rightly part


def _by_phase(metrics):
    return metrics.as_dict()["plan"]["by_phase"]


# ---------------------------------------------------------------------------
# Plan sources
# ---------------------------------------------------------------------------

def test_bucketed_prefills_resolve_exactly_and_fifo_by_nearest_shape(
        models, plan):
    cfg = models[1]
    bucketed = _engine(models, plan, bucket=True)
    fifo = _engine(models, plan)
    for eng in (bucketed, fifo):
        _serve(eng, _prompts(cfg))
    assert bucketed.metrics.plan_hit_rate("prefill") == 1.0
    assert bucketed.metrics.plan_hit_rate("decode") == 1.0
    assert set(bucketed.tiles) == {"matmul", "flash_decode", "kv_page"}
    for sources in bucketed._prefill_sources.values():
        assert set(sources.values()) == {"exact"}
    assert fifo.metrics.plan_hit_rate("decode") == 1.0
    assert fifo._prefill_sources[8] == {"matmul": "exact",
                                        "flash_attention": "exact"}
    for n in (3, 11):
        assert set(fifo._prefill_sources[n].values()) == {"nearest_shape"}
    prefill = _by_phase(fifo.metrics)["prefill"]
    assert (prefill["exact"], prefill["nearest_shape"]) == (4, 4)
    assert prefill["tile_fallback"] == 0


@pytest.mark.parametrize("bucket", [True, False], ids=["bucket", "fifo"])
def test_plan_engine_matches_the_reference_engine(models, plan, bucket):
    """The same prompts through the JAX engine with its tpu_v5e plan and
    the port's with its h100_sxm plan: the same tokens (margin rule), and
    the same per-phase counts of exact and nearest_shape resolutions."""
    cfg_j, cfg_t, pj, _ = models
    prompts = _prompts(cfg_t, seed=1)
    sched = (JaxBucketScheduler(JaxBucketPolicy(EDGES)) if bucket else None)
    ej = JaxEngine(cfg_j, pj, max_len=MAX_LEN, slots=SLOTS, plans=jax_plan(),
                   hardware=JAX_HARDWARE["tpu_v5e"], scheduler=sched)
    et = _engine(models, plan, bucket=bucket)
    want = _serve(ej, prompts)
    got = _serve(et, prompts)
    for p, a, b in zip(prompts, got, want):
        _assert_same_tokens(models, p, a, b)
    mine, ref = _by_phase(et.metrics), _by_phase(ej.metrics)
    for phase in ("prefill", "decode"):
        for source in ("exact", "nearest_shape"):
            assert mine[phase][source] == ref[phase][source], (phase, source)
    assert mine["decode"]["exact"] == 3      # matmul, flash_decode, kv_page


def test_tokens_with_a_plan_equal_tokens_without_one(models, plan):
    prompts = _prompts(models[1], seed=2)
    bare = _engine(models)
    got = _serve(_engine(models, plan), prompts, new=8)
    want = _serve(bare, prompts, new=8)
    for p, a, b in zip(prompts, got, want):
        _assert_same_tokens(models, p, a, b)
    assert set(_by_phase(bare.metrics)) == {"prefill"}
    assert _by_phase(bare.metrics)["prefill"]["no_plan"] == 8


# ---------------------------------------------------------------------------
# Tiles reach the call sites
# ---------------------------------------------------------------------------

def test_plan_tiles_reach_the_kernel_call_sites(models, plan, monkeypatch):
    cfg = models[1]
    exact = plan.lookup("flash_attention",
                        dict(sq=16, skv=16, d=cfg.head_dim_,
                             hq=cfg.n_heads, hkv=cfg.n_kv_heads, window=0),
                        "float32", "h100_sxm")
    decode = plan.lookup("flash_decode",
                         dict(b=SLOTS, skv=MAX_LEN, d=cfg.head_dim_,
                              hq=cfg.n_heads, hkv=cfg.n_kv_heads, window=0),
                         "float32", "h100_sxm")
    assert exact is not None and decode is not None
    chunks, bkvs, mm_tiles = [], [], []
    real_ref, real_dec, real_mm = (attn_mod.flash_attention_ref,
                                   attn_mod.flash_decode_ref, transformer.mm)

    def spy_ref(q, k, v, **kw):
        chunks.append(kw.get("chunk"))
        return real_ref(q, k, v, **kw)

    def spy_dec(q, k, v, **kw):
        bkvs.append(kw.get("bkv"))
        return real_dec(q, k, v, **kw)

    def spy_mm(a, b, tile=None):
        mm_tiles.append(tuple(tile))
        return real_mm(a, b, tile=tile)

    monkeypatch.setattr(attn_mod, "flash_attention_ref", spy_ref)
    monkeypatch.setattr(attn_mod, "flash_decode_ref", spy_dec)
    monkeypatch.setattr(transformer, "mm", spy_mm)
    eng = _engine(models, plan, bucket=True)
    _serve(eng, _prompts(cfg, lengths=(12,)), new=3)
    # The prefill's KV chunk is the plan's bkv clamped to the bucket (16),
    # the decode's the plan's bkv clamped to the cache; every GEMM got a
    # plan tile, the prefill's and the decode cell's.
    assert set(chunks) == {min(exact.tile[1], 16)}
    assert set(bkvs) == {min(decode.tile[0], MAX_LEN)}
    assert set(mm_tiles) == {tuple(eng._prefill_tiles[16][0]["matmul"]),
                             tuple(eng.tiles["matmul"])}


# ---------------------------------------------------------------------------
# tile_fallback
# ---------------------------------------------------------------------------

def _with_tile(plan, kernel, problem, tile):
    """``plan`` with the exact entry of (kernel, problem) given ``tile``."""
    out = TilePlan(plan.entries(), meta=plan.meta)
    entry = out.lookup(kernel, problem, "float32", "h100_sxm")
    assert entry is not None
    out.add(dataclasses.replace(entry, tile=TileShape(tile)))
    return out


def test_a_non_dividing_attention_tile_counts_once(models, plan):
    """bkv 32 launches on the card at head dim 16, but a 48-token prompt's
    KV chunk on the CPU snaps to a divisor of 48: one tile_fallback per
    admitted request, however many layers emitted the event."""
    cfg = models[1]
    assert fa.launch_tile((64, 32), cfg.head_dim_, "float32") == (64, 32)
    prob = specs.kernel_problems(cfg, 1, 48, "prefill")["flash_attention"]
    base = h100_plan(edges=(48,), max_len=64)
    bad = _with_tile(base, "flash_attention", prob, (64, 32))
    _, cfg_t, _, params = models
    eng = ServeEngine(cfg_t, params, max_len=64, slots=SLOTS, plans=bad,
                      device="cpu")
    _serve(eng, _prompts(cfg, lengths=(48,)), new=3)
    assert _by_phase(eng.metrics)["prefill"]["tile_fallback"] == 1
    assert eng._prefill_tiles[48][0]["flash_attention"] == TileShape((64, 32))
    _serve(eng, _prompts(cfg, seed=5, lengths=(48,)), new=3)
    assert _by_phase(eng.metrics)["prefill"]["tile_fallback"] == 2


def test_a_matmul_tile_that_does_not_launch_is_replaced_once(
        models, plan, monkeypatch):
    """A wgmma tile in a float32 cell: the engine replaces it by the
    default before any kernel sees it, and counts one tile_fallback."""
    cfg = models[1]
    prob = specs.kernel_problems(cfg, 1, 16, "prefill")["matmul"]
    bad = _with_tile(plan, "matmul", prob, (64, 64, 128))
    assert not specs.tile_launches("matmul", (64, 64, 128), cfg, "float32", 16)
    seen = []
    real_mm = transformer.mm

    def spy_mm(a, b, tile=None):
        seen.append(tuple(tile))
        return real_mm(a, b, tile=tile)

    monkeypatch.setattr(transformer, "mm", spy_mm)
    eng = _engine(models, bad, bucket=True)
    _serve(eng, _prompts(cfg, lengths=(16,)), new=1)
    default = registry.get("matmul").default_tile(prob, "float32")
    assert eng._prefill_tiles[16][0]["matmul"] == default
    assert (64, 64, 128) not in seen and tuple(default) in seen
    counts = _by_phase(eng.metrics)["prefill"]
    assert counts["tile_fallback"] == 1 and counts["exact"] == 2
    assert eng.metrics.plan_hit_rate("prefill") == pytest.approx(2 / 3)


def test_a_decode_tile_that_does_not_launch_counts_once_per_engine(models):
    """bkv 2048 over a 2048-row cache: its block overflows shared memory.
    Replaced at resolution and counted once, for two slots and many decode
    steps."""
    _, cfg, _, params = models
    long_len = 2048
    prob = specs.kernel_problems(cfg, SLOTS, long_len, "decode")["flash_decode"]
    bad = _with_tile(h100_plan(max_len=long_len), "flash_decode", prob,
                     (long_len,))
    with pytest.raises(ValueError, match="shared memory"):
        fa_decode.launch_bkv(long_len, long_len, cfg.head_dim_, cfg.gqa_ratio)
    eng = ServeEngine(cfg, params, max_len=long_len, slots=SLOTS, plans=bad,
                      device="cpu")
    _serve(eng, _prompts(cfg), new=6)
    decode = _by_phase(eng.metrics)["decode"]
    # exact: matmul, kv_page and the flash_decode cell the plan held.
    assert decode["tile_fallback"] == 1 and decode["exact"] == 3
    assert eng.tiles["flash_decode"] == \
        registry.get("flash_decode").default_tile(prob, "float32")


def test_a_non_dividing_decode_chunk_counts_once_per_engine(models):
    """bkv 24 over a 32-row cache: the CPU's chunked decode snaps it to 16.
    The event fires in every layer of every step of both slots; it counts
    once."""
    cfg = models[1]
    prob = specs.kernel_problems(cfg, SLOTS, MAX_LEN, "decode")["flash_decode"]
    bad = _with_tile(h100_plan(), "flash_decode", prob, (24,))
    eng = _engine(models, bad)
    _serve(eng, _prompts(cfg), new=6)
    assert eng.tiles["flash_decode"] == TileShape((24,))
    assert _by_phase(eng.metrics)["decode"]["tile_fallback"] == 1


def _scan_case(kernel):
    """(config, prompt length, a tile the scan's kernel would not launch):
    an SSD chunk 44 steps over the kernel's longest on a 300-token mamba2
    prompt, and an RG-LRU block of 1056 features on a recurrentgemma smoke
    config whose LRU is 1056 wide (a block takes at most 1024)."""
    if kernel == "ssd":
        qmax = ssd_ops._layout()["QMAX"]
        return configs.get_smoke("mamba2-2.7b"), 300, (qmax + 44,)
    base = configs.get_smoke("recurrentgemma-9b")
    cfg = dataclasses.replace(
        base, recurrent=dataclasses.replace(base.recurrent, lru_width=1056))
    return cfg, 24, (32, 1056)


@pytest.mark.parametrize("kernel", ["ssd", "rglru"])
def test_a_scan_tile_that_does_not_launch_is_replaced_once(kernel,
                                                           monkeypatch):
    cfg, length, bad_tile = _scan_case(kernel)
    prob = specs.kernel_problems(cfg, 1, length, "prefill")[kernel]
    assert not specs.tile_launches(kernel, bad_tile, cfg, "float32", length)
    with pytest.raises(ValueError):
        if kernel == "ssd":
            ssd_ops.launch_chunk(bad_tile[0], prob, "float32")
        else:
            rglru_ops.launch_tile(bad_tile, prob)
    bad = _with_tile(compile_plan([(kernel, prob, "float32", H100_SXM)]),
                     kernel, prob, bad_tile)
    seen = []
    if kernel == "ssd":
        real_ssd = ssm_mod.ssd

        def spy(*args, chunk=None, **kw):
            seen.append(chunk)
            return real_ssd(*args, chunk=chunk, **kw)

        monkeypatch.setattr(ssm_mod, "ssd", spy)
    else:
        real_rglru = rglru_mod.rglru

        def spy(*args, tile=None, **kw):
            seen.append(None if tile is None else tuple(tile))
            return real_rglru(*args, tile=tile, **kw)

        monkeypatch.setattr(rglru_mod, "rglru", spy)
    params = api.init_params(cfg, 0, device="cpu")
    prompt = _prompts(cfg, seed=7, lengths=(length,))

    def engine(plans):
        return ServeEngine(cfg, params, max_len=length + 8, slots=1,
                           plans=plans, device="cpu")

    eng = engine(bad)
    got = _serve(eng, prompt)
    default = registry.get(kernel).default_tile(prob, "float32")
    assert eng._prefill_tiles[length][0][kernel] == default
    assert _by_phase(eng.metrics)["prefill"]["tile_fallback"] == 1
    assert bad_tile not in seen and seen
    assert _serve(engine(None), prompt) == got


# ---------------------------------------------------------------------------
# set_plans
# ---------------------------------------------------------------------------

def test_set_plans_drops_plan_state_and_keeps_the_tokens(models, plan):
    prompts = _prompts(models[1], seed=3)
    eng = _engine(models, plan, bucket=True)
    first = _serve(eng, prompts)
    assert eng._prefill_tiles and eng.tiles
    eng.set_plans(None)
    assert not eng._prefill_tiles and not eng._prefill_sources
    assert eng.tiles == {} and eng._decode_tile_events is None
    assert all(s.graph is None and not s.launches for s in eng._slots)
    bare = _serve(eng, prompts)
    eng.set_plans(plan)
    assert set(eng.tiles) == {"matmul", "flash_decode", "kv_page"}
    again = _serve(eng, prompts)
    assert again == first
    for p, a, b in zip(prompts, bare, first):
        _assert_same_tokens(models, p, a, b)
    # Decode sources: one resolution per plan loaded, at construction and
    # at the second set_plans, of three cells (matmul, flash_decode,
    # kv_page).
    assert _by_phase(eng.metrics)["decode"]["exact"] == 6
    assert _by_phase(eng.metrics)["prefill"]["no_plan"] == 8


def test_the_default_hardware_is_the_h100(models, plan):
    _, cfg, _, params = models
    for hw in (H100_SXM, None):
        eng = ServeEngine(cfg, params, max_len=MAX_LEN, slots=SLOTS,
                          plans=plan, hardware=hw, device="cpu")
        assert eng.hardware is H100_SXM
    # A plan with no cell for the hardware resolves nothing exactly: the
    # paper's GTX260 takes the H100's cells by cross-hardware transfer.
    eng = ServeEngine(cfg, params, max_len=MAX_LEN, slots=SLOTS, plans=plan,
                      hardware=GTX260, device="cpu")
    assert set(eng.tile_sources.values()) <= {"cross_hardware", "fallback"}
    assert eng.metrics.plan_hit_rate("decode") == 0.0


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------

def test_compile_and_serve_clis_with_a_serve_plan(tmp_path, capsys):
    from repro_torch.launch import serve

    out = str(tmp_path / "serve.json")
    compile_plans.main(["--measure", "analytic", "--archs", "qwen2-1.5b",
                        "--dtypes", "float32", "--serve-buckets", "8,16",
                        "--serve-slots", "4", "--serve-max-len", "128",
                        "--serve-smoke", "--out", out])
    printed = capsys.readouterr().out
    assert "0 infeasible" in printed
    art = json.loads(open(out).read())
    assert art["meta"]["serve_buckets"] == [8, 16]
    smoke = configs.get_smoke("qwen2-1.5b")
    cells = {(e["kernel"], json.dumps(e["problem"], sort_keys=True))
             for e in art["entries"]}
    for kernel, problem in serve_bucket_cells(["qwen2-1.5b"], (8, 16), 4,
                                              128, smoke=True):
        if kernel in registry.names():
            assert (kernel, json.dumps(problem, sort_keys=True)) in cells
    assert ("flash_decode", json.dumps(dict(
        b=4, d=smoke.head_dim_, hkv=smoke.n_kv_heads, hq=smoke.n_heads,
        skv=128, window=0), sort_keys=True)) in cells
    serve.main(["--device", "cpu", "--requests", "3", "--new-tokens", "3",
                "--tile-plans", out, "--hardware", "h100_sxm",
                "--scheduler", "bucket", "--bucket-policy", "plan"])
    printed = capsys.readouterr().out
    assert "3 requests (0 rejected), 9 tokens" in printed
    assert "plan hit rate: 1.00 (prefill 1.00, decode 1.00)" in printed
    serve.main(["--device", "cpu", "--requests", "3", "--new-tokens", "3",
                "--tile-plans", out])
    printed = capsys.readouterr().out
    # FIFO: raw lengths of 4-11 tokens, of which only 8 is an edge.
    assert "decode 1.00)" in printed
    counts = re.search(r"counts (\{.*\})", printed).group(1)
    counts = ast.literal_eval(counts)
    assert counts["nearest_shape"] > 0
    # Two prefill cells a request, three decode cells (kv_page's too).
    assert counts["exact"] + counts["nearest_shape"] == 3 * 2 + 3
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--scheduler", "bucket",
                    "--bucket-policy", "plan"])


# ---------------------------------------------------------------------------
# Launchability sweep: full width, no card, no weights
# ---------------------------------------------------------------------------

SWEEP_EDGES = (16, 128, 512, 1024)
SWEEP_MAX_LEN = 1024


def _launches(kernel, tile, cfg, dtype, tokens, cache_lens):
    """The kernels' own launch rules, called directly."""
    if kernel == "matmul":
        for k, n in ((cfg.d_model, cfg.d_ff), (cfg.d_ff, cfg.d_model)):
            mm_ops.launch_tile(tile, tokens, n, k, dtype)
    elif kernel == "flash_attention":
        fa.launch_tile(tile, cfg.head_dim_, dtype)
    elif kernel == "flash_decode":
        for s in cache_lens:
            fa_decode.launch_bkv(tile[0], s, cfg.head_dim_, cfg.gqa_ratio)
    elif kernel == "ssd":
        ssm = cfg.ssm
        ssd_ops.launch_chunk(tile[0], dict(
            s=tokens, h=ssm.n_heads(cfg.d_model), p=ssm.head_dim,
            n=ssm.d_state), dtype)
    elif kernel == "rglru":
        rglru_ops.launch_tile(tile, dict(s=tokens,
                                         f=cfg.recurrent.lru_width))
    elif kernel == "kv_page":
        # A pool geometry: a page no longer than the longest cache.
        assert 0 < tile[0] <= max(cache_lens), (tile, cache_lens)
    else:
        raise AssertionError(kernel)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "h2o-danube-1.8b",
                                  "gemma2-9b"])
def test_every_tile_the_engine_resolves_at_full_width_launches(arch, dtype):
    cfg = configs.get_arch(arch)
    sweep_plan = h100_plan(arch, SWEEP_EDGES, 4, SWEEP_MAX_LEN,
                           dtypes=(dtype,), smoke=False)
    cache_lens = sorted({SWEEP_MAX_LEN} | (
        {min(SWEEP_MAX_LEN, cfg.attn_window)} if cfg.attn_window else set()))
    tiles, res = specs.resolve_model_tiles(
        sweep_plan, cfg, 4, SWEEP_MAX_LEN, "decode", dtype, H100_SXM)
    assert {k: r.source for k, r in res.items()} == {
        "matmul": "exact", "flash_decode": "exact", "kv_page": "exact"}
    # Paged, the decode attends over the table's view of whole pages.
    page = tiles["kv_page"][0]
    cache_lens.append(-(-SWEEP_MAX_LEN // page) * page)
    tiles, _ = specs.launchable_tiles(tiles, cfg, 4, SWEEP_MAX_LEN, "decode",
                                      dtype, tokens=1, cache_lens=cache_lens)
    for kernel, tile in tiles.items():
        _launches(kernel, tile, cfg, dtype, 1, cache_lens)
    sources = set()
    for length in range(1, SWEEP_MAX_LEN + 1):
        tiles, res = specs.resolve_model_tiles(
            sweep_plan, cfg, 1, length, "prefill", dtype, H100_SXM)
        sources |= {r.source for r in res.values()}
        tiles, _ = specs.launchable_tiles(tiles, cfg, 1, length, "prefill",
                                          dtype, tokens=length)
        assert set(tiles) == {"matmul", "flash_attention"}
        for kernel, tile in tiles.items():
            _launches(kernel, tile, cfg, dtype, length, ())
    assert sources == {"exact", "nearest_shape"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "recurrentgemma-9b"])
def test_every_scan_tile_the_engine_resolves_at_full_width_launches(arch,
                                                                    dtype):
    """The two recurrent archs at full width: every tile the engine would
    resolve, decode and every prefill length up to ``max_len``, the SSD and
    RG-LRU tiles included, is one the kernels launch."""
    cfg = configs.get_arch(arch)
    scan = "ssd" if arch.startswith("mamba2") else "rglru"
    sweep_plan = h100_plan(arch, SWEEP_EDGES, 4, SWEEP_MAX_LEN,
                           dtypes=(dtype,), smoke=False)
    cache_lens = ([min(SWEEP_MAX_LEN, cfg.attn_window)] if cfg.attn_window
                  else [])
    tiles, res = specs.resolve_model_tiles(
        sweep_plan, cfg, 4, SWEEP_MAX_LEN, "decode", dtype, H100_SXM)
    assert res[scan].source == "exact"
    tiles, _ = specs.launchable_tiles(tiles, cfg, 4, SWEEP_MAX_LEN, "decode",
                                      dtype, tokens=1, cache_lens=cache_lens)
    for kernel, tile in tiles.items():
        _launches(kernel, tile, cfg, dtype, 1, cache_lens)
    sources = set()
    for length in range(1, SWEEP_MAX_LEN + 1):
        tiles, res = specs.resolve_model_tiles(
            sweep_plan, cfg, 1, length, "prefill", dtype, H100_SXM)
        sources |= {r.source for r in res.values()}
        tiles, _ = specs.launchable_tiles(tiles, cfg, 1, length, "prefill",
                                          dtype, tokens=length)
        assert scan in tiles
        for kernel, tile in tiles.items():
            _launches(kernel, tile, cfg, dtype, length, ())
    assert sources == {"exact", "nearest_shape"}
