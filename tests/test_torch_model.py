"""The port's dense decoder against the JAX reference, on the CPU.

Parameters come from the reference's ``api.init_params`` and reach the port
through numpy (``models/convert.py:params_from_jax``), so both sides compute
with the same weights. The port runs its plain PyTorch versions here (CPU
tensors). Tolerances: float32, 1e-4 on logits (each side sums in its own
order through every layer) and 1e-5 on single layers.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.launch import specs as jax_specs  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import transformer as jax_T  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import H100_SXM  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models import api, attention, layers, transformer  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
# Dense decoders the slice ports: qwen2 (the main path: GQA, qkv bias, tied
# head), h2o-danube (sliding window), command-r (parallel block, layernorm)
# and gemma2 (local/global pattern, softcaps, post-norms, gelu, linear cache).
DENSE = ["qwen2-1.5b", "h2o-danube-1.8b", "command-r-35b", "gemma2-9b"]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=DENSE)
def both(request):
    name = request.param
    cfg_j = jax_configs.get_smoke(name)
    cfg_t = configs.get_smoke(name)
    pj = jax_api.init_params(cfg_j, jax.random.PRNGKey(0))
    pt = params_from_jax(cfg_t, _np_tree(pj), device="cpu")
    return name, cfg_j, cfg_t, pj, pt


# ---------------------------------------------------------------------------
# Plain data: configs, segments, tiling problems
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", jax_configs.list_archs())
def test_configs_are_the_reference_configs(name):
    assert configs.list_archs() == jax_configs.list_archs()
    for get in ("get_arch", "get_smoke"):
        a = dataclasses.asdict(getattr(configs, get)(name))
        b = dataclasses.asdict(getattr(jax_configs, get)(name))
        assert a == b
    cfg_t, cfg_j = configs.get_arch(name), jax_configs.get_arch(name)
    assert (cfg_t.padded_heads, cfg_t.padded_kv_heads, cfg_t.padded_vocab) \
        == (cfg_j.padded_heads, cfg_j.padded_kv_heads, cfg_j.padded_vocab)


@pytest.mark.parametrize("name", jax_configs.list_archs())
def test_decompose_matches_reference(name):
    def plain(segments):   # LayerSpecs of the two packages as tuples
        return [tuple(tuple(dataclasses.astuple(s) for s in part)
                      if isinstance(part, tuple) else part for part in seg)
                for seg in segments]

    for get in ("get_arch", "get_smoke"):
        assert plain(transformer.decompose(getattr(configs, get)(name))) == \
            plain(jax_T.decompose(getattr(jax_configs, get)(name)))


@pytest.mark.parametrize("name", jax_configs.list_archs())
def test_kernel_problems_match_reference(name):
    cfg_t, cfg_j = configs.get_arch(name), jax_configs.get_arch(name)
    for batch, seq, kind in ((1, 600, "prefill"), (4, 1024, "decode"),
                             (8, 4096, "train"), (1, 256, "chunked_prefill"),
                             (1, 256, "packed_prefill")):
        assert specs.kernel_problems(cfg_t, batch, seq, kind) == \
            jax_specs.kernel_problems(cfg_j, batch, seq, kind)


def test_qwen2_full_width_geometry():
    cfg = configs.get_arch("qwen2-1.5b")
    assert (cfg.n_layers, cfg.d_model, cfg.head_dim_, cfg.d_ff) == \
        (28, 1536, 128, 8960)
    assert (cfg.n_heads, cfg.padded_heads, cfg.padded_kv_heads) == (12, 16, 2)
    assert (cfg.vocab_size, cfg.padded_vocab) == (151936, 153600)
    tiles, resolutions = specs.resolve_model_tiles(None, cfg, 1, 600,
                                                   "prefill", "float32",
                                                   H100_SXM)
    assert set(tiles) == {"matmul", "flash_attention"} and resolutions == {}


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def test_converted_params_have_the_ports_layout(both):
    name, _, cfg_t, _, pt = both
    gen = torch.Generator().manual_seed(0)
    own = transformer.init_params(cfg_t, gen, device="cpu")

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return tuple(tree.shape)

    assert shapes(pt) == shapes(own)
    assert len(pt["layers"]) == cfg_t.n_layers


def test_init_distributions_follow_the_reference():
    cfg = configs.get_smoke("qwen2-1.5b")
    p = api.init_params(cfg, 3, device="cpu")
    emb = p["embed"]
    assert abs(float(emb.std()) - 0.02) < 2e-3
    w1 = p["layers"][0]["ff"]["w1"]
    assert abs(float(w1.std()) - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    assert float(p["layers"][0]["norm1_w"].abs().max()) == 0.0
    again = api.init_params(cfg, 3, device="cpu")
    assert torch.equal(again["layers"][1]["attn"]["wq"],
                       p["layers"][1]["attn"]["wq"])


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def test_norms_rope_and_activations_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    w = (rng.standard_normal(16) * 0.1).astype(np.float32)
    b = (rng.standard_normal(16) * 0.1).astype(np.float32)
    pos = np.tile(np.arange(3, 8, dtype=np.int32)[None], (2, 1))
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, b))
    pairs = [
        (layers.rms_norm(xt, wt, 1e-6), jax_layers.rms_norm(x, w, 1e-6)),
        (layers.layer_norm(xt, wt, bt, 1e-5),
         jax_layers.layer_norm(x, w, b, 1e-5)),
        (layers.apply_rope(xt, torch.from_numpy(pos).long(), 1e6),
         jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        (layers.softcap(xt, 2.0), jax_layers.softcap(x, 2.0)),
    ]
    for act in ("silu", "gelu", "gelu_tanh"):
        pairs.append((layers.act_fn(act)(xt), jax_layers.act_fn(act)(x)))
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


def test_attention_block_matches_reference():
    """attn_forward (prefill, cache filled in place) then attn_decode, with
    the padded query heads masked."""
    cfg_t = configs.get_smoke("qwen2-1.5b")
    cfg_j = jax_configs.get_smoke("qwen2-1.5b")
    pj = jax_layers.init_tree(jax_attn.attn_defs(cfg_j), jax.random.PRNGKey(1),
                              jnp.float32)
    pt = {k: torch.from_numpy(np.array(v)) for k, v in pj.items()}
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 12, cfg_t.d_model)).astype(np.float32)
    pos = np.arange(12, dtype=np.int32)[None]
    cj = jax_attn.make_kv_cache(cfg_j, 1, 32, jnp.float32)
    ct = attention.make_kv_cache(cfg_t, 1, 32, torch.float32, device="cpu")
    yj, cj = jax_attn.attn_forward(pj, cfg_j, jnp.asarray(x), jnp.asarray(pos),
                                   cache=cj)
    yt, ct = attention.attn_forward(pt, cfg_t, torch.from_numpy(x),
                                    torch.from_numpy(pos).long(), cache=ct)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **LAYER_TOL)
    np.testing.assert_allclose(ct["k"].numpy(), np.asarray(cj["k"]),
                               **LAYER_TOL)
    assert ct["pos"] == int(cj["pos"]) == 12
    xd = rng.standard_normal((1, 1, cfg_t.d_model)).astype(np.float32)
    for tile in (None, (16,)):
        dj, _ = jax_attn.attn_decode(pj, cfg_j, jnp.asarray(xd), cache=cj,
                                     tile=tile)
        # Decode advances the port's position in place: each tile decodes
        # position 12 from its own copy of it.
        dt, _ = attention.attn_decode(pt, cfg_t, torch.from_numpy(xd),
                                      cache={**ct, "pos": ct["pos"].clone()},
                                      tile=tile)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), **LAYER_TOL)


# ---------------------------------------------------------------------------
# The whole model: prefill logits and 8 decode steps
# ---------------------------------------------------------------------------

def test_forward_full_logits_match_reference(both):
    name, cfg_j, cfg_t, pj, pt = both
    tokens = np.random.default_rng(2).integers(0, cfg_t.vocab_size, (2, 11))
    want = jax_T.forward(pj, cfg_j, jnp.asarray(tokens)).logits
    got = transformer.forward(pt, cfg_t, torch.from_numpy(tokens)).logits
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def test_prefill_and_8_decode_steps_match_reference(both):
    name, cfg_j, cfg_t, pj, pt = both
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg_t.vocab_size, (1, 13)).astype(np.int32)
    max_len = 32
    lj, sj = jax_api.prefill(pj, cfg_j, {"tokens": jnp.asarray(prompt)},
                             max_len=max_len)
    lt, st = api.prefill(pt, cfg_t, {"tokens": prompt}, max_len=max_len)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    for step in range(8):
        # Teacher-force the reference's greedy token into both.
        tok = np.asarray(jnp.argmax(lj[:, :cfg_j.vocab_size], axis=-1),
                         np.int32)[:, None]
        lj, sj = jax_api.decode_step(pj, cfg_j, jnp.asarray(tok), sj)
        lt, st = api.decode_step(pt, cfg_t, tok, st)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL,
                                   err_msg=f"{name} decode step {step}")
    assert st[0]["pos"] == 13 + 8


def test_decode_with_a_tile_takes_the_chunked_reference():
    """With a resolved decode tile the CPU path runs flash_decode_ref (the
    reference's flash_ref lowering) and agrees with the dense attend."""
    cfg = configs.get_smoke("qwen2-1.5b")
    p = api.init_params(cfg, 1, device="cpu")
    prompt = np.arange(2, 12)[None]
    logits, state = api.prefill(p, cfg, {"tokens": prompt}, max_len=64)
    _, state2 = api.prefill(p, cfg, {"tokens": prompt}, max_len=64)
    tok = torch.tensor([[5]])
    events = []
    with attention.capture_tile_events(events.append):
        a, _ = api.decode_step(p, cfg, tok, state, tiles={"flash_decode": (16,)})
    b, _ = api.decode_step(p, cfg, tok, state2)
    np.testing.assert_allclose(a.numpy(), b.numpy(), **LAYER_TOL)
    assert events and all(e["impl"] == "flash_ref" and not e["fallback"]
                          for e in events)


@pytest.mark.parametrize("name", jax_configs.list_archs())
def test_smoke_serve_every_family(name):
    """Every config runs through the model API (``tests/test_configs_smoke.py
    :test_smoke_serve``): finite logits of shape [B, padded_vocab] from
    ``init_params``, ``prefill`` (frames for the encoder-decoder, patch
    embeddings for the vision model) and one ``decode_step``."""
    cfg = configs.get_smoke(name)
    params = api.init_params(cfg, 1, device="cpu")
    rng = np.random.default_rng(1)
    b, s = 2, 16
    batch = {"tokens": rng.integers(0, cfg.vocab_size, size=(b, s))}
    if api.is_encdec(cfg):
        batch["frames"] = rng.standard_normal(
            (b, cfg.encoder.seq_len, cfg.d_model)).astype(np.float32)
    if api.is_vlm(cfg):
        batch["patch_embeds"] = rng.standard_normal(
            (b, cfg.encoder.seq_len, 1024)).astype(np.float32)
    extra = cfg.encoder.seq_len if api.is_vlm(cfg) else 0
    logits, state = api.prefill(params, cfg, batch, max_len=s + extra + 4)
    assert tuple(logits.shape) == (b, cfg.padded_vocab)
    logits2, state = api.decode_step(params, cfg, batch["tokens"][:, :1],
                                     state)
    assert tuple(logits2.shape) == (b, cfg.padded_vocab)
    assert torch.isfinite(logits2).all()
