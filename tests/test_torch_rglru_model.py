"""The port's RG-LRU block and the recurrentgemma smoke model against the JAX
reference, on the CPU.

Parameters come from the reference's initialisers and reach the port
through numpy (``models/convert.py:params_from_jax``); inputs and states are
numpy-seeded. The port's block runs the gate math in PyTorch and the scan
through the RG-LRU wrapper, whose CPU path is the plain scan; with
``impl="reference"`` the plain ``rglru_ref``; the reference's block runs
its jnp ``rglru_ref``. Tolerances, float32: 1e-5 on a block and its new
state, 1e-4 on logits (through every layer). The smoke model's local
attention keeps 16-slot rings, so a 13-token prompt and 8 decode steps
cross a wrap, and a 20-token prompt wraps at prefill.

A serving slot keeps its tensors for its whole life, its RG-LRU states and
its rings alike: every prefill empties them, every step writes into them.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import rglru as jax_rglru  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import H100_SXM  # noqa: E402
from repro_torch.core.tiling import TileShape  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models import api, rglru, transformer  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

ARCH = "recurrentgemma-9b"
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
LENGTHS = [1, 12, 128, 256]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _to_torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.fixture(scope="module")
def block():
    cfg_j, cfg_t = jax_configs.get_smoke(ARCH), configs.get_smoke(ARCH)
    pj = jax_layers.init_tree(jax_rglru.rglru_defs(cfg_j),
                              jax.random.PRNGKey(5), jnp.float32)
    return cfg_j, cfg_t, pj, _to_torch(_np_tree(pj))


@pytest.fixture(scope="module")
def model():
    cfg_j, cfg_t = jax_configs.get_smoke(ARCH), configs.get_smoke(ARCH)
    pj = jax_api.init_params(cfg_j, jax.random.PRNGKey(0))
    pt = params_from_jax(cfg_t, _np_tree(pj), device="cpu")
    return cfg_j, cfg_t, pj, pt


def _random_state(cfg, seed):
    rng = np.random.default_rng(seed)
    shapes = {k: tuple(v.shape) for k, v in rglru.make_rglru_state(
        cfg, 1, torch.float32, device="cpu").items()}
    return {k: (rng.standard_normal(s) * 0.5).astype(np.float32)
            for k, s in shapes.items()}


# ---------------------------------------------------------------------------
# The block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["auto", "reference"])
@pytest.mark.parametrize("s", LENGTHS)
@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_forward_matches_reference(block, impl, s, with_state):
    cfg_j, cfg_t, pj, pt = block
    x = np.random.default_rng(s).standard_normal(
        (1, s, cfg_t.d_model)).astype(np.float32)
    st = _random_state(cfg_t, seed=s + 1) if with_state else None
    yj, nj = jax_rglru.rglru_forward(
        pj, cfg_j, jnp.asarray(x),
        state=None if st is None else {k: jnp.asarray(v) for k, v in st.items()})
    state_t = None if st is None else _to_torch(st)
    yt, nt = rglru.rglru_forward(pt, cfg_t, torch.from_numpy(x),
                                 state=state_t, impl=impl)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **LAYER_TOL)
    if st is None:
        assert nt is None and nj is None
        return
    assert nt is state_t                      # written in place
    assert set(nt) == set(nj) == {"conv", "h"}
    for k in nj:
        np.testing.assert_allclose(nt[k].numpy(), np.asarray(nj[k]),
                                   **LAYER_TOL, err_msg=k)


def test_rglru_forward_hands_the_tile_to_the_scan(block, monkeypatch):
    cfg_j, cfg_t, pj, pt = block
    seen = []
    real = rglru.rglru

    def spy(*args, tile=None, **kw):
        seen.append(tile)
        return real(*args, tile=tile, **kw)

    monkeypatch.setattr(rglru, "rglru", spy)
    x = np.random.default_rng(2).standard_normal(
        (1, 40, cfg_t.d_model)).astype(np.float32)
    yt, _ = rglru.rglru_forward(pt, cfg_t, torch.from_numpy(x),
                                tile=TileShape((16, 32)))
    yj, _ = jax_rglru.rglru_forward(pj, cfg_j, jnp.asarray(x))
    assert seen == [TileShape((16, 32))]
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **LAYER_TOL)


def test_make_rglru_state_is_the_references(block):
    cfg_j, cfg_t, _, _ = block
    want = jax_rglru.make_rglru_state(cfg_j, 2, jnp.float32)
    got = rglru.make_rglru_state(cfg_t, 2, torch.float32, device="cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert all(float(v.abs().max()) == 0.0 for v in got.values())


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def test_converted_params_and_caches_have_the_ports_layout(model):
    _, cfg_t, _, pt = model
    own = transformer.init_params(cfg_t, torch.Generator().manual_seed(0),
                                  device="cpu")

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return tuple(tree.shape)

    assert shapes(pt) == shapes(own)
    mixers = [spec.mixer for spec in cfg_t.layers()]
    assert mixers == ["rglru", "rglru", "local_attn", "rglru", "rglru"]
    assert ["rglru" in lp for lp in pt["layers"]] == \
        [m == "rglru" for m in mixers]
    caches = api.make_serve_state(cfg_t, 1, 64, torch.float32, device="cpu",
                                  ring_local=True)
    assert [sorted(c) for c in caches] == [
        ["conv", "h"], ["conv", "h"], ["k", "pos", "slot_pos", "v"],
        ["conv", "h"], ["conv", "h"]]
    assert caches[2]["k"].shape[2] == cfg_t.attn_window == 16


def test_full_width_geometry_and_tiles():
    cfg = configs.get_arch(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.recurrent.lru_width,
            cfg.head_dim_, cfg.d_ff, cfg.attn_window) == \
        (38, 4096, 4096, 256, 12288, 2048)
    tiles, _ = specs.resolve_model_tiles(None, cfg, 1, 2100, "prefill",
                                         "float32", H100_SXM)
    assert set(tiles) == {"matmul", "flash_attention", "rglru"}
    assert tiles["rglru"] == TileShape((32, 128))
    tiles, _ = specs.resolve_model_tiles(None, cfg, 4, 2304, "decode",
                                         "float32", H100_SXM)
    assert tiles["rglru"] == TileShape((1, 128))


def _serve_other_request(pt, cfg, caches):
    other = np.random.default_rng(9).integers(0, cfg.vocab_size, (1, 19))
    logits, _ = api.prefill(pt, cfg, {"tokens": other}, max_len=64,
                            ring_local=True, caches=caches)
    for _ in range(3):
        tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1, keepdim=True)
        logits, _ = api.decode_step(pt, cfg, tok, caches)


@pytest.mark.parametrize("reuse", [False, True], ids=["fresh", "reused"])
@pytest.mark.parametrize("prompt_len", [13, 20])
def test_prefill_and_8_decode_steps_match_reference(model, reuse, prompt_len):
    """13 tokens: the 8 steps cross the 16-slot rings' wrap; 20 tokens:
    they wrap at prefill."""
    cfg_j, cfg_t, pj, pt = model
    prompt = np.random.default_rng(prompt_len).integers(
        0, cfg_t.vocab_size, (1, prompt_len)).astype(np.int32)
    caches = None
    if reuse:
        caches = api.make_serve_state(cfg_t, 1, 64, torch.float32,
                                      device="cpu", ring_local=True)
        _serve_other_request(pt, cfg_t, caches)
    lj, sj = jax_api.prefill(pj, cfg_j, {"tokens": jnp.asarray(prompt)},
                             max_len=64, ring_local=True)
    lt, st = api.prefill(pt, cfg_t, {"tokens": prompt}, max_len=64,
                         ring_local=True, caches=caches)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    for step in range(8):
        tok = np.asarray(jnp.argmax(lj[:, :cfg_j.vocab_size], axis=-1),
                         np.int32)[:, None]
        lj, sj = jax_api.decode_step(pj, cfg_j, jnp.asarray(tok), sj)
        lt, st = api.decode_step(pt, cfg_t, tok, st)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL,
                                   err_msg=f"decode step {step}")
    assert int(st[2]["pos"]) == prompt_len + 8
    assert int(st[2]["slot_pos"].max()) == prompt_len + 7


# ---------------------------------------------------------------------------
# A serving slot's state
# ---------------------------------------------------------------------------

def _ptrs(caches):
    return [{k: t.data_ptr() for k, t in c.items()} for c in caches]


def test_slot_state_keeps_its_tensors_across_requests(model):
    _, cfg, _, pt = model
    eng = ServeEngine(cfg, pt, max_len=64, slots=1, device="cpu")
    caches = eng._slots[0].caches
    before = _ptrs(caches)
    for seed in (0, 1):
        prompt = np.random.default_rng(seed).integers(2, cfg.vocab_size, 14)
        eng.add_request(prompt, max_new_tokens=6)
        eng.run_until_done()
        assert _ptrs(caches) == before
    assert float(caches[0]["h"].abs().max()) > 0.0


def test_a_used_slot_serves_what_a_fresh_one_serves(model):
    _, cfg, _, pt = model
    rng = np.random.default_rng(6)
    first, second = (rng.integers(2, cfg.vocab_size, n) for n in (22, 7))
    used = ServeEngine(cfg, pt, max_len=64, slots=1, device="cpu")
    used.add_request(first, max_new_tokens=6)
    used.run_until_done()
    used.add_request(second, max_new_tokens=6)
    got = used.run_until_done()[0].out_tokens
    fresh = ServeEngine(cfg, pt, max_len=64, slots=1, device="cpu")
    fresh.add_request(second, max_new_tokens=6)
    assert got == fresh.run_until_done()[0].out_tokens


def test_a_wider_lru_runs_every_layer_through_its_state():
    """The reset and the in-place writes hold for any width: a variant of
    the smoke config with a 96-wide LRU, prefill then decode, state by
    state against a fresh prefill of the whole sequence."""
    base = configs.get_smoke(ARCH)
    cfg = dataclasses.replace(
        base, recurrent=dataclasses.replace(base.recurrent, lru_width=96))
    p = api.init_params(cfg, 2, device="cpu")
    seq = np.random.default_rng(4).integers(2, cfg.vocab_size, (1, 11))
    logits, st = api.prefill(p, cfg, {"tokens": seq[:, :10]}, max_len=32,
                             ring_local=True)
    logits, st = api.decode_step(p, cfg, torch.as_tensor(seq[:, 10:]), st)
    whole, st2 = api.prefill(p, cfg, {"tokens": seq}, max_len=32,
                             ring_local=True)
    np.testing.assert_allclose(logits.numpy(), whole.numpy(), **LOGIT_TOL)
    for a, b in zip(st, st2):
        if "h" in a:
            np.testing.assert_allclose(a["h"].numpy(), b["h"].numpy(),
                                       **LAYER_TOL)
            np.testing.assert_allclose(a["conv"].numpy(), b["conv"].numpy(),
                                       **LAYER_TOL)
