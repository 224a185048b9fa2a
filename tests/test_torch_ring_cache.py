"""Ring KV caches and the cache position on the device, against the JAX
package, on the CPU.

* ``make_kv_cache(ring=True)``, ``_ring_write`` (prefill) and the ring decode
  of ``attn_decode`` against ``repro/models/attention.py``: prompts shorter
  than, equal to and longer than the window (16 in the smoke configs), then
  decode steps across the wrap; outputs, K/V, ``slot_pos`` and ``pos`` after
  every step;
* prefill and 8 decode steps of the gemma2 and h2o-danube smoke models
  (rings on their local layers) against ``repro.models.api``, fresh and
  after the same caches served another request first (an engine slot's
  reuse);
* the position as a 0-d int32 tensor on the linear path (qwen2 smoke),
  unchanged against JAX;
* ``flash_decode_split_ref`` with the split count fixed by the cache length
  (the kernel's grid) against the JAX Pallas ``flash_decode`` in interpret
  mode, over positions that leave splits empty, and with ``kv_pos``.

Inputs come from a numpy seed; model parameters from the reference's
``init_params`` through ``params_from_jax``. Tolerances (float32): 1e-5 on
one attention block and on the decode kernel's arithmetic (the sums run in
another order), 1e-4 on logits through every layer.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.kernels.flash_attention.decode import (  # noqa: E402
    flash_decode as pallas_decode,
)
from repro.models import api as jax_api  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.tiling import cdiv  # noqa: E402
from repro_torch.kernels.flash_attention import decode as fd  # noqa: E402
from repro_torch.models import api, attention, transformer  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
WINDOWED = ["gemma2-9b", "h2o-danube-1.8b"]


# ---------------------------------------------------------------------------
# One attention block on a ring cache
# ---------------------------------------------------------------------------

def _attn_pair(name, seed):
    cfg_j, cfg_t = jax_configs.get_smoke(name), configs.get_smoke(name)
    pj = jax_layers.init_tree(jax_attn.attn_defs(cfg_j),
                              jax.random.PRNGKey(seed), jnp.float32)
    pt = {k: torch.from_numpy(np.array(v)) for k, v in pj.items()}
    return cfg_j, cfg_t, pj, pt


def _assert_same_cache(ct, cj):
    np.testing.assert_allclose(ct["k"].numpy(), np.asarray(cj["k"]),
                               **LAYER_TOL)
    np.testing.assert_allclose(ct["v"].numpy(), np.asarray(cj["v"]),
                               **LAYER_TOL)
    np.testing.assert_array_equal(ct["slot_pos"].numpy(),
                                  np.asarray(cj["slot_pos"]))
    assert ct["pos"].dtype == torch.int32 and ct["pos"].dim() == 0
    assert int(ct["pos"]) == int(cj["pos"])


def test_ring_cache_layout():
    cfg = configs.get_smoke("h2o-danube-1.8b")
    c = attention.make_kv_cache(cfg, 1, 16, torch.float32, ring=True,
                                device="cpu")
    cj = jax_attn.make_kv_cache(jax_configs.get_smoke("h2o-danube-1.8b"), 1,
                                16, jnp.float32, ring=True)
    assert sorted(c) == sorted(cj) == ["k", "pos", "slot_pos", "v"]
    assert c["k"].shape == cj["k"].shape
    np.testing.assert_array_equal(c["slot_pos"].numpy(),
                                  np.asarray(cj["slot_pos"]))
    assert c["pos"].dtype == torch.int32 and int(c["pos"]) == 0
    # make_caches sizes a local layer's ring at min(max_len, window), as the
    # reference's _cache_for does; global layers stay linear at max_len.
    g = configs.get_smoke("gemma2-9b")
    for max_len, ring_len in ((40, 16), (12, 12)):
        caches = transformer.make_caches(g, 1, max_len, torch.float32,
                                         ring_local=True, device="cpu")
        for spec, cache in zip(g.layers(), caches):
            local = spec.mixer == "local_attn"
            assert ("slot_pos" in cache) == local
            assert cache["k"].shape[2] == (ring_len if local else max_len)
    lin = transformer.make_caches(g, 1, 40, torch.float32, device="cpu")
    assert all("slot_pos" not in c and c["k"].shape[2] == 40 for c in lin)


@pytest.mark.parametrize("tile", [None, (8,)], ids=["dense", "flash_ref"])
@pytest.mark.parametrize("prompt", [5, 16, 23])
def test_ring_prefill_and_decode_across_the_wrap(prompt, tile):
    """A prompt shorter than, equal to or longer than the 16-slot window,
    then 20 decode steps: every step crosses or follows the wrap."""
    name = "h2o-danube-1.8b"
    cfg_j, cfg_t, pj, pt = _attn_pair(name, 5)
    w = cfg_t.attn_window
    rng = np.random.default_rng(prompt)
    x = rng.standard_normal((1, prompt, cfg_t.d_model)).astype(np.float32)
    pos = np.arange(prompt, dtype=np.int32)[None]
    cj = jax_attn.make_kv_cache(cfg_j, 1, w, jnp.float32, ring=True)
    ct = attention.make_kv_cache(cfg_t, 1, w, torch.float32, ring=True,
                                 device="cpu")
    yj, cj = jax_attn.attn_forward(pj, cfg_j, jnp.asarray(x), jnp.asarray(pos),
                                   window=w, cache=cj)
    yt, ct2 = attention.attn_forward(pt, cfg_t, torch.from_numpy(x),
                                     torch.from_numpy(pos).long(), window=w,
                                     cache=ct)
    assert ct2 is ct                      # written in place
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **LAYER_TOL)
    _assert_same_cache(ct, cj)
    for step in range(20):
        xd = rng.standard_normal((1, 1, cfg_t.d_model)).astype(np.float32)
        dj, cj = jax_attn.attn_decode(pj, cfg_j, jnp.asarray(xd), cache=cj,
                                      window=w, tile=tile)
        dt, _ = attention.attn_decode(pt, cfg_t, torch.from_numpy(xd),
                                      cache=ct, window=w, tile=tile)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), **LAYER_TOL,
                                   err_msg=f"decode step {step}")
        _assert_same_cache(ct, cj)
    assert int(ct["pos"]) == prompt + 20


def test_ring_write_keeps_the_tail_of_a_long_chunk():
    cfg = configs.get_smoke("h2o-danube-1.8b")
    c = attention.make_kv_cache(cfg, 1, 8, torch.float32, ring=True,
                                device="cpu")
    hkv, hd = cfg.padded_kv_heads, cfg.head_dim_
    k = torch.arange(13, dtype=torch.float32).view(1, 1, 13, 1).expand(
        1, hkv, 13, hd).contiguous()
    attention._ring_write(c, k, -k, torch.arange(13), 13)
    # Positions 5..12 survive, at slots p % 8.
    want = np.array([8, 9, 10, 11, 12, 5, 6, 7], np.int32)
    np.testing.assert_array_equal(c["slot_pos"].numpy(), want)
    np.testing.assert_array_equal(c["k"][0, 0, :, 0].numpy(), want)
    np.testing.assert_array_equal(c["v"][0, 0, :, 0].numpy(), -want)
    assert int(c["pos"]) == 13
    attention.reset_kv_cache(c)
    assert int(c["pos"]) == 0 and bool((c["slot_pos"] == -1).all())


# ---------------------------------------------------------------------------
# The windowed models: prefill and 8 decode steps
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=WINDOWED)
def windowed(request):
    name = request.param
    cfg_j = jax_configs.get_smoke(name)
    cfg_t = configs.get_smoke(name)
    pj = jax_api.init_params(cfg_j, jax.random.PRNGKey(0))
    pt = params_from_jax(cfg_t, jax.tree.map(np.asarray, pj), device="cpu")
    return name, cfg_j, cfg_t, pj, pt


def _jax_run(pj, cfg_j, prompt, max_len, steps):
    lj, sj = jax_api.prefill(pj, cfg_j, {"tokens": jnp.asarray(prompt)},
                             max_len=max_len, ring_local=True)
    out, toks = [np.asarray(lj)], []
    for _ in range(steps):
        tok = np.asarray(jnp.argmax(lj[:, :cfg_j.vocab_size], axis=-1),
                         np.int32)[:, None]
        toks.append(tok)
        lj, sj = jax_api.decode_step(pj, cfg_j, jnp.asarray(tok), sj)
        out.append(np.asarray(lj))
    return out, toks


@pytest.mark.parametrize("prompt_len", [6, 13, 21])
def test_windowed_model_prefill_and_8_decode_steps(windowed, prompt_len):
    """Rings of 16 slots (max_len 32): a 6-token prompt stays inside the
    window, 13 wraps during decode, 21 overflows it at prefill."""
    name, cfg_j, cfg_t, pj, pt = windowed
    prompt = np.random.default_rng(prompt_len).integers(
        0, cfg_t.vocab_size, (1, prompt_len)).astype(np.int32)
    want, toks = _jax_run(pj, cfg_j, prompt, 32, 8)
    lt, st = api.prefill(pt, cfg_t, {"tokens": prompt}, max_len=32,
                         ring_local=True)
    assert any("slot_pos" in c for c in st)
    np.testing.assert_allclose(lt.numpy(), want[0], **LOGIT_TOL)
    for step, tok in enumerate(toks):
        lt, st = api.decode_step(pt, cfg_t, tok, st)
        np.testing.assert_allclose(lt.numpy(), want[step + 1], **LOGIT_TOL,
                                   err_msg=f"{name} decode step {step}")
    assert all(int(c["pos"]) == prompt_len + 8 for c in st)


def test_prefill_into_used_caches_matches_a_fresh_run(windowed):
    """An engine slot keeps its caches: a second request prefilled into
    caches that a first one wrapped gives the reference's fresh logits."""
    name, cfg_j, cfg_t, pj, pt = windowed
    rng = np.random.default_rng(9)
    first = rng.integers(0, cfg_t.vocab_size, (1, 20)).astype(np.int32)
    second = rng.integers(0, cfg_t.vocab_size, (1, 7)).astype(np.int32)
    caches = api.make_serve_state(cfg_t, 1, 32, torch.float32, device="cpu",
                                  ring_local=True)
    lt, st = api.prefill(pt, cfg_t, {"tokens": first}, max_len=32,
                         caches=caches)
    for _ in range(6):
        lt, st = api.decode_step(pt, cfg_t, torch.argmax(
            lt[:, :cfg_t.vocab_size], dim=-1, keepdim=True), st)
    want, toks = _jax_run(pj, cfg_j, second, 32, 8)
    lt, st = api.prefill(pt, cfg_t, {"tokens": second}, max_len=32,
                         caches=caches)
    assert all(a is b for a, b in zip(st, caches))
    np.testing.assert_allclose(lt.numpy(), want[0], **LOGIT_TOL)
    for step, tok in enumerate(toks):
        lt, st = api.decode_step(pt, cfg_t, tok, st)
        np.testing.assert_allclose(lt.numpy(), want[step + 1], **LOGIT_TOL,
                                   err_msg=f"{name} decode step {step}")


# ---------------------------------------------------------------------------
# The linear path with the position on the device
# ---------------------------------------------------------------------------

def test_linear_position_is_a_device_scalar():
    cfg_j = jax_configs.get_smoke("qwen2-1.5b")
    cfg_t = configs.get_smoke("qwen2-1.5b")
    pj = jax_api.init_params(cfg_j, jax.random.PRNGKey(0))
    pt = params_from_jax(cfg_t, jax.tree.map(np.asarray, pj), device="cpu")
    prompt = np.random.default_rng(4).integers(
        0, cfg_t.vocab_size, (1, 9)).astype(np.int32)
    want, toks = _jax_run(pj, cfg_j, prompt, 24, 8)
    lt, st = api.prefill(pt, cfg_t, {"tokens": prompt}, max_len=24)
    for c in st:
        assert "slot_pos" not in c
        assert c["pos"].dtype == torch.int32 and c["pos"].dim() == 0
        assert int(c["pos"]) == 9
    np.testing.assert_allclose(lt.numpy(), want[0], **LOGIT_TOL)
    pos_before = [c["pos"] for c in st]
    for step, tok in enumerate(toks):
        lt, st2 = api.decode_step(pt, cfg_t, tok, st)
        assert all(a is b for a, b in zip(st2, st))       # updated in place
        np.testing.assert_allclose(lt.numpy(), want[step + 1], **LOGIT_TOL)
    assert all(c["pos"] is p and int(p) == 17 for c, p in zip(st, pos_before))


# ---------------------------------------------------------------------------
# The decode kernel's arithmetic on its fixed grid
# ---------------------------------------------------------------------------

def _dec(seed, b=2, hq=8, hkv=2, s=128, d=32):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, hq, d)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((b, hkv, s, d)) * 0.5).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    return q, k, v


def _ring(s, pos):
    written = np.arange(max(0, pos - s + 1), pos + 1)
    kv_pos = np.full(s, -1, np.int32)
    kv_pos[written % s] = written
    return kv_pos


@pytest.mark.parametrize("pos,window,ring", [
    (0, None, False), (15, None, False), (16, None, False),
    (64, None, False), (127, None, False), (100, 30, False),
    (40, None, True), (200, None, True), (300, 70, True),
])
def test_split_ref_on_the_fixed_grid_matches_the_jax_kernel(pos, window,
                                                            ring):
    s, bkv = 128, 16
    q, k, v = _dec(41, s=s)
    kv_pos = _ring(s, pos) if ring else None
    sp = fd.decode_splits(2, 2, s, bkv, pos, not ring, window)
    assert sp.splits == fd.split_count(4, cdiv(s, bkv)) == 8
    if not ring and pos < 16:
        assert sp.n_blk == 1          # seven of the eight splits are empty
    kw = dict(pos=pos, window=window)
    want = np.asarray(pallas_decode(
        *map(jnp.asarray, (q, k, v)), bkv=32, interpret=True,
        kv_pos=None if kv_pos is None else jnp.asarray(kv_pos), **kw))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tkv = None if kv_pos is None else torch.from_numpy(kv_pos)
    for p in (pos, torch.tensor(pos, dtype=torch.int32)):
        kw["pos"] = p
        out = fd.flash_decode_split_ref(tq, tk, tv, kv_pos=tkv, bkv=bkv, **kw)
        np.testing.assert_allclose(out.numpy(), want, **LAYER_TOL)
        # The wrapper takes the device position too (here its plain path).
        out = fd.flash_decode(tq, tk, tv, kv_pos=tkv, bkv=bkv, **kw)
        np.testing.assert_allclose(out.numpy(), want, **LAYER_TOL)
