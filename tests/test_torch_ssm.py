"""The port's Mamba-2 block and the mamba2 smoke model against the JAX
reference, on the CPU.

Parameters come from the reference's initialisers and reach the port
through numpy (``models/convert.py:params_from_jax``); inputs and states are
numpy-seeded. The port's block runs its scan through the SSD wrapper, whose
CPU path is the plain chunked scan (chunk 64 by default, the kernel's; a
ragged last chunk is allowed), and with ``impl="reference"`` the plain
``ssd_chunked_ref`` / ``ssd_ref``; the reference's block runs its jnp
references (chunk 128). Tolerances, float32: 1e-5 on a block and its new
state (the two chunkings sum in another order), 1e-4 on logits (through
every layer). The reference's chunked form refuses a prompt its chunk does
not divide (a 200-token prompt at chunk 128); the port serves one, and is
held there against the reference's prefill of the first 128 tokens and its
decode path for the other 72, which takes any length.

A serving slot keeps its state tensors for its whole life: every prefill
zeroes them and every step writes into them (``copy_``), which the last
tests pin — the addresses, and a second request on a used slot serving
what a fresh slot serves.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import rglru as jax_rglru  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import H100_SXM  # noqa: E402
from repro_torch.core.tiling import TileShape  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models import api, rglru, ssm, transformer  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

ARCH = "mamba2-2.7b"
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
    pj = jax_layers.init_tree(jax_ssm.ssm_defs(cfg_j), jax.random.PRNGKey(4),
                              jnp.float32)
    return cfg_j, cfg_t, pj, _to_torch(_np_tree(pj))


@pytest.fixture(scope="module")
def model():
    cfg_j, cfg_t = jax_configs.get_smoke(ARCH), configs.get_smoke(ARCH)
    pj = jax_api.init_params(cfg_j, jax.random.PRNGKey(0))
    pt = params_from_jax(cfg_t, _np_tree(pj), device="cpu")
    return cfg_j, cfg_t, pj, pt


def _random_state(cfg, seed):
    """A carried state of the smoke block, numpy-seeded (as a decode or a
    continued prefill would find it)."""
    rng = np.random.default_rng(seed)
    shapes = {k: tuple(v.shape) for k, v in
              ssm.make_ssm_state(cfg, 1, torch.float32, device="cpu").items()}
    return {k: (rng.standard_normal(s) * 0.5).astype(np.float32)
            for k, s in shapes.items()}


def _x(cfg, s, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((1, s, cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------------------
# The block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", LENGTHS)
@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv_matches_reference(s, with_tail):
    rng = np.random.default_rng(s)
    f, w = 24, 4
    x = rng.standard_normal((2, s, f)).astype(np.float32)
    wt = rng.standard_normal((w, f)).astype(np.float32)
    b = rng.standard_normal(f).astype(np.float32)
    tail = (rng.standard_normal((2, w - 1, f)).astype(np.float32)
            if with_tail else None)
    yj, tj = jax_rglru._causal_conv(jnp.asarray(x), jnp.asarray(wt),
                                    jnp.asarray(b),
                                    None if tail is None else jnp.asarray(tail))
    yt, tt = rglru._causal_conv(torch.from_numpy(x), torch.from_numpy(wt),
                                torch.from_numpy(b),
                                None if tail is None else torch.from_numpy(tail))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **LAYER_TOL)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), **LAYER_TOL)


@pytest.mark.parametrize("impl", ["auto", "reference"])
@pytest.mark.parametrize("s", LENGTHS)
@pytest.mark.parametrize("with_state", [False, True])
def test_ssm_forward_matches_reference(block, impl, s, with_state):
    cfg_j, cfg_t, pj, pt = block
    x = _x(cfg_t, s, seed=s)
    st = _random_state(cfg_t, seed=s + 1) if with_state else None
    yj, nj = jax_ssm.ssm_forward(
        pj, cfg_j, jnp.asarray(x),
        state=None if st is None else {k: jnp.asarray(v) for k, v in st.items()})
    state_t = None if st is None else _to_torch(st)
    yt, nt = ssm.ssm_forward(pt, cfg_t, torch.from_numpy(x), state=state_t,
                             impl=impl)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **LAYER_TOL)
    if st is None:
        assert nt is None and nj is None
        return
    assert nt is state_t                      # written in place
    assert set(nt) == set(nj) == {"conv_x", "conv_B", "conv_C", "h"}
    for k in nj:
        np.testing.assert_allclose(nt[k].numpy(), np.asarray(nj[k]),
                                   **LAYER_TOL, err_msg=k)


@pytest.mark.parametrize("chunk", [48, 128, 256])
def test_ssm_forward_takes_the_tiles_chunk(block, monkeypatch, chunk):
    """A resolved SSD tile's chunk reaches the scan; on the CPU a chunk
    that does not divide S is taken as it is (the kernel's ragged last
    chunk). Against the reference at its chunk 128 the block agrees within
    the SSD scan suites' 3e-4 (``test_torch_scans.py``: two chunkings of
    the dual form sum in another order; 48 and 256 miss 1e-5 by one
    element of 16,384 here)."""
    cfg_j, cfg_t, pj, pt = block
    seen = []
    real = ssm.ssd

    def spy(*args, chunk=None, **kw):
        seen.append(chunk)
        return real(*args, chunk=chunk, **kw)

    monkeypatch.setattr(ssm, "ssd", spy)
    x = _x(cfg_t, 256, seed=7)
    yj, _ = jax_ssm.ssm_forward(pj, cfg_j, jnp.asarray(x))
    yt, _ = ssm.ssm_forward(pt, cfg_t, torch.from_numpy(x), chunk=chunk)
    assert seen == [chunk]
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=3e-4,
                               atol=3e-4)


def test_make_ssm_state_is_the_references(block):
    cfg_j, cfg_t, _, _ = block
    want = jax_ssm.make_ssm_state(cfg_j, 2, jnp.float32)
    got = ssm.make_ssm_state(cfg_t, 2, torch.float32, device="cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert all(float(v.abs().max()) == 0.0 for v in got.values())


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def test_converted_params_have_the_ports_layout(model):
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
    assert all(set(lp) == {"norm1_w", "ssm"} for lp in pt["layers"])


def test_full_width_geometry_and_tiles():
    cfg = configs.get_arch(ARCH)
    s = cfg.ssm
    assert (cfg.n_layers, cfg.d_model, s.n_heads(cfg.d_model), s.head_dim,
            s.d_state) == (64, 2560, 80, 64, 128)
    tiles, _ = specs.resolve_model_tiles(None, cfg, 1, 600, "prefill",
                                         "float32", H100_SXM)
    assert tiles["ssd"] == TileShape((64,))
    tiles, _ = specs.resolve_model_tiles(None, cfg, 4, 1024, "decode",
                                         "float32", H100_SXM)
    assert tiles["ssd"] == TileShape((1,))


def _serve_other_request(pt, cfg, caches):
    """Use ``caches`` for another request: a prefill and a few steps."""
    other = np.random.default_rng(9).integers(0, cfg.vocab_size, (1, 21))
    logits, _ = api.prefill(pt, cfg, {"tokens": other}, max_len=64,
                            caches=caches)
    for _ in range(3):
        tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1, keepdim=True)
        logits, _ = api.decode_step(pt, cfg, tok, caches)


@pytest.mark.parametrize("reuse", [False, True], ids=["fresh", "reused"])
def test_prefill_and_8_decode_steps_match_reference(model, reuse):
    cfg_j, cfg_t, pj, pt = model
    prompt = np.random.default_rng(3).integers(0, cfg_t.vocab_size,
                                               (1, 13)).astype(np.int32)
    caches = None
    if reuse:
        caches = api.make_serve_state(cfg_t, 1, 64, torch.float32,
                                      device="cpu")
        _serve_other_request(pt, cfg_t, caches)
    lj, sj = jax_api.prefill(pj, cfg_j, {"tokens": jnp.asarray(prompt)},
                             max_len=64)
    lt, st = api.prefill(pt, cfg_t, {"tokens": prompt}, max_len=64,
                         caches=caches)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    for step in range(8):
        tok = np.asarray(jnp.argmax(lj[:, :cfg_j.vocab_size], axis=-1),
                         np.int32)[:, None]
        lj, sj = jax_api.decode_step(pj, cfg_j, jnp.asarray(tok), sj)
        lt, st = api.decode_step(pt, cfg_t, tok, st)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL,
                                   err_msg=f"decode step {step}")
    # The carried states, layer by layer: the reference scans the three
    # SSD layers as one segment, their states stacked on a leading axis.
    ((stacked,),) = sj
    for li, got in enumerate(st):
        for k, v in got.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(stacked[k])[li],
                                       **LOGIT_TOL, err_msg=f"layer {li} {k}")


def test_a_200_token_prompt_matches_prefill_128_then_72_decode_steps(model):
    """The reference's chunked form refuses S = 200 at chunk 128; its
    prefill of 128 tokens and 72 decode steps give the same function."""
    cfg_j, cfg_t, pj, pt = model
    prompt = np.random.default_rng(11).integers(0, cfg_t.vocab_size,
                                                (1, 200)).astype(np.int32)
    with pytest.raises(ValueError, match="not divisible"):
        jax_api.prefill(pj, cfg_j, {"tokens": jnp.asarray(prompt)},
                        max_len=256)
    lj, sj = jax_api.prefill(pj, cfg_j, {"tokens": jnp.asarray(prompt[:, :128])},
                             max_len=256)
    for t in range(128, 200):
        lj, sj = jax_api.decode_step(pj, cfg_j, jnp.asarray(prompt[:, t:t + 1]),
                                     sj)
    for impl in ("auto", "reference"):
        lt, _ = api.prefill(pt, cfg_t, {"tokens": prompt}, max_len=256,
                            impl=impl)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL,
                                   err_msg=impl)


# ---------------------------------------------------------------------------
# A serving slot's state
# ---------------------------------------------------------------------------

def _ptrs(caches):
    return [{k: t.data_ptr() for k, t in c.items()} for c in caches]


def test_slot_state_keeps_its_tensors_across_requests(model):
    """Prefill, decode and a second request write into the slot's own
    tensors: a captured decode step on the card holds their addresses."""
    _, cfg, _, pt = model
    eng = ServeEngine(cfg, pt, max_len=64, slots=1, device="cpu")
    caches = eng._slots[0].caches
    before = _ptrs(caches)
    tensors = [dict(c) for c in caches]
    for seed in (0, 1):
        prompt = np.random.default_rng(seed).integers(2, cfg.vocab_size, 17)
        eng.add_request(prompt, max_new_tokens=5)
        eng.run_until_done()
        assert _ptrs(caches) == before
        assert all(c[k] is t[k] for c, t in zip(caches, tensors) for k in c)
    assert float(caches[0]["h"].abs().max()) > 0.0    # the state was written


def test_a_used_slot_serves_what_a_fresh_one_serves(model):
    """A prefill starts from a zeroed state: the second request on a slot
    gets the tokens it gets on a fresh engine."""
    _, cfg, _, pt = model
    rng = np.random.default_rng(5)
    first, second = (rng.integers(2, cfg.vocab_size, n) for n in (23, 9))
    used = ServeEngine(cfg, pt, max_len=64, slots=1, device="cpu")
    used.add_request(first, max_new_tokens=6)
    used.run_until_done()
    used.add_request(second, max_new_tokens=6)
    got = used.run_until_done()[0].out_tokens
    fresh = ServeEngine(cfg, pt, max_len=64, slots=1, device="cpu")
    fresh.add_request(second, max_new_tokens=6)
    assert got == fresh.run_until_done()[0].out_tokens
    # The zeroing is what makes it so: the stack run on the first
    # request's state, without the prefill's reset, gives other logits.
    caches = used._slots[0].caches
    api.prefill(pt, cfg, {"tokens": first[None]}, max_len=64, caches=caches)
    stale = transformer.forward(pt, cfg, torch.as_tensor(second[None]),
                                caches=caches,
                                logits_mode="last").logits[:, -1]
    reset = api.prefill(pt, cfg, {"tokens": second[None]}, max_len=64,
                        caches=caches)[0]
    assert not torch.allclose(stale, reset, **LOGIT_TOL)
