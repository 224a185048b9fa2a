"""The port's encoder-decoder and vision models against the JAX package, on
the CPU.

* whisper-large-v3 smoke (heads padded 4 -> 16, the padded heads masked):
  ``encode``, ``api.prefill`` with ``frames`` and three ``api.decode_step``
  logits, and the serve state after prefill (each decoder layer's self K/V
  ``[B, H, max_len, hd]``, its cross K/V ``[B, H, S_enc, hd]`` and ``pos``)
  against the reference's, tensor by tensor.
* internvl2-1b smoke: ``api.prefill`` with ``patch_embeds`` (projected by
  ``vit_proj`` and prepended) and three decode steps.
* ``params_from_jax`` unstacks an encoder-decoder tree (``enc_layers``,
  ``dec_layers``) and carries the decoder-only ``moe`` and ``vit_proj``
  dicts across as they are.
* The chunked, packed and paged entry points refuse whisper with the
  reference's messages and take internvl2's text as the reference does.

Tolerances (float32, each side summing in its own order): 1e-4 on logits,
1e-5 relative to the tensor's scale on the encoder output, 1e-4 on the
states projected from it or from the decoder's residual stream. Inputs
come from a numpy seed; parameters from the reference's ``init_params``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.models import encdec as jax_E  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import api, encdec  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
STATE_TOL = 1e-4


def _close(got, want, msg="", tol=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())),
                               err_msg=msg)


def _pair(name):
    cfg_j = jax_configs.get_smoke(name)
    cfg_t = configs.get_smoke(name)
    pj = jax.jit(jax_api.init_params, static_argnums=0)(
        cfg_j, jax.random.PRNGKey(0))
    pt = params_from_jax(cfg_t, jax.tree.map(np.asarray, pj), device="cpu")
    return cfg_j, cfg_t, pj, pt


@pytest.fixture(scope="module")
def whisper():
    return _pair("whisper-large-v3")


@pytest.fixture(scope="module")
def internvl():
    return _pair("internvl2-1b")


def _decode_both(cfg_j, cfg_t, pj, pt, lj, sj, st, steps=3):
    decode_j = jax.jit(jax_api.decode_step, static_argnums=1)
    tok = np.argmax(np.asarray(lj)[:, :cfg_t.vocab_size], -1)[:, None]
    for step in range(steps):
        lj, sj = decode_j(pj, cfg_j, jnp.asarray(tok, jnp.int32), sj)
        lt, st = api.decode_step(pt, cfg_t, torch.from_numpy(tok), st)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL,
                                   err_msg=f"decode step {step}")
        tok = np.argmax(np.asarray(lj)[:, :cfg_t.vocab_size], -1)[:, None]
    return sj, st


def test_whisper_params_from_jax(whisper):
    cfg_j, cfg_t, pj, pt = whisper
    assert api.is_encdec(cfg_t) and not api.is_vlm(cfg_t)
    assert len(pt["enc_layers"]) == cfg_t.encoder.n_layers
    assert len(pt["dec_layers"]) == cfg_t.n_layers
    want = encdec.model_defs(cfg_t)
    for li, (lp, defs) in enumerate(zip(pt["dec_layers"], want["dec_layers"])):
        assert sorted(lp) == sorted(defs)
        assert tuple(lp["cross_attn"]["wk"].shape) == \
            defs["cross_attn"]["wk"].shape
        np.testing.assert_array_equal(
            lp["cross_attn"]["wk"].numpy(),
            np.asarray(pj["dec_layers"]["cross_attn"]["wk"][li]))
    np.testing.assert_array_equal(pt["enc_final_w"].numpy(),
                                  np.asarray(pj["enc_final_w"]))


@pytest.mark.parametrize("name,key", [("deepseek-moe-16b", "moe"),
                                      ("internvl2-1b", "vit_proj")])
def test_decoder_walk_carries_moe_and_vit_proj(name, key):
    cfg_j, cfg_t, pj, pt = _pair(name)
    if key == "vit_proj":
        got, want = pt["vit_proj"], pj["vit_proj"]
    else:
        got = pt["layers"][1]["moe"]   # layer 1: the first of the scan
        want = jax.tree.map(lambda a: a[0], pj["segments"][1][0]["moe"])
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_whisper_encode_prefill_decode_match_reference(whisper):
    cfg_j, cfg_t, pj, pt = whisper
    rng = np.random.default_rng(0)
    b, s, max_len = 2, 7, 16
    frames = rng.standard_normal(
        (b, cfg_t.encoder.seq_len, cfg_t.d_model)).astype(np.float32)
    toks = rng.integers(2, cfg_t.vocab_size, size=(b, s)).astype(np.int32)

    enc_j = jax_E.encode(pj, cfg_j, jnp.asarray(frames))
    enc_t = encdec.encode(pt, cfg_t, torch.from_numpy(frames))
    _close(enc_t, enc_j, "encoder output")

    batch = {"tokens": toks, "frames": frames}
    lj, sj = jax_api.prefill(pj, cfg_j, {k: jnp.asarray(v)
                                         for k, v in batch.items()},
                             max_len=max_len)
    lt, st = api.prefill(pt, cfg_t, batch, max_len=max_len)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    h, hd = cfg_t.padded_heads, cfg_t.head_dim_
    assert int(st["pos"]) == int(sj["pos"]) == s
    assert st["pos"].dtype == torch.int32 and st["pos"].dim() == 0
    for li in range(cfg_t.n_layers):
        for key in ("self_k", "self_v"):
            assert tuple(st[key][li].shape) == (b, h, max_len, hd)
            _close(st[key][li], np.asarray(sj[key])[li], f"{key} {li}",
                   STATE_TOL)
        for i, t in enumerate(st["cross"][li]):
            assert tuple(t.shape) == (b, h, cfg_t.encoder.seq_len, hd)
            _close(t, np.asarray(sj["cross"][i])[li], f"cross {i} {li}",
                   STATE_TOL)
    # The serve state made beside the prefill is the reference's too.
    made = api.make_serve_state(cfg_t, b, max_len, torch.float32,
                                enc_out=enc_t, params=pt)
    assert int(made["pos"]) == 0 and not made["self_k"][0].any()
    _close(made["cross"][0][0], np.asarray(sj["cross"][0])[0], tol=STATE_TOL)
    sj, st = _decode_both(cfg_j, cfg_t, pj, pt, lj, sj, st)
    assert int(st["pos"]) == s + 3
    _close(st["self_k"][0], np.asarray(sj["self_k"])[0], "self_k after decode",
           STATE_TOL)


def test_internvl_prefill_with_patches_and_decode_match_reference(internvl):
    cfg_j, cfg_t, pj, pt = internvl
    assert api.is_vlm(cfg_t) and not api.is_encdec(cfg_t)
    rng = np.random.default_rng(1)
    b, s, p = 2, 6, cfg_t.encoder.seq_len
    patches = rng.standard_normal((b, p, 1024)).astype(np.float32)
    toks = rng.integers(2, cfg_t.vocab_size, size=(b, s)).astype(np.int32)
    max_len = p + s + 4
    lj, sj = jax_api.prefill(pj, cfg_j, {"tokens": jnp.asarray(toks),
                                         "patch_embeds": jnp.asarray(patches)},
                             max_len=max_len)
    lt, st = api.prefill(pt, cfg_t, {"tokens": toks, "patch_embeds": patches},
                         max_len=max_len)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    assert all(int(c["pos"]) == p + s for c in st)
    # Without patches the text alone is another sequence.
    text, _ = api.prefill(pt, cfg_t, {"tokens": toks}, max_len=max_len)
    assert not np.allclose(text.numpy(), lt.numpy(), **LOGIT_TOL)
    _decode_both(cfg_j, cfg_t, pj, pt, lj, sj, st)


# The reference's refusals (``repro/models/api.py``), message by message.
REFUSALS = {
    "prefill_chunk": "chunked prefill is not supported for encoder-decoder "
                     "models",
    "prefill_packed": "packed prefill is not supported for encoder-decoder "
                      "models",
    "make_paged_pool": "paged KV pool is not supported for encoder-decoder "
                       "models",
    "make_paged_state": "paged KV pool is not supported for encoder-decoder "
                        "models",
    "decode_step_paged": "paged decode is not supported for encoder-decoder "
                         "models",
    "prefill_chunk_paged": "chunked prefill is not supported for "
                           "encoder-decoder models",
    "prefill_packed_paged": "packed prefill is not supported for "
                            "encoder-decoder models",
}
ARGS = {
    "prefill_chunk": lambda p, t: (p, t, np.zeros((1, 2), np.int32), None, 0),
    "prefill_packed": lambda p, t: (p, t, np.zeros((1, 2), np.int32), (None,),
                                    ((0, 2),)),
    "make_paged_pool": lambda p, t: (t, 4, 8, torch.float32),
    "make_paged_state": lambda p, t: (t, torch.float32),
    "decode_step_paged": lambda p, t: (p, t, np.zeros((1, 1), np.int32), None,
                                       None, None),
    "prefill_chunk_paged": lambda p, t: (p, t, np.zeros((1, 2), np.int32),
                                         None, 0, None, None),
    "prefill_packed_paged": lambda p, t: (p, t, np.zeros((1, 2), np.int32),
                                          (None,), ((0, 2),), None, (None,)),
}


@pytest.mark.parametrize("entry", sorted(REFUSALS))
def test_serving_entries_refuse_encoder_decoder(whisper, entry):
    cfg_j, cfg_t, pj, pt = whisper
    with pytest.raises(NotImplementedError) as port:
        getattr(api, entry)(*ARGS[entry](pt, cfg_t))
    with pytest.raises(NotImplementedError) as ref:
        getattr(jax_api, entry)(*ARGS[entry](pj, cfg_j))
    assert str(port.value) == str(ref.value) == REFUSALS[entry]


def test_serving_entries_take_vision_text(internvl):
    """internvl2's text goes through a chunked prefill, a packed step and
    the paged pool, as in the reference."""
    cfg_j, cfg_t, pj, pt = internvl
    toks = np.random.default_rng(2).integers(
        2, cfg_t.vocab_size, size=(1, 9)).astype(np.int32)
    sj = jax_api.make_serve_state(cfg_j, 1, 16, jnp.float32)
    st = api.make_serve_state(cfg_t, 1, 16, torch.float32, device="cpu")
    for start, end in ((0, 5), (5, 9)):
        lj, sj = jax_api.prefill_chunk(pj, cfg_j, jnp.asarray(
            toks[:, start:end]), sj, start)
        lt, st = api.prefill_chunk(pt, cfg_t, toks[:, start:end], st, start)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    fresh = api.make_serve_state(cfg_t, 1, 16, torch.float32, device="cpu")
    lp, _ = api.prefill_packed(pt, cfg_t, toks, [fresh], ((0, 9),))
    np.testing.assert_allclose(lp.numpy(), lt.numpy(), **LOGIT_TOL)
    pool = api.make_paged_pool(cfg_t, 4, 8, torch.float32, device="cpu")
    state = api.make_paged_state(cfg_t, torch.float32, device="cpu")
    table = torch.tensor([1, 2], dtype=torch.int32)
    lg, _, _ = api.prefill_chunk_paged(pt, cfg_t, toks, state, 0, pool, table)
    np.testing.assert_allclose(lg.numpy(), lt.numpy(), **LOGIT_TOL)
