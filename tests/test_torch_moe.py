"""The port's MoE block and MoE models against the JAX package, on the CPU.

Mirrors ``tests/test_moe.py`` on the port's ``moe_apply_local``: gather
dispatch against the dense all-experts product (2e-4, as that file holds
it), with renormalised gates and without; two half-expert shards summing to
the whole; capacity drops at ``capacity_factor`` 0.1 on the same rows as the
reference's; the shared experts always on; the aux loss; gradients reaching
the router and ``w1``. Each is also held against the JAX ``moe_apply_local``
on the same inputs and weights (1e-5, float32 sums in another order).

Then one MoE ``layer_forward`` and the deepseek-moe-16b and
qwen3-moe-235b-a22b smoke models against the reference: prefill logits and
three decode steps, a chunked prefill through ``prefill_chunk`` and a
packed step through ``prefill_packed``, at a capacity factor low enough
that experts drop tokens, so the capacity must be counted over the chunk
and over the pack, as the reference counts it. Inputs come from a numpy
seed (continuous values, so no router probabilities tie); parameters from
the reference's ``init_tree`` / ``init_params`` through numpy.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.configs.base import ArchConfig as JaxArch  # noqa: E402
from repro.configs.base import LayerSpec as JaxSpec  # noqa: E402
from repro.configs.base import MoEConfig as JaxMoE  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models import transformer as jax_T  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import ArchConfig, LayerSpec, MoEConfig  # noqa: E402
from repro_torch.models import api, moe, transformer  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

DENSE_TOL = dict(rtol=2e-4, atol=2e-4)
REF_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
MOE_ARCHS = ["deepseek-moe-16b", "qwen3-moe-235b-a22b"]


def _cfgs(n_experts=8, top_k=2, cf=32.0, renorm=True, shared=0):
    kw = dict(name="moe_test", family="moe", n_layers=1, d_model=32,
              n_heads=4, n_kv_heads=4, d_ff=0, vocab_size=64)
    mkw = dict(n_experts=n_experts, top_k=top_k, d_expert=16,
               capacity_factor=cf, renorm_gates=renorm,
               n_shared_experts=shared, d_shared=32 * shared)
    cfg_j = JaxArch(layer_pattern=(JaxSpec("attn", "moe"),),
                    moe=JaxMoE(**mkw), **kw).validate()
    cfg_t = ArchConfig(layer_pattern=(LayerSpec("attn", "moe"),),
                       moe=MoEConfig(**mkw), **kw).validate()
    return cfg_j, cfg_t


def _params(cfg_j, key=0):
    pj = jax_layers.init_tree(jax_moe.moe_defs(cfg_j), jax.random.PRNGKey(key),
                              jnp.float32)
    pt = {k: torch.from_numpy(np.array(v)) for k, v in pj.items()}
    return pj, pt


def _x(t, seed, d=32):
    return np.random.default_rng(seed).standard_normal((t, d)).astype(
        np.float32)


def _dense_reference(p, cfg, x2d):
    """Every expert on every token (no dispatch), the k chosen summed."""
    m = cfg.moe
    probs = torch.softmax(x2d @ p["router"], dim=-1)
    gates, eidx = torch.topk(probs, m.top_k, dim=-1)
    if m.renorm_gates:
        gates = gates / gates.sum(-1, keepdim=True)
    h = torch.nn.functional.silu(torch.einsum("td,edf->tef", x2d, p["w1"]))
    h = h * torch.einsum("td,edf->tef", x2d, p["w3"])
    out_all = torch.einsum("tef,efd->ted", h, p["w2"])        # [T, E, D]
    sel = torch.gather(out_all, 1, eidx[..., None].expand(-1, -1, x2d.shape[1]))
    return (gates[..., None] * sel).sum(1)


_apply_j = jax.jit(jax_moe.moe_apply_local, static_argnums=(1, 3, 4))


def _both(cfg_j, cfg_t, pj, pt, x, n_local=None, lo=0):
    n = cfg_t.moe.n_experts if n_local is None else n_local
    yj, auxj = _apply_j(pj, cfg_j, jnp.asarray(x), n, lo)
    yt, auxt = moe.moe_apply_local(pt, cfg_t, torch.from_numpy(x), n, lo)
    return (yt, auxt), (np.asarray(yj), float(auxj))


@pytest.mark.parametrize("renorm", [True, False])
def test_dispatch_matches_dense_and_reference(renorm):
    cfg_j, cfg_t = _cfgs(renorm=renorm)
    pj, pt = _params(cfg_j)
    x = _x(24, 1)
    (yt, auxt), (yj, auxj) = _both(cfg_j, cfg_t, pj, pt, x)
    ref = _dense_reference(pt, cfg_t, torch.from_numpy(x))
    np.testing.assert_allclose(yt.numpy(), ref.numpy(), **DENSE_TOL)
    np.testing.assert_allclose(yt.numpy(), yj, **REF_TOL)
    assert float(auxt) > 0


def test_offset_partition_sums_to_full():
    """Two half-expert shards' partial outputs sum to the full result, and
    each shard is the reference's shard."""
    cfg_j, cfg_t = _cfgs()
    pj, pt = _params(cfg_j, key=2)
    x = _x(16, 3)
    full, _ = moe.moe_apply_local(pt, cfg_t, torch.from_numpy(x), 8, 0)

    def shard(lo, n):
        sj = dict(pj, **{k: pj[k][lo:lo + n] for k in ("w1", "w3", "w2")})
        st = dict(pt, **{k: pt[k][lo:lo + n] for k in ("w1", "w3", "w2")})
        (yt, _), (yj, _) = _both(cfg_j, cfg_t, sj, st, x, n, lo)
        np.testing.assert_allclose(yt.numpy(), yj, **REF_TOL)
        return yt

    np.testing.assert_allclose((shard(0, 4) + shard(4, 4)).numpy(),
                               full.numpy(), **DENSE_TOL)


def test_capacity_drops_the_reference_rows():
    """At capacity factor 0.1 experts drop pairs: the port drops the same
    (token, k) pairs as the reference, so every row, a wholly dropped one
    (zero) or a partly dropped one, equals the reference's."""
    cfg_lo_j, cfg_lo_t = _cfgs(cf=0.1)
    cfg_hi_j, cfg_hi_t = _cfgs(cf=64.0)
    pj, pt = _params(cfg_lo_j, key=4)
    x = _x(256, 5)
    assert moe._capacity(256, cfg_lo_t) == jax_moe._capacity(256, cfg_lo_j)
    assert moe._capacity(256, cfg_lo_t) < moe._capacity(256, cfg_hi_t)
    (y_lo, _), (yj_lo, _) = _both(cfg_lo_j, cfg_lo_t, pj, pt, x)
    (y_hi, _), _ = _both(cfg_hi_j, cfg_hi_t, pj, pt, x)
    np.testing.assert_allclose(y_lo.numpy(), yj_lo, **REF_TOL)
    lo_norm = np.linalg.norm(y_lo.numpy(), axis=-1)
    hi_norm = np.linalg.norm(y_hi.numpy(), axis=-1)
    zero_t = lo_norm < 1e-9
    assert zero_t.sum() > (hi_norm < 1e-9).sum()
    np.testing.assert_array_equal(zero_t,
                                  np.linalg.norm(yj_lo, axis=-1) < 1e-9)
    # The kept pairs: per token, how many of its k contributions survived.
    cap = moe._capacity(256, cfg_lo_t)
    _, _, eidx = moe._route(pt, cfg_lo_t, torch.from_numpy(x))
    _, _, _, _, kept = moe.dispatch(eidx, 8, 0, cap)
    per_expert = torch.zeros(8, dtype=torch.long).scatter_add_(
        0, eidx.reshape(-1)[kept], torch.ones(int(kept.sum()),
                                              dtype=torch.long))
    assert int(per_expert.max()) <= cap
    assert 0 < int(kept.sum()) < kept.numel()


def test_dispatch_keeps_the_first_pairs_of_each_group():
    """The stable sort: within an expert's group the pairs keep token
    order, and the first C of them fill the slots."""
    eidx = torch.tensor([[1, 0], [1, 2], [0, 1], [1, 0], [1, 2]])
    pair, valid, expert, slot, kept = moe.dispatch(eidx, 3, 0, cap=2)
    # Pairs (token, k) flattened: experts 1 0 1 2 0 1 1 0 1 2. Expert 0
    # holds pairs 1, 4, 7, expert 1 pairs 0, 2, 5, 6, 8, expert 2 pairs 3,
    # 9, each in pair order; the first two of each are kept.
    assert pair.tolist() == [[1, 4], [0, 2], [3, 9]]
    assert valid.all()
    assert slot.tolist() == [0, 0, 1, 0, 1, 2, 3, 2, 4, 1]
    assert kept.tolist() == [True, True, True, True, True, False, False,
                             False, False, True]
    assert expert.tolist() == eidx.reshape(-1).tolist()


def test_shared_experts_always_active():
    cfg_j, cfg_t = _cfgs(shared=2)
    pj, pt = _params(cfg_j, key=6)
    x = np.zeros((1, 4, 32), np.float32)
    x[0, 0, 0] = 1.0
    y, _ = moe.moe_forward(pt, cfg_t, torch.from_numpy(x))
    assert float(y[0, 0].abs().sum()) > 0
    xr = np.random.default_rng(7).standard_normal((1, 6, 32)).astype(
        np.float32)
    yt, auxt = moe.moe_forward(pt, cfg_t, torch.from_numpy(xr))
    yj, auxj = jax_moe.moe_forward(pj, cfg_j, jnp.asarray(xr), None)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **REF_TOL)
    np.testing.assert_allclose(float(auxt), float(auxj), **REF_TOL)


@pytest.mark.parametrize("renorm,k", [(True, 2), (False, 3)])
def test_aux_equals_reference(renorm, k):
    cfg_j, cfg_t = _cfgs(renorm=renorm, top_k=k)
    pj, pt = _params(cfg_j, key=9)
    (_, auxt), (_, auxj) = _both(cfg_j, cfg_t, pj, pt, _x(40, 10))
    assert auxt.dtype == torch.float32
    np.testing.assert_allclose(float(auxt), auxj, **REF_TOL)


def test_gradients_flow_to_router():
    cfg_j, cfg_t = _cfgs()
    _, pt = _params(cfg_j, key=7)
    pt = {k: v.requires_grad_(True) for k, v in pt.items()}
    x = torch.from_numpy(_x(16, 8))
    y, aux = moe.moe_apply_local(pt, cfg_t, x, 8, 0)
    (torch.sum(y ** 2) + aux).backward()
    assert float(pt["router"].grad.abs().sum()) > 0
    assert float(pt["w1"].grad.abs().sum()) > 0


# ---------------------------------------------------------------------------
# A layer and the smoke models
# ---------------------------------------------------------------------------

def _low_capacity(cfg, cf):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


@pytest.fixture(scope="module", params=MOE_ARCHS)
def model(request):
    cfg_j = jax_configs.get_smoke(request.param)
    cfg_t = configs.get_smoke(request.param)
    pj = jax.jit(jax_api.init_params, static_argnums=0)(
        cfg_j, jax.random.PRNGKey(0))
    pt = params_from_jax(cfg_t, jax.tree.map(np.asarray, pj), device="cpu")
    return cfg_j, cfg_t, pj, pt


def _jax_layer(cfg, tree, li):
    """Layer ``li``'s parameters out of the reference's segment-stacked
    tree (``transformer.decompose``)."""
    n = 0
    for seg, group in zip(jax_T.decompose(cfg), tree["segments"]):
        reps = 1 if seg[0] == "seq" else seg[2]
        units = group if seg[0] == "seq" else [
            jax.tree.map(lambda a, r=r: a[r], lp)
            for r in range(reps) for lp in group]
        if li < n + len(units):
            return units[li - n]
        n += len(units)
    raise IndexError(li)


def test_moe_layer_forward_matches_reference(model):
    cfg_j, cfg_t, pj, pt = model
    li = next(i for i, s in enumerate(cfg_t.layers()) if s.ff == "moe")
    x = np.random.default_rng(11).standard_normal(
        (2, 9, cfg_t.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9), (2, 9))
    yj, _, auxj = jax_T.layer_forward(_jax_layer(cfg_j, pj, li), cfg_j,
                                      cfg_j.layers()[li], jnp.asarray(x),
                                      jnp.asarray(pos), None, None)
    yt, _, auxt = transformer.layer_forward(
        pt["layers"][li], cfg_t, cfg_t.layers()[li], torch.from_numpy(x),
        torch.from_numpy(np.ascontiguousarray(pos)), None)
    # 1e-5 of the layer's scale: the residual stream reaches |y| ~ 80.
    yj = np.asarray(yj)
    np.testing.assert_allclose(yt.numpy(), yj, rtol=1e-5,
                               atol=1e-5 * float(np.abs(yj).max()))
    np.testing.assert_allclose(float(auxt), float(auxj), **REF_TOL)


def test_moe_model_prefill_and_decode_match_reference(model):
    cfg_j, cfg_t, pj, pt = model
    toks = np.random.default_rng(12).integers(
        2, cfg_t.vocab_size, size=(2, 11)).astype(np.int32)
    lj, sj = jax_api.prefill(pj, cfg_j, {"tokens": jnp.asarray(toks)},
                             max_len=16)
    lt, st = api.prefill(pt, cfg_t, {"tokens": toks}, max_len=16)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    tok = np.argmax(np.asarray(lj)[:, :cfg_t.vocab_size], -1)[:, None]
    decode_j = jax.jit(jax_api.decode_step, static_argnums=1)
    for step in range(3):
        lj, sj = decode_j(pj, cfg_j, jnp.asarray(tok, jnp.int32), sj)
        lt, st = api.decode_step(pt, cfg_t, torch.from_numpy(tok), st)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL,
                                   err_msg=f"decode step {step}")
        tok = np.argmax(np.asarray(lj)[:, :cfg_t.vocab_size], -1)[:, None]


# Capacity factor 0.5: with 8 experts top-2 a 46-token pack fills 8-pair
# groups and drops, while its 14-16-token segments alone drop little.
LOW_CF = 0.5


def test_moe_chunked_prefill_counts_the_chunk(model):
    cfg_j, cfg_t, pj, pt = model
    cfg_j, cfg_t = _low_capacity(cfg_j, LOW_CF), _low_capacity(cfg_t, LOW_CF)
    s, chunk = 32, 16
    toks = np.random.default_rng(13).integers(
        2, cfg_t.vocab_size, size=(1, s)).astype(np.int32)
    sj = jax_api.make_serve_state(cfg_j, 1, s + 8, jnp.float32)
    st = api.make_serve_state(cfg_t, 1, s + 8, torch.float32, device="cpu")
    for start in range(0, s, chunk):
        c = toks[:, start:start + chunk]
        lj, sj = jax_api.prefill_chunk(pj, cfg_j, jnp.asarray(c), sj, start)
        lt, st = api.prefill_chunk(pt, cfg_t, c, st, start)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL,
                                   err_msg=f"chunk at {start}")
    # Chunking changes what drops: the whole prompt's logits differ.
    whole, _ = api.prefill(pt, cfg_t, {"tokens": toks}, max_len=s + 8)
    assert not np.allclose(whole.numpy(), lt.numpy(), **LOGIT_TOL)


def test_moe_packed_step_counts_the_pack(model):
    cfg_j, cfg_t, pj, pt = model
    cfg_j, cfg_t = _low_capacity(cfg_j, LOW_CF), _low_capacity(cfg_t, LOW_CF)
    rng = np.random.default_rng(14)
    prompts = [rng.integers(2, cfg_t.vocab_size, size=n).astype(np.int32)
               for n in (20, 16, 14)]
    done = (4, 0, 0)
    layout = tuple((d, len(p) - d) for d, p in zip(done, prompts))
    toks = np.concatenate([p[d:] for d, p in zip(done, prompts)])[None]
    sts, sjs = [], []
    for d, p in zip(done, prompts):
        st = api.make_serve_state(cfg_t, 1, 24, torch.float32, device="cpu")
        sj = jax_api.make_serve_state(cfg_j, 1, 24, jnp.float32)
        if d:
            api.prefill_chunk(pt, cfg_t, p[None, :d], st, 0)
            _, sj = jax_api.prefill_chunk(pj, cfg_j, jnp.asarray(p[None, :d]),
                                          sj, 0)
        sts.append(st)
        sjs.append(sj)
    lt, _ = api.prefill_packed(pt, cfg_t, toks, sts, layout)
    lj, _ = jax_api.prefill_packed(pj, cfg_j, jnp.asarray(toks), tuple(sjs),
                                   layout)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    # Per-segment chunks route each segment alone: other capacities.
    alone = []
    for i, ((start, _), p) in enumerate(zip(layout, prompts)):
        st = api.make_serve_state(cfg_t, 1, 24, torch.float32, device="cpu")
        if start:
            api.prefill_chunk(pt, cfg_t, p[None, :start], st, 0)
        alone.append(api.prefill_chunk(pt, cfg_t, p[None, start:], st,
                                       start)[0][0].numpy())
    assert not np.allclose(np.stack(alone), lt.numpy(), **LOGIT_TOL)
