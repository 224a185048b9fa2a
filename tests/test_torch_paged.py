"""The paged KV pool's pieces in the port against the JAX package, on the CPU.

* The plain functions of the pool's attention — ``paged_gather``,
  ``paged_write`` (at an int and at a 0-d tensor start), ``paged_prefix``,
  ``flash_decode_paged_ref`` and ``flash_prefill_chunk_paged_ref`` —
  against the reference's on the same seeded numpy inputs (a shuffled page
  table, a partial last page, windows and softcaps), within 1e-5 in
  float32.
* The card's chunk route (``impl="kernel"``, which on CPU tensors runs the
  wrapper's plain version over the cut prefix) against the reference's
  paged chunk over a shared partial page whose rows past ``start`` hold a
  prefix donor's other tokens.
* ``decode_step_paged``, ``prefill_chunk_paged`` and
  ``prefill_packed_paged`` against the JAX api on the qwen2-1.5b,
  h2o-danube-1.8b and recurrentgemma-9b smoke configs (converted
  parameters; a request whose pages lie out of order in the pool): logits
  within 1e-4 x (1 + |max|) and the pool's pages within 5e-4 (the chunk
  tests' state bound: a deeper layer's K/V carries the float32 sums of
  the layers before it).
* The pool's invariants as ``tests/test_serve_paged.py`` pins them: a double
  release raises, a non-contiguous write raises, reservation admission.
* Addresses: a captured step holds the pool's and the slot's table
  tensors, so their ``data_ptr``s must not change across copy-on-write
  splits and steps.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.kernels.flash_attention import chunked as jax_chunked  # noqa: E402
from repro.kernels.flash_attention import decode as jax_decode  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels.flash_attention import chunked, decode  # noqa: E402
from repro_torch.models import api, attention  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.transformer import decompose  # noqa: E402
from repro_torch.serve import PagedKVPool, ServeEngine  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
STATE_TOL = dict(rtol=5e-4, atol=5e-4)
N_PAGES, HKV, PAGE, D = 7, 2, 4, 16
TABLE = [5, 2, 6, 0]          # n_pt = 4; the last entry unmapped (page 0)


def _rng(seed):
    return np.random.default_rng(seed)


def _pages(seed):
    return _rng(seed).standard_normal((N_PAGES, HKV, PAGE, D)).astype(
        np.float32)


def _both(a):
    """The same numpy array as a JAX and a torch tensor."""
    return jnp.asarray(a), torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# The plain paged functions
# ---------------------------------------------------------------------------

def test_paged_gather_matches_reference():
    pj, pt = _both(_pages(0))
    tj, tt = _both(np.array(TABLE, np.int32))
    want = jax_decode.paged_gather(pj, tj)
    got = decode.paged_gather(pt, tt)
    assert got.shape == (1, HKV, len(TABLE) * PAGE, D)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("start,as_tensor", [(5, False), (5, True),
                                             (0, False), (11, True)])
def test_paged_write_matches_reference(start, as_tensor):
    pages = _pages(1)
    x = _rng(2).standard_normal((1, HKV, 3, D)).astype(np.float32)
    tj, tt = _both(np.array(TABLE, np.int32))
    want = jax_decode.paged_write(jnp.asarray(pages), tj, jnp.asarray(x),
                                  jnp.asarray(start, jnp.int32))
    got = torch.from_numpy(pages.copy())
    s = torch.tensor(start, dtype=torch.int32) if as_tensor else start
    out = decode.paged_write(got, tt, torch.from_numpy(x), s)
    assert out is got                                     # in place
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("pos,window,softcap", [(9, None, None),
                                                 (13, 5, None),
                                                 (2, None, 30.0)])
def test_flash_decode_paged_ref_matches_reference(pos, window, softcap):
    kp, vp = _pages(3), _pages(4)
    q = _rng(5).standard_normal((1, 2 * HKV, D)).astype(np.float32)
    table = np.array(TABLE, np.int32)
    want = jax_decode.flash_decode_paged_ref(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        pos=jnp.asarray(pos, jnp.int32), window=window, softcap=softcap,
        bkv=8)
    got = decode.flash_decode_paged_ref(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), pos=torch.tensor(pos, dtype=torch.int32),
        window=window, softcap=softcap, bkv=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("start", [3, 4, 10])
def test_paged_prefix_matches_reference(start):
    kp, vp = _pages(6), _pages(7)
    table = np.array(TABLE, np.int32)
    n_pp = -(-start // PAGE)
    want = jax_chunked.paged_prefix(jnp.asarray(kp), jnp.asarray(vp),
                                    jnp.asarray(table), n_pp, start)
    got = chunked.paged_prefix(torch.from_numpy(kp), torch.from_numpy(vp),
                               torch.from_numpy(table), n_pp, start)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("start,c,window,softcap", [
    (0, 5, None, None), (6, 5, None, None), (8, 3, 5, None),
    (10, 4, None, 20.0)])
def test_flash_prefill_chunk_paged_ref_matches_reference(start, c, window,
                                                         softcap):
    kp, vp = _pages(8), _pages(9)
    rng = _rng(10 + start)
    q = rng.standard_normal((1, 2 * HKV, c, D)).astype(np.float32)
    kc = rng.standard_normal((1, HKV, c, D)).astype(np.float32)
    vc = rng.standard_normal((1, HKV, c, D)).astype(np.float32)
    table = np.array(TABLE, np.int32)
    q_pos = np.arange(start, start + c, dtype=np.int32)
    n_pp = -(-start // PAGE)
    kw = dict(start=start, n_prefix_pages=n_pp, window=window,
              softcap=softcap, bkv=4)
    want = jax_chunked.flash_prefill_chunk_paged_ref(
        *(jnp.asarray(a) for a in (q, kc, vc, kp, vp, table)),
        q_pos=jnp.asarray(q_pos), **kw)
    got = chunked.flash_prefill_chunk_paged_ref(
        *(torch.from_numpy(a) for a in (q, kc, vc, kp, vp, table)),
        q_pos=torch.from_numpy(q_pos), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# One attention block over the pool, the card's route included
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["auto", "kernel"])
def test_paged_chunk_over_a_shared_partial_page(impl):
    """A recipient's chunk at start 6 over a table whose page 1 is
    partial and holds a donor's own rows 6..7 (garbage to the recipient).
    The plain version masks them with ``kv_pos = -1``; the card's route
    (``impl="kernel"``) cuts the gathered prefix at ``start``. Both equal
    the reference's paged chunk, and the chunk's rows land in the table's
    pages."""
    cfg_j, cfg_t = (jax_configs.get_smoke("qwen2-1.5b"),
                    configs.get_smoke("qwen2-1.5b"))
    pj = jax_layers.init_tree(jax_attn.attn_defs(cfg_j),
                              jax.random.PRNGKey(4), jnp.float32)
    pt = {k: torch.from_numpy(np.array(v)) for k, v in pj.items()}
    hkv, hd = cfg_t.padded_kv_heads, cfg_t.head_dim_
    rng = _rng(11)
    kp = rng.standard_normal((N_PAGES, hkv, PAGE, hd)).astype(np.float32)
    vp = rng.standard_normal((N_PAGES, hkv, PAGE, hd)).astype(np.float32)
    table = np.array(TABLE, np.int32)
    start, c = 6, 5
    x = rng.standard_normal((1, c, cfg_t.d_model)).astype(np.float32)
    pos = np.arange(start, start + c)[None]
    cj = {"k_pages": jnp.asarray(kp), "v_pages": jnp.asarray(vp),
          "table": jnp.asarray(table), "pos": jnp.zeros((), jnp.int32)}
    yj, cj = jax_attn.attn_prefill_chunk(pj, cfg_j, jnp.asarray(x),
                                         jnp.asarray(pos), cache=cj,
                                         start=start)
    ct = {"k_pages": torch.from_numpy(kp.copy()),
          "v_pages": torch.from_numpy(vp.copy()),
          "table": torch.from_numpy(table),
          "pos": torch.zeros((), dtype=torch.int32)}
    yt, ct = attention.attn_prefill_chunk(pt, cfg_t, torch.from_numpy(x),
                                          torch.from_numpy(pos), cache=ct,
                                          start=start, impl=impl)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    for key in ("k_pages", "v_pages", "pos"):
        np.testing.assert_allclose(ct[key].numpy(), np.asarray(cj[key]),
                                   **TOL, err_msg=key)


# ---------------------------------------------------------------------------
# The model's paged entry points against the JAX api
# ---------------------------------------------------------------------------

ARCHS = ["qwen2-1.5b", "h2o-danube-1.8b", "recurrentgemma-9b"]
MODEL_PAGE, MODEL_MAX_LEN, MODEL_PAGES = 8, 40, 12


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    cfg_j = jax_configs.get_smoke(request.param)
    cfg_t = configs.get_smoke(request.param)
    pj = jax_api.init_params(cfg_j, jax.random.PRNGKey(0))
    pt = params_from_jax(cfg_t, jax.tree.map(np.asarray, pj), device="cpu")
    return cfg_j, cfg_t, pj, pt


def _pool_from_jax(cfg, pool):
    """The reference's pool (segments, scan reps stacked) as the port's
    per-layer list."""
    out = []
    for seg, group in zip(decompose(cfg), pool):
        if seg[0] == "seq":
            out += list(group)
        else:
            for r in range(seg[2]):
                out += [None if leaf is None else
                        {k: np.asarray(v)[r] for k, v in leaf.items()}
                        for leaf in group]
    return out


def _assert_pools(cfg, pool_t, pool_j):
    for i, (lt, lj) in enumerate(zip(pool_t, _pool_from_jax(cfg, pool_j))):
        assert (lt is None) == (lj is None), i
        if lt is not None:
            for key in ("k_pages", "v_pages"):
                np.testing.assert_allclose(lt[key].numpy(),
                                           np.asarray(lj[key]), **STATE_TOL,
                                           err_msg=f"layer {i} {key}")


def _assert_logits(got, want):
    want = np.asarray(want)
    tol = 1e-4 * (1 + np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def _tables(n_pt):
    """Two requests' tables over a pool of MODEL_PAGES pages, out of order
    and interleaved; entries past what a request writes stay at page 0."""
    perm = _rng(12).permutation(np.arange(1, MODEL_PAGES))
    return perm[:n_pt].astype(np.int32), perm[n_pt:2 * n_pt].astype(np.int32)


def test_prefill_chunk_and_decode_paged_match_reference(models):
    cfg_j, cfg_t, pj, pt = models
    n_pt = -(-MODEL_MAX_LEN // MODEL_PAGE)
    table, _ = _tables(n_pt)
    pool_j = jax_api.make_paged_pool(cfg_j, MODEL_PAGES, MODEL_PAGE,
                                     jnp.float32)
    st_j = jax_api.make_paged_state(cfg_j, jnp.float32)
    pool_t = api.make_paged_pool(cfg_t, MODEL_PAGES, MODEL_PAGE,
                                 torch.float32, device="cpu")
    st_t = api.make_paged_state(cfg_t, torch.float32, device="cpu")
    tj, tt = jnp.asarray(table), torch.from_numpy(table)
    prompt = _rng(13).integers(2, cfg_t.vocab_size, size=21)
    for start, c in ((0, 7), (7, 14)):
        toks = prompt[None, start:start + c]
        lj, st_j, pool_j = jax_api.prefill_chunk_paged(
            pj, cfg_j, jnp.asarray(toks), st_j, start, pool_j, tj)
        lt, st_t, pool_t2 = api.prefill_chunk_paged(
            pt, cfg_t, toks, st_t, start, pool_t, tt)
        assert pool_t2 is pool_t
        _assert_logits(lt, lj)
    _assert_pools(cfg_t, pool_t, pool_j)
    tok = int(np.argmax(np.asarray(lj)[0, :cfg_t.vocab_size]))
    for _ in range(4):                       # crosses the page edge at 24
        lj, st_j, pool_j = jax_api.decode_step_paged(
            pj, cfg_j, jnp.asarray([[tok]]), st_j, pool_j, tj)
        lt, st_t, _ = api.decode_step_paged(pt, cfg_t, [[tok]], st_t,
                                            pool_t, tt)
        _assert_logits(lt, lj)
        tok = int(np.argmax(np.asarray(lj)[0, :cfg_t.vocab_size]))
    _assert_pools(cfg_t, pool_t, pool_j)


def test_prefill_packed_paged_matches_reference(models):
    cfg_j, cfg_t, pj, pt = models
    n_pt = -(-MODEL_MAX_LEN // MODEL_PAGE)
    tables = _tables(n_pt)
    pool_j = jax_api.make_paged_pool(cfg_j, MODEL_PAGES, MODEL_PAGE,
                                     jnp.float32)
    pool_t = api.make_paged_pool(cfg_t, MODEL_PAGES, MODEL_PAGE,
                                 torch.float32, device="cpu")
    sts_j = tuple(jax_api.make_paged_state(cfg_j, jnp.float32)
                  for _ in tables)
    sts_t = tuple(api.make_paged_state(cfg_t, torch.float32, device="cpu")
                  for _ in tables)
    rng = _rng(14)
    prompts = [rng.integers(2, cfg_t.vocab_size, size=n) for n in (13, 10)]
    for layout in (((0, 5), (0, 6)), ((5, 8), (6, 4))):
        toks = np.concatenate([p[s:s + n] for p, (s, n) in
                               zip(prompts, layout)])[None]
        lj, sts_j, pool_j = jax_api.prefill_packed_paged(
            pj, cfg_j, jnp.asarray(toks), sts_j, layout, pool_j,
            tuple(jnp.asarray(t) for t in tables))
        lt, sts_t, _ = api.prefill_packed_paged(
            pt, cfg_t, toks, sts_t, layout, pool_t,
            tuple(torch.from_numpy(t) for t in tables))
        _assert_logits(lt, lj)
    _assert_pools(cfg_t, pool_t, pool_j)


def test_paged_entry_points_refuse_encoder_decoder_models():
    cfg = configs.get_smoke("whisper-large-v3")
    with pytest.raises(NotImplementedError):
        api.make_paged_pool(cfg, 4, 8, torch.float32, device="cpu")
    with pytest.raises(NotImplementedError):
        api.make_paged_state(cfg, torch.float32, device="cpu")


# ---------------------------------------------------------------------------
# Pool invariants (tests/test_serve_paged.py's)
# ---------------------------------------------------------------------------

def _tiny_pool(n_pages=8, page=4, max_len=16):
    return PagedKVPool(configs.get_smoke("qwen2-1.5b"), n_pages=n_pages,
                       page=page, max_len=max_len, dtype=torch.float32,
                       device="cpu")


def test_pool_double_release_raises():
    pool = _tiny_pool()
    pool.register_request(0, 8)
    pool.prepare_span(0, 0, 8)
    assert pool.release(0) == 2
    with pytest.raises(KeyError):
        pool.release(0)                         # lifecycle bug, never silent
    assert pool.release(0, missing_ok=True) == 0
    pool.check_balanced()


def test_pool_noncontiguous_write_raises():
    pool = _tiny_pool()
    pool.register_request(0, 16)
    with pytest.raises(ValueError):
        pool.prepare_span(0, 8, 4)              # skips the first two pages
    pool.release(0)
    pool.check_balanced()


def test_pool_reservation_admission():
    pool = _tiny_pool(n_pages=8, page=4, max_len=32)
    assert pool.can_admit(8)                    # 2 pages + 2 slack <= 8 free
    pool.register_request(0, 8)
    assert pool.can_admit(8)
    pool.register_request(1, 8)
    assert not pool.can_admit(4)                # 2+2 free pages short
    for rid in (0, 1):
        pool.prepare_span(rid, 0, 8)            # worst case actually lands
        pool.release(rid)
    pool.check_balanced()


def test_pool_copy_on_write_copies_in_place():
    """A split copies the shared page into a fresh one in every layer's
    K and V, in place, and the table points at the copy; the donor's page
    is untouched and the table tensor takes the new table."""
    pool = _tiny_pool(n_pages=8, page=4, max_len=16)
    pool.register_request(0, 10)
    pool.prepare_span(0, 0, 6)
    leaf = pool.arrays[0]
    for t in leaf.values():
        t.copy_(torch.randn(t.shape, generator=torch.Generator().manual_seed(0)))
    before = {k: t.clone() for k, t in leaf.items()}
    ptrs = {k: t.data_ptr() for k, t in leaf.items()}
    pool.register_prefix(0, list(range(6)))
    pool.register_request(1, 10)
    assert pool.lookup_prefix(1, list(range(6)) + [9, 9]) == 6
    donor = list(pool.tables[0])
    assert pool.tables[1] == donor
    pool.prepare_span(1, 6, 2)                  # into the shared page 1
    new = pool.tables[1][1]
    assert new != donor[1] and pool.tables[0] == donor
    for k, t in leaf.items():
        assert t.data_ptr() == ptrs[k]
        torch.testing.assert_close(t[new], before[k][donor[1]])
        torch.testing.assert_close(t[donor[1]], before[k][donor[1]])
    table = pool.new_table()
    assert pool.device_table(1, table) is table
    assert table.tolist() == pool.tables[1] + [0, 0]
    for rid in (0, 1):
        pool.release(rid)
    pool.check_balanced()


def test_pool_and_slot_tables_keep_their_addresses():
    """Serving with prefix sharing (splits, new pages, steps, slot reuse):
    the pool's page tensors and every slot's table tensor keep the
    addresses a captured step would hold."""
    cfg = configs.get_smoke("qwen2-1.5b")
    params = api.init_params(cfg, 0, device="cpu")
    eng = ServeEngine(cfg, params, max_len=48, slots=2, prefill_slots=2,
                      paged=True, page_size=4, device="cpu")
    pool_ptrs = [{k: t.data_ptr() for k, t in leaf.items()}
                 for leaf in eng.pool.arrays]
    slot_ptrs = [s.table.data_ptr() for s in eng._slots]
    state_ptrs = [[c["pos"].data_ptr() for c in s.caches]
                  for s in eng._slots]
    rng = _rng(15)
    donor = rng.integers(2, cfg.vocab_size, size=10)
    eng.add_request(donor, max_new_tokens=8)
    eng.step()
    for tail in (5, 3, 7):
        eng.add_request(np.concatenate(
            [donor, rng.integers(2, cfg.vocab_size, size=tail)]),
            max_new_tokens=6)
    eng.run_until_done()
    pool = eng.metrics.as_dict()["pool"]
    assert pool["prefix_hits"] >= 1 and pool["cow_splits"] >= 1
    eng.pool.check_balanced()
    assert [{k: t.data_ptr() for k, t in leaf.items()}
            for leaf in eng.pool.arrays] == pool_ptrs
    assert [s.table.data_ptr() for s in eng._slots] == slot_ptrs
    assert [[c["pos"].data_ptr() for c in s.caches]
            for s in eng._slots] == state_ptrs


def test_kv_page_spec_is_priced_for_the_h100():
    """The page cell: the reference's default, no shared-memory term (no
    launch stages a page), and a sweep whose best page lies inside the
    candidates — per-run and table costs push it up, the rounding of the
    view, the split copy and the tail waste push it down."""
    from repro_torch import kernels
    from repro_torch.core import H100_SXM, Autotuner, registry

    kernels.register_all()
    spec = registry.get("kv_page")
    for skv in (64, 1280, 4096):
        prob = dict(skv=skv, d=128, hkv=2)
        assert spec.default_tile(prob, "float32")[0] == min(512, skv)
    prob = dict(skv=1280, d=128, hkv=2)
    best = Autotuner().sweep("kv_page", prob, "float32", H100_SXM).best.tile[0]
    assert spec.vmem_bytes((best,), prob, "float32") == 0.0
    assert 32 < best < 1280, best
