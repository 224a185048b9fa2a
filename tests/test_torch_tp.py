"""Tensor parallelism of the port without a process group: the blocks a rank
holds, the KV heads its query heads read, the vocab-parallel cross-entropy
and the dry run's count of a tensor-parallel step.

* Every full-width config's parameters on a rank of a 1 x m mesh (m = 2, 4,
  16; a stub mesh, rank 0 and the last) have the block shapes of the
  reference's ``param_spec(..., fsdp=False)`` on the attention, dense FF,
  MoE, RG-LRU, SSD, ``embed`` and ``lm_head`` leaves (an encoder-decoder's
  encoder and decoder attention and FF among them), and the whole shape
  on every other. An SSD block splits by whole heads: where the model
  ranks do not divide the heads (mamba2's 80 at 32, the smoke mamba2's 8
  at 16) every leaf of it stays whole, where the reference cuts its
  ``d_inner`` leaves; pinned, as are the recurrent serve states (the
  rank's features and heads; ``conv_B`` / ``conv_C`` whole, where the
  reference's ``serve_state_shardings`` names the model axis).
* ``attention.local_heads``: each rank's query heads tile the padded heads,
  its KV heads are those they read, and the split of the configs' widths at
  16 model ranks is the one ``configs/base.py``'s padding gives; an
  encoder-decoder's heads (``encdec.local_heads``) tile its padded heads,
  and its self and cross caches hold them, each its own tensor at the
  block's shape of the reference's ``serve_state_shardings``.
* The padded heads are masked by their global index: on four threads
  standing in for a 1 x 4 mesh the smoke whisper's blocks give the whole
  model's logits, and a mask built from the local index reads far off.
* The vocab-parallel NLL of a logits tensor cut into blocks, its collectives
  played by threads that sum (and take the max of) the blocks' values,
  equals ``transformer._nll`` over the whole tensor, gradients included.
* The dry run of the smoke qwen2 on a fake 1 x 2 group counts about half
  the dense FLOPs of a 1 x 1 one, and records the model axis's all-reduces;
  so do the smoke mamba2's and recurrentgemma's train steps (the gates'
  reduce-scatters among them), and their decode cells hold the rank's
  recurrent state; so do the smoke whisper's (its attention, FF and head
  halved, its decode cell on the rank's self and cross heads).
"""
import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.distributed import sharding_rules as jax_rules  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint.manager import _flatten  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec  # noqa: E402
from repro_torch.distributed import sharding_rules as rules  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import encdec as E  # noqa: E402
from repro_torch.models import ssm as S_mod  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.context import DistContext, local_range  # noqa: E402

ARCHS = configs.list_archs()
SPLIT_MODULES = ("attn", "ff", "moe", "rglru", "ssm")
ENCDEC_SPLIT_MODULES = ("attn", "self_attn", "cross_attn", "ff")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Mesh:
    """A 1 x m mesh seen from model coordinate ``i``; no process group."""

    axis_names = ("data", "model")

    def __init__(self, m: int, i: int):
        self.shape = {"data": 1, "model": m}
        self.coords = {"data": 0, "model": i}

    def group(self, axes):
        return ("group", axes)


def _ctx(m: int, i: int) -> DistContext:
    return rules.make_context(_Mesh(m, i))


def _in_slice(path: str) -> bool:
    parts = path.split("/")
    if parts[0] in ("embed", "lm_head"):
        return True
    if parts[0] in ("enc_layers", "dec_layers"):
        return parts[2] in ENCDEC_SPLIT_MODULES
    return parts[0] == "layers" and parts[2] in SPLIT_MODULES


@pytest.mark.parametrize("arch", ARCHS)
def test_block_shapes_are_the_references_model_specs(arch):
    cfg = configs.get_arch(arch)
    whole = _flatten(api.init_params(cfg, device="meta"))
    axes = {k: d.axes for k, d in _flatten(api.param_defs(cfg)).items()}
    for m in (2, 4, 16):
        mesh = _Mesh(m, 0)
        for i in (0, m - 1):
            got = _flatten(api.init_params(cfg, device="meta",
                                           ctx=_ctx(m, i)))
            assert set(got) == set(whole)
            for k, t in whole.items():
                shape = tuple(t.shape)
                spec = rules.param_spec(axes[k], shape, mesh, fsdp=False)
                assert tuple(spec) == tuple(jax_rules.param_spec(
                    axes[k], shape, mesh, fsdp=False)), k
                want = (rules.NamedSharding(mesh, spec).shard_shape(shape)
                        if _in_slice(k) else shape)
                assert tuple(got[k].shape) == want, (arch, m, k)
    # The rule's blocks, leaf by leaf: ``rank_shardings`` names the model axis
    # exactly where a leaf is cut.
    sh = _flatten(api.rank_shardings(cfg, _ctx(16, 0)))
    cut = _flatten(api.init_params(cfg, device="meta", ctx=_ctx(16, 0)))
    for k, t in whole.items():
        assert bool(sh[k].spec) == (tuple(cut[k].shape) != tuple(
            t.shape)), k


@pytest.mark.parametrize("arch,get,m,split", [
    ("mamba2-2.7b", "get_arch", 16, True), ("mamba2-2.7b", "get_arch", 32,
                                             False),
    ("mamba2-2.7b", "get_smoke", 2, True), ("mamba2-2.7b", "get_smoke", 16,
                                            False)])
def test_the_ssd_block_splits_by_its_heads(arch, get, m, split):
    """The deliberate difference in the SSD block: the port splits all of
    it where the model ranks divide its heads and none of it otherwise.
    The reference tests each leaf's size alone, so at 80 heads over 32
    ranks (and the smoke's 8 over 16) it cuts the ``d_inner`` leaves and
    keeps the per-head ones whole."""
    cfg = getattr(configs, get)(arch)
    h = cfg.ssm.n_heads(cfg.d_model)
    assert (h % m == 0) == split
    mesh = _Mesh(m, 0)
    sh = _flatten(api.rank_shardings(cfg, _ctx(m, 0)))
    defs = _flatten(api.param_defs(cfg))
    per_head = {"in_dt", "A_log", "D", "dt_bias"}
    inner = {"in_z", "in_x", "conv_x_w", "conv_x_b", "norm_w", "out_proj"}
    seen = set()
    for k, d in defs.items():
        if "/ssm/" not in k:
            continue
        name = k.split("/")[-1]
        ref = tuple(jax_rules.param_spec(d.axes, d.shape, mesh, fsdp=False))
        got = tuple(sh[k].spec) + (None,) * (len(d.shape) - len(sh[k].spec))
        if name in per_head | inner:
            seen.add(name)
            assert ("model" in got) == split, k
            assert ("model" in ref) == (split or name in inner), k
        else:                                   # in_B, in_C, their convs
            assert "model" not in got and "model" not in ref, k
        if split or name not in inner:
            assert got == ref, k
    assert seen == per_head | inner
    assert (local_range(_ctx(m, 0), "ssm_heads", h) is not None) == split
    assert (S_mod.local_heads(cfg, _ctx(m, 0)) is not None) == split


@pytest.mark.parametrize("arch,m", [("mamba2-2.7b", 2), ("mamba2-2.7b", 16),
                                    ("recurrentgemma-9b", 2),
                                    ("recurrentgemma-9b", 4)])
def test_the_mixer_serve_state_is_the_ranks_block(arch, m):
    """``make_serve_state(ctx=)``'s recurrent leaves have the shapes of the
    reference's ``serve_state_shardings`` blocks (``rules``', pinned equal
    to it in ``tests/test_torch_sharding.py``) of the whole state, but
    ``conv_B`` / ``conv_C``, whole (every rank computes B and C whole), and
    an SSD state where the head rule keeps the block whole; each is a
    tensor of its own, not a view (the ssd kernel reads ``h`` from 16-byte
    starts)."""
    cfg = configs.get_smoke(arch)
    b = 2
    whole = api.make_serve_state(cfg, b, 16, torch.float32, device="cpu")
    for i in (0, m - 1):
        ctx = _ctx(m, i)
        mine = api.make_serve_state(cfg, b, 16, torch.float32, device="cpu",
                                    ctx=ctx)
        ref = rules.serve_state_shardings(whole, _Mesh(m, i))
        heads_split = (arch != "mamba2-2.7b" or S_mod.local_heads(
            cfg, ctx) is not None)
        for w, got, sh in zip(whole, mine, ref):
            if "k" in w:
                continue
            for k, t in got.items():
                assert t._base is None and t.is_contiguous(), k
                assert t.untyped_storage().nbytes() == t.numel() * 4, k
                want = tuple(w[k].shape)
                if k not in ("conv_B", "conv_C") and heads_split:
                    want = sh[k].shard_shape(want)
                assert tuple(t.shape) == want, (k, tuple(t.shape), want)
                if k in ("conv_B", "conv_C"):
                    assert sh[k].shard_shape(tuple(w[k].shape)) != want


@pytest.mark.parametrize("m", [2, 4])
def test_init_cuts_each_leaf_as_it_is_drawn(m, monkeypatch):
    """``init_params(ctx=)`` cuts each leaf to the rank's block as it draws
    it (``init_tree``'s ``cut``), and the blocks equal those of the whole
    tree drawn from the same seed."""
    cfg = configs.get_smoke("qwen2-1.5b")
    whole = api.init_params(cfg, 3, device="cpu")
    draw = T.init_tree
    sizes = []

    def tracking(defs, gen, dtype, device, cut=None):
        def kept(d, x):
            out = cut(d, x)
            sizes.append((x.numel(), out.numel()))
            return out
        return draw(defs, gen, dtype, device, kept)

    monkeypatch.setattr(T, "init_tree", tracking)
    for i in range(m):
        ctx = _ctx(m, i)
        sizes.clear()
        got = _flatten(api.init_params(cfg, 3, device="cpu", ctx=ctx))
        want = _flatten(api.shard_params(whole, cfg, ctx))
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
        assert len(sizes) == len(want)
        assert sum(o for _, o in sizes) < sum(n for n, _ in sizes)


def test_the_full_width_split_at_16_model_ranks():
    """Query heads, KV heads and d_ff a rank at 16 model ranks, and the
    vocabulary's columns (``configs/base.py``'s padded counts)."""
    want = {  # arch: (query heads, KV heads read, KV split, d_ff, vocab)
        "qwen2-1.5b": (1, 1, False, 560, 9600),
        "command-r-35b": (4, 1, False, None, 16000),
        "deepseek-moe-16b": (1, 1, True, None, None),
        "gemma2-9b": (1, 1, False, None, 16000),
    }
    for arch, (nq, nkv, split, ff, vocab) in want.items():
        cfg = configs.get_arch(arch)
        for i in range(16):
            ctx = _ctx(16, i)
            (q0, q1), (k0, k1) = A.local_heads(cfg, ctx)
            assert (q1 - q0, k1 - k0) == (nq, nkv), arch
            assert (local_range(ctx, "kv_heads", cfg.padded_kv_heads)
                    is not None) == split
            if ff is not None:
                lo, hi = local_range(ctx, "ff", cfg.d_ff)
                assert hi - lo == ff
            if vocab is not None:
                lo, hi = local_range(ctx, "vocab", cfg.padded_vocab)
                assert hi - lo == vocab
    # qwen2: ranks 12-15 hold only padded query heads.
    cfg = configs.get_arch("qwen2-1.5b")
    assert cfg.n_heads == 12 and cfg.padded_heads == 16
    assert A.local_heads(cfg, _ctx(16, 12))[0] == (12, 13)


@pytest.mark.parametrize("arch", ARCHS)
def test_kv_head_map(arch):
    """Every rank's query heads tile the padded heads in rank order and
    read the contiguous KV heads ``h // (Hq / Hkv)``, with one local ratio;
    a rank's cache holds those KV heads."""
    cfg = configs.get_arch(arch)
    hq, hkv = cfg.padded_heads, cfg.padded_kv_heads
    if not hq:
        return
    if api.is_encdec(cfg):
        _encdec_head_map(cfg)
        return
    rep = hq // hkv
    for m in (2, 4, 16):
        start = 0
        for i in range(m):
            ctx = _ctx(m, i)
            (q0, q1), (k0, k1) = A.local_heads(cfg, ctx)
            assert q0 == start and q1 - q0 == hq // m
            start = q1
            assert sorted({h // rep for h in range(q0, q1)}) == list(
                range(k0, k1))
            assert (q1 - q0) % (k1 - k0) == 0
            assert (local_range(ctx, "kv_heads", hkv) is not None) == (
                hkv % m == 0 and hkv >= m)
            cache = A.make_kv_cache(cfg, 1, 8, torch.float32, device="meta",
                                    ctx=ctx)
            assert cache["k"].shape[1] == k1 - k0
        assert start == hq
    assert A.local_heads(cfg, None) == ((0, hq), (0, hkv))


def _encdec_head_map(cfg):
    """An encoder-decoder's heads (MHA: one KV head a query head) tile its
    padded heads in rank order, and a rank's self and cross caches hold
    its heads."""
    hq = cfg.padded_heads
    enc = torch.empty((1, cfg.encoder.seq_len, cfg.d_model), device="meta")
    for m in (2, 4, 16):
        start = 0
        for i in range(m):
            ctx = _ctx(m, i)
            h0, h1 = E.local_heads(cfg, ctx)
            assert h0 == start and h1 - h0 == hq // m
            start = h1
            state = api.make_serve_state(
                cfg, 1, 8, torch.float32, device="meta", enc_out=enc,
                params=api.init_params(cfg, device="meta", ctx=ctx), ctx=ctx)
            caches = state["self_k"] + state["self_v"] + [
                t for pair in state["cross"] for t in pair]
            assert {t.shape[1] for t in caches} == {h1 - h0}
        assert start == hq
    assert E.local_heads(cfg, None) == (0, hq)


@pytest.mark.parametrize("m", [2, 4])
def test_the_encoder_decoder_serve_state_is_the_ranks_block(m):
    """``make_serve_state(ctx=)``'s whisper tensors (the smoke's 16 padded
    heads) have the shapes of the reference's ``serve_state_shardings``
    blocks (``rules``', pinned equal to it in
    ``tests/test_torch_sharding.py``) of the whole state: ``self_k`` /
    ``self_v`` and each ``cross`` pair on the rank's heads, each a tensor
    of its own; the cross K/V are the whole state's on those heads."""
    cfg = configs.get_smoke("whisper-large-v3")
    b = 2
    params = api.init_params(cfg, 4, device="cpu")
    enc = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (b, cfg.encoder.seq_len, cfg.d_model)).astype(np.float32))
    whole = api.make_serve_state(cfg, b, 16, torch.float32, enc_out=enc,
                                 params=params)
    for i in range(m):
        ctx = _ctx(m, i)
        mine = api.make_serve_state(cfg, b, 16, torch.float32, enc_out=enc,
                                    params=api.shard_params(params, cfg, ctx),
                                    ctx=ctx)
        ref = rules.serve_state_shardings(whole, _Mesh(m, i))
        h0, h1 = E.local_heads(cfg, ctx)
        pairs = [(mine[k][li], whole[k][li], ref[k][li])
                 for k in ("self_k", "self_v") for li in range(cfg.n_layers)]
        pairs += [(mine["cross"][li][j], whole["cross"][li][j],
                   ref["cross"][li][j])
                  for li in range(cfg.n_layers) for j in (0, 1)]
        for got, w, sh in pairs:
            assert got._base is None and got.is_contiguous()
            assert got.untyped_storage().nbytes() == got.numel() * 4
            assert tuple(got.shape) == sh.shard_shape(tuple(w.shape))
            assert tuple(got.shape) != tuple(w.shape)
            torch.testing.assert_close(got, w[:, h0:h1], rtol=1e-6,
                                       atol=1e-6)
        assert mine["pos"].dim() == 0 and ref["pos"].spec == ()


def test_one_model_rank_is_the_one_device_encoder_decoder():
    """On a 1 x 1 mesh (one model rank, FSDP with one data rank) whisper's
    prefill, decode step and loss are the one-device path's, bit for
    bit."""
    cfg = configs.get_smoke("whisper-large-v3")
    params = api.init_params(cfg, 6, device="cpu")
    rng = np.random.default_rng(6)
    batch = {"tokens": rng.integers(2, cfg.vocab_size, (2, 5)),
             "frames": rng.standard_normal(
                 (2, cfg.encoder.seq_len, cfg.d_model)).astype(np.float32)}
    batch["targets"] = batch["tokens"]
    outs = []
    for ctx in (None, _ctx(1, 0)):
        with torch.no_grad():
            logits, state = api.prefill(params, cfg, batch, max_len=8,
                                        ctx=ctx)
            step, state = api.decode_step(params, cfg,
                                          torch.tensor([[3], [4]]), state,
                                          ctx=ctx)
            loss, _ = api.train_loss(params, cfg, batch, ctx=ctx)
        outs.append((logits, step, state["self_k"][0], state["cross"][1][0],
                     loss))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_heads_that_map_onto_no_whole_kv_heads_raise():
    cfg = dataclasses.replace(configs.get_arch("qwen2-1.5b"), n_heads=48,
                              n_kv_heads=16).validate()
    mesh = _Mesh(3, 1)
    with pytest.raises(ValueError, match="do not split over 3 model ranks"):
        A.local_heads(cfg, rules.make_context(mesh))


# -- the vocab-parallel cross-entropy -----------------------------------------

class _ThreadGroup:
    """The model axis's collectives for ``m`` threads, one a block: each
    call waits for every block's value and returns their sum (or max);
    ``sum_from_group`` passes its cotangent through, as the port's does."""

    def __init__(self, m: int):
        self.m = m
        self.barrier = threading.Barrier(m)
        self.slots = [None] * m
        self.local = threading.local()

    def _reduce(self, x, op):
        self.slots[self.local.rank] = x.detach()
        self.barrier.wait()
        stack = torch.stack(self.slots)
        out = stack.amax(0) if op == "max" else stack.sum(0)
        self.barrier.wait()
        return out

    def all_reduce(self, x, op="sum", group=None):
        return self._reduce(x, op)

    def sum_from_group(self, x, group):
        return x + (self._reduce(x, "sum") - x).detach()

    def copy_to_group(self, x, group):
        return x

    def all_gather(self, x, dim=0, group=None):
        self.slots[self.local.rank] = x.detach()
        self.barrier.wait()
        out = torch.cat(self.slots, dim)
        self.barrier.wait()
        return out


def _blocks(m, fn):
    """``fn(rank)`` on ``m`` threads; their results in rank order."""
    out, errors = [None] * m, []

    def run(r):
        try:
            out[r] = fn(r)
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(m)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma2-9b"])
def test_vocab_parallel_nll_equals_the_whole(monkeypatch, arch, m):
    """Logits over the padded vocabulary (the smoke configs' 256 real
    columns of 2048: with 4 blocks three hold only padded ones) cut into
    ``m`` blocks; the blocks' NLLs, their collectives summed by threads,
    equal ``_nll`` of the whole tensor, and so do the gradients."""
    cfg = configs.get_smoke(arch)
    v = cfg.padded_vocab
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((3, 5, v)).astype(
        np.float32) * 4)
    targets = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 5)))
    whole = logits.clone().requires_grad_(True)
    want = T._nll(whole, targets, cfg)
    (g_want,) = torch.autograd.grad(want.sum(), whole)

    group = _ThreadGroup(m)
    monkeypatch.setattr(T, "collectives", group)
    n = v // m

    def block(r):
        group.local.rank = r
        part = logits[..., r * n:(r + 1) * n].clone().requires_grad_(True)
        nll = T._nll(part, targets, cfg, ctx=_ctx(m, r))
        (g,) = torch.autograd.grad(nll.sum(), part)
        return nll.detach(), g

    got = _blocks(m, block)
    for nll, _ in got:
        torch.testing.assert_close(nll, want.detach(), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(torch.cat([g for _, g in got], -1), g_want,
                               rtol=1e-6, atol=1e-7)
    # The padded columns take no probability.
    assert float(g_want[..., cfg.vocab_size:].abs().max()) == 0.0


def test_vocab_parallel_embedding_and_head(monkeypatch):
    """The vocab-parallel lookup (zeros outside a rank's rows, then a sum)
    is the whole lookup exactly; the column-parallel head's blocks are the
    whole logits' columns."""
    cfg = configs.get_smoke("qwen2-1.5b")
    params = api.init_params(cfg, 0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 7)))
    want = T._embed(params, cfg, tokens)
    group = _ThreadGroup(2)
    monkeypatch.setattr(T, "collectives", group)

    def block(r):
        group.local.rank = r
        ctx = _ctx(2, r)
        p = api.shard_params(params, cfg, ctx)
        return (T._embed(p, cfg, tokens, ctx),
                torch.matmul(want, T.head_weight(p, cfg)))

    got = _blocks(2, block)
    for x, _ in got:
        assert torch.equal(x, want)
    torch.testing.assert_close(
        torch.cat([h for _, h in got], -1),
        torch.matmul(want, T.head_weight(params, cfg)), rtol=0, atol=0)


def test_a_local_index_head_mask_reads_far_off(monkeypatch):
    """The smoke whisper's 4 heads padded to 16 on a 1 x 4 mesh: rank 0
    holds the 4 real heads, ranks 1-3 padded ones only. On four threads
    standing in for the ranks, the blocks' prefill logits (every rank
    launches its attention; the FF's ``b2`` added once, after the sum)
    equal the whole model's with the mask by global index; built from the
    local index, it keeps every rank's first 4 heads, and the logits read
    far off."""
    cfg = configs.get_smoke("whisper-large-v3")
    assert (cfg.n_heads, cfg.padded_heads) == (4, 16)
    params = api.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(5)
    # Non-zero FF biases (drawn zero), so that ``b2`` counts once.
    for lp in params["enc_layers"] + params["dec_layers"]:
        for name in ("b1", "b2"):
            lp["ff"][name] = torch.from_numpy(rng.standard_normal(
                lp["ff"][name].shape).astype(np.float32))
    batch = {"tokens": rng.integers(2, cfg.vocab_size, (2, 6)),
             "frames": rng.standard_normal(
                 (2, cfg.encoder.seq_len, cfg.d_model)).astype(np.float32)}
    want, _ = api.prefill(params, cfg, batch, max_len=8)
    group = _ThreadGroup(4)
    monkeypatch.setattr(E, "collectives", group)
    monkeypatch.setattr(T, "collectives", group)

    def prefill(r):
        group.local.rank = r
        ctx = _ctx(4, r)
        logits, _ = api.prefill(api.shard_params(params, cfg, ctx), cfg,
                                batch, max_len=8, ctx=ctx)
        return logits

    for got in _blocks(4, prefill):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)

    def local_index_mask(cfg, out, ctx=None):
        h = out.shape[1]
        mask = (torch.arange(h) < cfg.n_heads).to(out.dtype)
        return out * mask.view((1, h) + (1,) * (out.dim() - 2))

    monkeypatch.setattr(E, "_head_mask", local_index_mask)
    scale = float(want.abs().max())
    for got in _blocks(4, prefill):
        assert float((got - want).abs().max()) > 0.05 * scale


def test_global_norm_sums_blocks_once(monkeypatch):
    """The clip's norm over a tensor-parallel tree: the blocks' squares
    summed over the model group, the whole leaves counted once, equal to
    the norm of the whole tree on every rank (the split tree pairs with
    the gradients by key: its dicts are not in the parameters' order)."""
    from repro_torch.optim import adamw

    cfg = configs.get_smoke("qwen2-1.5b")
    grads = api.init_params(cfg, 1, device="cpu")
    want = adamw.global_norm(grads)
    group = _ThreadGroup(2)
    monkeypatch.setattr(adamw, "collectives", group)
    split = adamw.tree_map(lambda sh: sh.axes,
                           api.rank_shardings(cfg, _ctx(2, 0)))

    def block(r):
        group.local.rank = r
        mine = api.shard_params(grads, cfg, _ctx(2, r))
        return adamw.global_norm(mine, split, _Mesh(2, r).group)

    for got in _blocks(2, block):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


def test_params_from_jax_gives_the_ranks_blocks():
    import jax

    from repro import configs as jax_configs
    from repro.models import api as jax_api
    from repro_torch.models.convert import params_from_jax

    cfg_j = jax_configs.get_smoke("qwen2-1.5b")
    cfg = configs.get_smoke("qwen2-1.5b")
    tree = jax.tree.map(np.asarray, jax.jit(
        jax_api.init_params, static_argnums=0)(cfg_j, jax.random.PRNGKey(0)))
    whole = params_from_jax(cfg, tree, device="cpu")
    for i in range(4):
        ctx = _ctx(4, i)
        got = _flatten(params_from_jax(cfg, tree, device="cpu", ctx=ctx))
        want = _flatten(api.shard_params(whole, cfg, ctx))
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k


# -- the dry run --------------------------------------------------------------

def test_dry_run_of_a_1x2_step_halves_the_dense_flops():
    cfg = configs.get_smoke("qwen2-1.5b")
    shape = ShapeSpec("tp_smoke", 32, 4, "train")
    counts = {}
    for model in (1, 2):
        with dryrun.cell_mesh(local=(1, model)) as mesh:
            counts[model], _ = dryrun._compile_step(
                cfg, shape, mesh, dtype=torch.float32)
    one, two = counts[1], counts[2]
    ratio = two.flops / one.flops
    assert 0.45 <= ratio <= 0.6, ratio
    assert dict(two.launches) == dict(one.launches)
    # A group of one rank moves nothing; on two, the model axis's sums.
    assert one.totals()[2] == 0
    kinds = {kind for kind, _ in two.collectives}
    assert "all-reduce" in kinds and two.totals()[2] > 0


def test_dry_run_of_a_1x2_step_splits_the_encoder_decoder():
    """The smoke whisper's train step on a fake 1 x 2 group counts about
    half the FLOPs of a 1 x 1 one (its attention, FF and tied head split),
    its attention kernels launched as often, and records the model axis's
    sums; its decode cell holds the rank's self and cross heads: about half
    the state's bytes."""
    cfg = configs.get_smoke("whisper-large-v3")
    counts, sizes = {}, {}
    for model in (1, 2):
        with dryrun.cell_mesh(local=(1, model)) as mesh:
            counts[model], _ = dryrun._compile_step(
                cfg, ShapeSpec("tp_smoke", 32, 4, "train"), mesh,
                dtype=torch.float32)
            _, sizes[model] = dryrun._compile_step(
                cfg, ShapeSpec("tp_smoke_decode", 32, 4, "decode"), mesh,
                dtype=torch.float32)
    one, two = counts[1], counts[2]
    ratio = two.flops / one.flops
    assert 0.45 <= ratio <= 0.6, ratio
    assert dict(two.launches) == dict(one.launches)
    assert one.totals()[2] == 0
    kinds = {kind for kind, _ in two.collectives}
    assert "all-reduce" in kinds and two.totals()[2] > 0
    assert sizes[2]["argument_bytes"] < 0.6 * sizes[1]["argument_bytes"]


@pytest.mark.parametrize("arch,lo,hi", [("mamba2-2.7b", 0.45, 0.65),
                                        ("recurrentgemma-9b", 0.45, 0.65)])
def test_dry_run_of_a_1x2_step_splits_the_mixers(arch, lo, hi):
    """The smoke mamba2's and recurrentgemma's train steps on a fake 1 x 2
    group count about half the FLOPs of a 1 x 1 one, their scans launched
    as often; the RG-LRU gates' reduce-scatters and the SSD norm's sums are
    recorded. A decode cell holds the rank's recurrent state: fewer
    argument bytes than on one rank."""
    cfg = configs.get_smoke(arch)
    counts, sizes = {}, {}
    for model in (1, 2):
        with dryrun.cell_mesh(local=(1, model)) as mesh:
            counts[model], _ = dryrun._compile_step(
                cfg, ShapeSpec("tp_smoke", 32, 4, "train"), mesh,
                dtype=torch.float32)
            _, sizes[model] = dryrun._compile_step(
                cfg, ShapeSpec("tp_smoke_decode", 32, 4, "decode"), mesh,
                dtype=torch.float32)
    one, two = counts[1], counts[2]
    ratio = two.flops / one.flops
    assert lo <= ratio <= hi, ratio
    assert dict(two.launches) == dict(one.launches)
    kinds = {kind for kind, _ in two.collectives}
    assert "all-reduce" in kinds
    if arch == "recurrentgemma-9b":
        assert "reduce-scatter" in kinds and "all-gather" in kinds
    assert sizes[2]["argument_bytes"] < sizes[1]["argument_bytes"]
