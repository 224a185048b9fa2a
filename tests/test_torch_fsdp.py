"""FSDP over the data axis in the port, with no process group: the rule
that places each leaf's data block, the blocks a rank draws, the clip's
norm and the batch mean over blocks, the dry run's count of an FSDP step,
and the repaired ``param_bytes_sharded``. The steps on gloo ranks (2 x 2
FSDP train steps against the reference and the one-process step, the
gather's gradient, the restore from FSDP blocks) are in
``tests/test_torch_mesh.py``'s rank group.

* The port's blocks (``api.rank_shardings``) equal the reference's
  ``param_spec(..., fsdp=True)`` on every leaf that the port splits like
  the reference (attention, dense FF, MoE, RG-LRU, SSD, ``embed``,
  ``lm_head``, the norms and the router) of every smoke config, the
  encoder-decoder's layer leaves on a layer's own dims, on 2 x 1, 2 x 2
  and 4 x 2 meshes. The one difference in the
  mixers, the SSD head rule (a block never cuts a head, so where the model
  ranks do not divide the heads the ``d_inner`` leaves stay whole over the
  model axis and take the data axis on their largest dim), is pinned at
  2 x 16. On 2 x 2 each rank draws its blocks cut, and the four ranks'
  blocks tile the whole tree the seed draws (the encoder-decoder's too).
* ``param_bytes_sharded`` pairs each leaf with its sharding by key: the
  bf16 bytes of qwen2-1.5b and qwen3-moe-235b-a22b a rank of the fake
  16 x 16 group holds are pinned, each leaf's spec as long as its shape;
  ``NamedSharding`` refuses a spec longer than the array.
"""
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
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.context import data_dim, data_sharded  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import step as step_mod  # noqa: E402

ARCHS = configs.list_archs()
MIXERS = ("rglru", "ssm")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Mesh:
    """A mesh seen from one coordinate; ``group(axes)`` names this rank's
    line along ``axes`` (the coordinates on the other axes)."""

    def __init__(self, shape: dict, coords: dict = None):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)
        self.coords = dict(coords or {a: 0 for a in shape})

    def group(self, axes):
        axes = tuple(a for a in self.axis_names if a in axes)
        return (axes, tuple(self.coords[a] for a in self.axis_names
                            if a not in axes))


def _ranks(shape: dict):
    """A mesh for every coordinate, in rank order (the last axis fastest)."""
    out = [{}]
    for a, n in shape.items():
        out = [dict(c, **{a: i}) for c in out for i in range(n)]
    return [_Mesh(shape, c) for c in out]


def _full(spec, n):
    return tuple(spec) + (None,) * (n - len(spec))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", [(2, 1), (2, 2), (4, 2)],
                         ids=["2x1", "2x2", "4x2"])
def test_the_rule_is_the_references_on_every_split_alike_leaf(arch, shape):
    cfg = configs.get_smoke(arch)
    mesh = _Mesh({"data": shape[0], "model": shape[1]})
    ctx = rules.make_context(mesh)
    sh = _flatten(api.rank_shardings(cfg, ctx))
    defs = _flatten(api.param_defs(cfg))
    for k, d in defs.items():
        got = _full(sh[k].spec, len(d.shape))
        ref = jax_rules.param_spec(d.axes, d.shape, mesh, fsdp=True)
        if shape[1] == 1:
            # A model axis of one rank is the one-device path: the port
            # names no block of it, the reference a block of one.
            ref = [None if e == "model" else e for e in ref]
        assert got == tuple(ref), (k, got)
        # Every smoke leaf with a dim the model axis leaves (a 1-D mixer
        # leaf has none) takes the data axis.
        model = jax_rules.param_spec(d.axes, d.shape, mesh, fsdp=False)
        assert "data" in got or None not in _full(model, len(d.shape)), k


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mamba2-2.7b"])
@pytest.mark.parametrize("shape", [(2, 2), (2, 16)], ids=["2x2", "2x16"])
def test_the_mixers_data_dims_are_pinned(arch, shape):
    """The mixers' leaves take the reference's ``param_spec(...,
    fsdp=True)``, the model axis on their ``lru`` / ``ssm_heads`` dim, but
    where the SSD head rule bites: the smoke mamba2's 8 heads do not split
    over 16 model ranks, so its ``d_inner`` leaves (which the reference
    cuts, 128 columns over 16) stay whole over the model axis and take the
    data axis on their largest dim, as its per-head leaves do in both."""
    cfg = configs.get_smoke(arch)
    mesh = _Mesh({"data": shape[0], "model": shape[1]})
    ctx = rules.make_context(mesh)
    sh = _flatten(api.rank_shardings(cfg, ctx))
    defs = _flatten(api.param_defs(cfg))
    differ, mixers = [], 0
    for k, d in defs.items():
        if not any(f"/{m}/" in k for m in MIXERS):
            continue
        mixers += 1
        got = _full(sh[k].spec, len(d.shape))
        ref = tuple(jax_rules.param_spec(d.axes, d.shape, mesh, fsdp=True))
        at = got.index("data") if "data" in got else None
        assert at == data_dim(ctx, d.axes, d.shape, d.units), k
        if got != ref:
            differ.append(k.split("/")[-1])
            assert "model" not in got and "model" in ref, k
            assert got == tuple(rules.param_spec(
                (None,) * len(d.shape), d.shape, mesh)), k
    assert mixers
    want = set()
    if arch == "mamba2-2.7b" and shape[1] == 16:
        want = {"in_z", "in_x", "conv_x_w", "conv_x_b", "norm_w",
                "out_proj"}
    assert set(differ) == want


def test_fsdp_off_and_one_data_rank_keep_the_model_split():
    cfg = configs.get_smoke("qwen2-1.5b")
    for mesh, fsdp in ((_Mesh({"data": 2, "model": 2}), False),
                       (_Mesh({"data": 1, "model": 2}), True)):
        ctx = rules.make_context(mesh, fsdp=fsdp)
        assert not data_sharded(ctx)
        for k, s in _flatten(api.rank_shardings(cfg, ctx)).items():
            assert "data" not in s.axes, k
    assert data_sharded(rules.make_context(_Mesh({"data": 2, "model": 1})))


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen3-moe-235b-a22b"])
def test_the_one_device_path_builds_no_defs(arch, monkeypatch):
    """Without FSDP the forward and the eager decode step read the
    parameters as given: no ParamDef tree is built a call."""
    cfg = configs.get_smoke(arch)
    params = api.init_params(cfg, 0, device="cpu")
    tokens = np.random.default_rng(0).integers(2, cfg.vocab_size, (1, 8))
    _, state = api.prefill(params, cfg, {"tokens": tokens}, max_len=16)

    def refuse(*a, **k):
        raise AssertionError("a ParamDef tree was built")

    monkeypatch.setattr(T, "model_defs", refuse)
    monkeypatch.setattr(T, "layer_defs", refuse)
    with torch.no_grad():
        T.forward(params, cfg, torch.from_numpy(tokens))
        api.decode_step(params, cfg, torch.tensor([[3]]), state)


def test_the_encoder_decoder_blocks_tile_the_whole():
    """whisper's leaves on 2 x 2: every rank holds blocks (its heads, FF
    columns and vocabulary over the model axis, a data block of each leaf
    with a free dim), drawn cut, and the four ranks' blocks tile the whole
    tree the seed draws."""
    cfg = configs.get_smoke("whisper-large-v3")
    ctx = rules.make_context(_Mesh({"data": 2, "model": 2}))
    sh = _flatten(api.rank_shardings(cfg, ctx))
    assert all(s.spec != () for s in sh.values())
    _blocks_tile_the_whole(cfg)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen3-moe-235b-a22b"])
def test_the_blocks_are_drawn_cut_and_tile_the_whole(arch):
    """``init_params(ctx=)`` on each rank of 2 x 2 equals the rank's
    blocks of the whole tree the seed draws, and the four ranks' blocks,
    put back where their shardings say, are the whole tree."""
    _blocks_tile_the_whole(configs.get_smoke(arch))


def _blocks_tile_the_whole(cfg):
    whole = _flatten(api.init_params(cfg, 5, device="cpu"))
    shape = {"data": 2, "model": 2}
    back = {k: torch.full_like(t, float("nan")) for k, t in whole.items()}
    for mesh in _ranks(shape):
        ctx = rules.make_context(mesh)
        got = _flatten(api.init_params(cfg, 5, device="cpu", ctx=ctx))
        sh = _flatten(api.rank_shardings(cfg, ctx))
        for k, t in got.items():
            assert torch.equal(t, sh[k].local_block(whole[k])), k
            index = []
            for i in range(t.dim()):
                idx, cnt = sh[k]._block(i, t.dim())
                n = whole[k].shape[i] // cnt
                index.append(slice(idx * n, (idx + 1) * n))
            back[k][tuple(index)] = t
    for k, t in whole.items():
        assert torch.equal(back[k], t), k


class _ThreadGroups:
    """``all_reduce`` over a stub mesh's lines for one thread a rank: a
    call waits for every rank's and returns the sum over the ranks whose
    group is its own."""

    def __init__(self, n: int):
        self.barrier = threading.Barrier(n)
        self.slots = [None] * n
        self.local = threading.local()

    def all_reduce(self, x, op="sum", group=None):
        self.slots[self.local.rank] = (group, x.detach())
        self.barrier.wait()
        out = sum(y for g, y in self.slots if g == group)
        self.barrier.wait()
        return out


class _ThreadGathers:
    """``gather_from_group`` over a stub mesh's lines for one thread a
    rank (no autograd): the blocks of the ranks whose group is this one's,
    concatenated in rank order. ``calls`` counts a rank's gathers."""

    def __init__(self, n: int):
        self.barrier = threading.Barrier(n)
        self.slots = [None] * n
        self.local = threading.local()
        self.calls = [0] * n

    def gather_from_group(self, x, dim, group):
        r = self.local.rank
        self.calls[r] += 1
        self.slots[r] = (group, x.detach())
        self.barrier.wait()
        out = torch.cat([y for g, y in self.slots if g == group], dim)
        self.barrier.wait()
        return out


def _on_threads(n, fn):
    out = [None] * n
    errors = []

    def run(r):
        try:
            out[r] = fn(r)
        except BaseException as e:  # surfaced below
            errors.append(e)
            raise

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors
    return out


def test_the_clip_norm_sums_each_leaf_over_its_axes(monkeypatch):
    """On every rank of 2 x 2 under FSDP (blocks over the model axis, the
    data axis or both), the clip's norm is the whole tree's."""
    cfg = configs.get_smoke("qwen2-1.5b")
    grads = api.init_params(cfg, 2, device="cpu")
    want = adamw.global_norm(grads)
    meshes = _ranks({"data": 2, "model": 2})
    fake = _ThreadGroups(len(meshes))
    monkeypatch.setattr(adamw, "collectives", fake)
    shardings = api.rank_shardings(cfg, rules.make_context(meshes[0]))
    split = adamw.tree_map(lambda sh: sh.axes, shardings)
    kinds = {sh.axes for sh in _flatten(shardings).values()}
    assert {("data",), ("data", "model")} <= kinds, kinds

    def rank(r):
        fake.local.rank = r
        ctx = rules.make_context(meshes[r])
        return adamw.global_norm(api.shard_params(grads, cfg, ctx), split,
                                 meshes[r].group)

    for got in _on_threads(len(meshes), rank):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


def test_the_batch_mean_of_data_blocks_on_a_pod_mesh(monkeypatch):
    """With every rank's rows giving the same gradient g, the batch mean is
    g: a leaf whole over the data axis is all-reduced over the batch
    group; a data block (which the gather's backward summed over the data
    group already) is summed over the pod group and divided by the batch
    ranks."""
    cfg = configs.get_smoke("qwen2-1.5b")
    mesh = _Mesh({"pod": 2, "data": 2, "model": 1})
    ctx = rules.make_context(mesh)
    assert ctx.batch_axes == ("pod", "data")
    ranks = {("pod", "data"): 4, ("pod",): 2}
    seen = []

    def all_reduce(x, op="sum", group=None):
        seen.append(group[0])
        return x * ranks[group[0]]

    monkeypatch.setattr(step_mod.collectives, "all_reduce", all_reduce)
    g = api.init_params(cfg, 3, device="cpu", ctx=ctx)
    # The norms as if whole over the data axis, the rest data blocks.
    split = {k: "norm" not in k for k in _flatten(g)}
    split = adamw.tree_map(lambda _, k: split[k], g, _paths(g))
    summed = adamw.tree_map(lambda t, d: t * 2 if d else t, g, split)
    m, got = step_mod._batch_mean({"loss": torch.tensor(1.5)}, summed, ctx,
                                  split)
    assert float(m["loss"]) == pytest.approx(1.5)
    for k, t in _flatten(got).items():
        torch.testing.assert_close(t, _flatten(g)[k], rtol=1e-6, atol=0)
    assert set(seen) == set(ranks)


def _paths(tree, prefix=""):
    """A tree of each leaf's ``_flatten`` key."""
    if isinstance(tree, dict):
        return {k: _paths(v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_paths(v, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return prefix[:-1]


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "internvl2-1b"])
def test_prefill_and_packed_prefill_gather_each_leaf_where_used(
        arch, monkeypatch):
    """On the two data ranks of a 2 x 1 mesh, a prefill and a packed
    prefill from the ranks' blocks give the whole parameters' logits
    exactly: each layer's blocks gathered once a pass, ``embed`` for the
    lookup and again for a tied head, the final norm once, and the
    prefill's ``vit_proj``."""
    cfg = configs.get_smoke(arch)
    whole = api.init_params(cfg, 4, device="cpu")
    rng = np.random.default_rng(6)
    tokens = torch.from_numpy(rng.integers(2, cfg.vocab_size, (1, 9)))
    batch = {"tokens": tokens}
    if api.is_vlm(cfg):
        batch["patch_embeds"] = rng.standard_normal(
            (1, 3, 1024)).astype(np.float32)
    layout = ((0, 5), (0, 4))

    def run(p, ctx):
        with torch.no_grad():
            logits, _ = api.prefill(p, cfg, batch, 16, ctx=ctx)
            states = [T.make_caches(cfg, 1, 16, torch.float32,
                                    device="cpu") for _ in layout]
            packed, _ = api.prefill_packed(p, cfg, tokens, states, layout,
                                           ctx=ctx)
        return logits, packed

    want = run(whole, None)
    meshes = _ranks({"data": 2, "model": 1})
    fake = _ThreadGathers(len(meshes))
    monkeypatch.setattr(T, "collectives", fake)

    def rank(r):
        fake.local.rank = r
        ctx = rules.make_context(meshes[r])
        return run(api.shard_params(whole, cfg, ctx), ctx)

    for got in _on_threads(len(meshes), rank):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    sh = _flatten(api.rank_shardings(cfg, rules.make_context(meshes[0])))
    layer = sum("data" in s_.axes for k, s_ in sh.items()
                if k.startswith("layers/"))
    # Each pass: the layers, embed (twice when tied), the final norm; the
    # prefill also projects the patches (vit_proj's two leaves).
    per_pass = layer + 2 + cfg.tie_embeddings
    assert fake.calls == [2 * per_pass + 2 * api.is_vlm(cfg)] * 2


def test_a_packed_prefill_refuses_a_tensor_parallel_ctx():
    cfg = configs.get_smoke("qwen2-1.5b")
    ctx = rules.make_context(_Mesh({"data": 1, "model": 2}))
    params = api.init_params(cfg, 0, device="cpu", ctx=ctx)
    with pytest.raises(NotImplementedError):
        T.forward_packed(params, cfg, torch.zeros((1, 4), dtype=torch.long),
                         [T.make_caches(cfg, 1, 8, torch.float32,
                                        device="cpu")], ((0, 4),), ctx=ctx)


# -- the dry run ---------------------------------------------------------------

def test_the_count_of_an_fsdp_step():
    """The smoke qwen2's 2 x 2 step on a fake group: the same kernel
    launches and kernel FLOPs with FSDP as without; a reduce-scatter for
    each gather in the forward, a second all-gather of each layer leaf in
    the recompute, and half the arguments."""
    cfg = configs.get_smoke("qwen2-1.5b")
    shape = ShapeSpec("fsdp_smoke", 32, 4, "train")
    counts, sizes = {}, {}
    for fsdp in (False, True):
        with dryrun.cell_mesh(local=(2, 2)) as mesh:
            counts[fsdp], sizes[fsdp] = dryrun._compile_step(
                cfg, shape, mesh, microbatches=2, dtype=torch.float32,
                fsdp=fsdp)
    off, on = counts[False], counts[True]
    assert dict(on.launches) == dict(off.launches)
    assert sum(on.kernel_flops.values()) == sum(off.kernel_flops.values())
    kinds = {}
    for kind, _ in on.collectives:
        kinds[kind] = kinds.get(kind, 0) + 1
    assert {k for k, _ in off.collectives} == {"all-reduce"}
    # Per microbatch: each layer leaf gathered in the forward and the
    # recompute; embed twice (lookup, head) and the final norm once.
    layer = sum(1 for k, s in _flatten(api.rank_shardings(
        cfg, rules.make_context(_Mesh({"data": 2, "model": 2})))).items()
        if k.startswith("layers/") and "data" in s.axes)
    assert kinds["reduce-scatter"] == 2 * (layer + 3)
    assert kinds["all-gather"] == 2 * (2 * layer + 3)
    assert on.totals()[2] > off.totals()[2]
    assert on.peak_bytes < off.peak_bytes
    # The parameters and their moments: about a half each, then a quarter.
    assert sizes[True]["argument_bytes"] == pytest.approx(
        sizes[False]["argument_bytes"] / 2, rel=0.01)


def test_param_bytes_sharded_pairs_leaves_by_key():
    """The repair: each leaf's sharding applied to that leaf (each spec as
    long as its leaf's shape), and the bytes pinned."""
    want = {"qwen2-1.5b": 15_016_832, "qwen3-moe-235b-a22b": 1_888_847_296}
    with dryrun.cell_mesh(False) as mesh:
        for arch, n in want.items():
            cfg = configs.get_arch(arch)
            params = api.init_params(cfg, dtype=torch.bfloat16,
                                     device="meta")
            shards = rules.param_shardings(api.param_logical_axes(cfg),
                                           params, mesh)
            assert all(adamw.tree_leaves(rules._map2(
                lambda t, sh: t.dim() == len(sh.spec), params, shards)))
            assert dryrun.param_bytes_sharded(cfg, mesh) == n


def test_shard_shape_refuses_a_spec_longer_than_the_array():
    mesh = _Mesh({"data": 2, "model": 2})
    sh = rules.NamedSharding(mesh, rules.P("model", None, "data"))
    assert sh.shard_shape((4, 6, 8)) == (2, 6, 4)
    with pytest.raises(ValueError):
        sh.shard_shape((4, 8))
    with pytest.raises(ValueError):
        sh.local_block(torch.zeros(4, 8))
    with pytest.raises(ValueError):
        sh.gather(torch.zeros(4, 8))
