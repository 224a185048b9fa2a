"""The port's sharding rules (``repro_torch/distributed/sharding_rules.py``)
and logical axes against the reference's, with no process group: the
reference's eight ``param_spec`` / ``batch_axes_for`` cases
(``tests/test_sharding.py``) on the port's stub mesh; ``param_spec`` of
every leaf of three full-width configs, as a tuple; the serve state's
shardings; ``param_logical_axes`` of all ten configs; and the blocks a
sharding cuts from a whole tensor.

The reference stacks the layers of a scanned segment (``transformer.
decompose``) and of an encoder-decoder's two stacks on a leading axis
whose logical axis is None; the port keeps one dict a layer. Its axes tree
equals the reference's with that axis taken off (the unstacking
``models/convert.py`` does to the parameters), and its serve state's
per-layer specs equal the reference's with the stacked entry taken off.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.distributed import sharding_rules as jax_rules  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.models import encdec as jax_E  # noqa: E402
from repro.models import transformer as jax_T  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.distributed import sharding_rules as rules  # noqa: E402
from repro_torch.distributed.sharding_rules import (  # noqa: E402
    P, batch_axes_for, param_spec,
)
from repro_torch.models import api, transformer  # noqa: E402
from repro_torch.models.context import DistContext  # noqa: E402


@dataclasses.dataclass
class StubMesh:
    shape: dict
    axis_names: tuple
    coords: dict = None


SINGLE = StubMesh({"data": 16, "model": 16}, ("data", "model"))
MULTI = StubMesh({"pod": 2, "data": 16, "model": 16},
                 ("pod", "data", "model"))
SMALL = StubMesh({"data": 2, "model": 2}, ("data", "model"))
MESHES = {"16x16": SINGLE, "2x16x16": MULTI, "2x2": SMALL}
ALL_ARCHS = jax_configs.list_archs()


# -- the reference's eight cases (tests/test_sharding.py) ---------------------

def test_tp_axes_mapped():
    spec = param_spec(("d_model", "ff"), (4096, 14336), SINGLE, fsdp=False)
    assert spec == P(None, "model")


def test_fsdp_shards_largest_free_axis():
    spec = param_spec(("d_model", "ff"), (4096, 14336), SINGLE, fsdp=True)
    assert spec == P("data", "model")


def test_indivisible_axis_not_sharded():
    # kv_heads=2 < 16: stays replicated on the model axis.
    spec = param_spec(("d_model", "kv_heads", None), (1536, 2, 128), SINGLE,
                      fsdp=False)
    assert spec == P(None, None, None)


def test_vocab_sharding():
    spec = param_spec(("vocab", "d_model"), (153600, 1536), SINGLE, fsdp=True)
    assert spec == P("model", "data")


def test_stacked_layer_dim_never_sharded_by_tp():
    spec = param_spec((None, "d_model", "ff"), (28, 1536, 8960), SINGLE,
                      fsdp=True)
    assert spec[0] is None
    assert spec == P(None, None, "model") or spec == P(None, "data", "model")


def test_experts_sharded():
    spec = param_spec(("experts", "d_model", None), (128, 4096, 1536),
                      SINGLE, fsdp=True)
    assert spec[0] == "model"


def test_batch_axes():
    assert batch_axes_for(SINGLE) == ("data",)
    assert batch_axes_for(MULTI) == ("pod", "data")


def test_small_param_replicated():
    spec = param_spec((None,), (7,), SINGLE, fsdp=True)
    assert spec == P(None)


# -- the port's PartitionSpec and context --------------------------------------

def test_partition_spec_is_the_references_tuple():
    from jax.sharding import PartitionSpec as JP

    for entries in [(), (None,), ("model", None), (("pod", "data"), "model")]:
        assert P(*entries) == tuple(JP(*entries))
        assert isinstance(P(*entries), tuple)


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_spec_for_matches_the_reference(mesh):
    from repro.models.context import DistContext as JaxDistContext

    m = MESHES[mesh]
    port = rules.make_context(_WithGroup(m))
    ref = JaxDistContext(mesh=None, batch_axes=jax_rules.batch_axes_for(m))
    assert port.batch_axes == ref.batch_axes
    for axes in [("batch", None, None), ("batch", None, "vocab"),
                 ("experts", "d_model", None), ("heads", "kv_heads", "ff"),
                 ("seq", "lru", "ssm_heads")]:
        assert port.spec_for(axes) == tuple(ref.spec_for(axes))
    x = torch.ones(2, 3)
    assert port.constrain(x, "batch", None) is x
    assert DistContext().constrain(x, "batch", None) is x


class _WithGroup:
    """A stub mesh that passes ``make_context``'s check."""

    def __init__(self, m):
        self.shape, self.axis_names = m.shape, m.axis_names

    def group(self, axes):
        raise AssertionError("no process group in this test")


# -- full-width configs: every leaf ------------------------------------------

def _ref_leaves(cfg_j):
    axes = jax_api.param_logical_axes(cfg_j)
    shapes = jax.eval_shape(
        lambda: jax_api.init_params(cfg_j, jax.random.PRNGKey(0)))
    is_axes = lambda x: isinstance(x, tuple) and all(  # noqa: E731
        isinstance(e, (str, type(None))) for e in x)
    a = jax.tree.leaves(axes, is_leaf=is_axes)
    s = jax.tree.leaves(shapes)
    assert len(a) == len(s)
    return [(ax, tuple(sd.shape)) for ax, sd in zip(a, s)]


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-moe-16b",
                                  "mamba2-2.7b"])
def test_param_spec_of_every_full_width_leaf(arch):
    """The port's param_spec of each of the reference's leaves (stacked as
    the reference holds them) equals the reference's, on each mesh, with
    and without FSDP; and the port's own shardings of its unstacked tree
    give each leaf the spec of its axes and shape."""
    leaves = _ref_leaves(jax_configs.get_arch(arch))
    for m in MESHES.values():
        for fsdp in (True, False):
            for ax, shape in leaves:
                got = param_spec(ax, shape, m, fsdp)
                want = jax_rules.param_spec(ax, shape, m, fsdp)
                assert isinstance(got, tuple)
                assert got == tuple(want), (arch, ax, shape, got, want)
    cfg = configs.get_arch(arch)
    meta = _meta(transformer.model_defs(cfg))
    sh = rules.param_shardings(api.param_logical_axes(cfg), meta, SINGLE)
    flat_sh, flat_ax, flat_t = (_flat(sh), _flat(api.param_logical_axes(cfg)),
                                _flat(meta))
    assert flat_sh.keys() == flat_t.keys()
    for k, s in flat_sh.items():
        assert s.spec == tuple(jax_rules.param_spec(
            flat_ax[k], tuple(flat_t[k].shape), SINGLE))


def _meta(defs):
    from repro_torch.models.layers import ParamDef

    if isinstance(defs, ParamDef):
        return torch.empty(defs.shape, device="meta")
    if isinstance(defs, dict):
        return {k: _meta(v) for k, v in defs.items()}
    return [_meta(v) for v in defs]


def _flat(tree, prefix=""):
    """Leaves by path; an axes tuple is a leaf."""
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


# -- logical axes of all ten configs -----------------------------------------

def _unstack_axes(cfg_j, tree):
    """The reference's axes tree in the port's layout (``convert.py``'s
    unstacking, on axes tuples): a scanned segment's or a stack's leading
    None taken off, its layers in order."""
    def drop(node):
        if isinstance(node, dict):
            return {k: drop(v) for k, v in node.items()}
        assert node[0] is None
        return tuple(node[1:])

    if "dec_layers" in tree:
        out = {k: v for k, v in tree.items()
               if k not in ("enc_layers", "dec_layers")}
        out["enc_layers"] = [drop(tree["enc_layers"])
                             for _ in range(cfg_j.encoder.n_layers)]
        out["dec_layers"] = [drop(tree["dec_layers"])
                             for _ in range(cfg_j.n_layers)]
        return out
    layers = []
    for seg, group in zip(jax_T.decompose(cfg_j), tree["segments"]):
        if seg[0] == "seq":
            layers += list(group)
        else:
            _, unit, reps = seg
            layers += [drop(group[u]) for _ in range(reps)
                       for u in range(len(unit))]
    out = {k: v for k, v in tree.items() if k != "segments"}
    out["layers"] = layers
    return out


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_logical_axes_of_every_config(arch):
    for get in ("get_smoke", "get_arch"):
        cfg_j = getattr(jax_configs, get)(arch)
        cfg = getattr(configs, get)(arch)
        want = _unstack_axes(cfg_j, jax_api.param_logical_axes(cfg_j))
        assert api.param_logical_axes(cfg) == want
    from repro.models import layers as jax_layers
    from repro_torch.models import layers

    defs_j = jax_T.model_defs(cfg_j) if not jax_api.is_encdec(cfg_j) else None
    if defs_j is not None:
        assert jax_layers.axes_tree(defs_j)["embed"] == \
            layers.axes_tree(transformer.model_defs(cfg))["embed"]


# -- the serve state --------------------------------------------------------

def _ref_encdec_state_specs(cfg_j, b, s, mesh):
    # The reference's whisper state: self_k / self_v [L, B, H, S, hd] and
    # the cross pair, each [L, B, H, S_enc, hd]; per layer as the port's.
    params = jax.eval_shape(lambda: jax_api.init_params(
        cfg_j, jax.random.PRNGKey(0)))
    enc = jax.ShapeDtypeStruct((b, cfg_j.encoder.seq_len, cfg_j.d_model),
                               jnp.float32)
    shapes = jax.eval_shape(lambda p, e: jax_E.make_decode_caches(
        p, cfg_j, e, b, s, jnp.float32), params, enc)
    specs = jax_rules.serve_state_shardings(shapes, mesh)
    n = cfg_j.n_layers
    return {"self_k": [tuple(specs["self_k"])[1:]] * n,
            "self_v": [tuple(specs["self_v"])[1:]] * n,
            "cross": [tuple(tuple(x)[1:] for x in specs["cross"])] * n,
            "pos": tuple(specs["pos"])}


def _ref_state_specs(cfg_j, b, s, mesh, monkeypatch):
    monkeypatch.setattr(jax_rules, "NamedSharding", lambda m, spec: spec)
    if jax_api.is_encdec(cfg_j):
        return _ref_encdec_state_specs(cfg_j, b, s, mesh)
    shapes = jax.eval_shape(lambda: jax_T.make_caches(cfg_j, b, s,
                                                      jnp.float32))
    specs = jax_rules.serve_state_shardings(shapes, mesh)
    # Per layer in order, the stacked entry of a scanned segment dropped.
    out = []
    for seg, group in zip(jax_T.decompose(cfg_j), specs):
        if seg[0] == "seq":
            out += list(group)
        else:
            _, unit, reps = seg
            out += [jax.tree.map(lambda p: tuple(p)[1:], group[u],
                                 is_leaf=lambda x: isinstance(
                                     x, jax.sharding.PartitionSpec))
                    for _ in range(reps) for u in range(len(unit))]
    return out


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-moe-16b",
                                  "mamba2-2.7b", "recurrentgemma-9b",
                                  "gemma2-9b", "whisper-large-v3"])
@pytest.mark.parametrize("mesh", ["16x16", "2x16x16", "2x2"])
def test_serve_state_shardings_match_the_reference(arch, mesh, monkeypatch):
    m = MESHES[mesh]
    cfg_j, cfg = jax_configs.get_arch(arch), configs.get_arch(arch)
    b, s = 32, 4096
    want = _ref_state_specs(cfg_j, b, s, m, monkeypatch)
    if api.is_encdec(cfg):
        enc = torch.empty((b, cfg.encoder.seq_len, cfg.d_model),
                          device="meta")
        state = api.make_serve_state(
            cfg, b, s, torch.float32, device="meta", enc_out=enc,
            params=api.init_params(cfg, device="meta"))
        got = rules.serve_state_shardings(state, m)
        assert set(got) == set(want)
        assert got["pos"].spec == want["pos"] == ()
        for k in ("self_k", "self_v"):
            assert [g.spec for g in got[k]] == want[k], k
        assert [tuple(x.spec for x in pair) for pair in got["cross"]] == \
            want["cross"]
        return
    state = transformer.make_caches(cfg, b, s, torch.float32, device="meta")
    got = rules.serve_state_shardings(state, m)
    assert len(got) == len(want) == cfg.n_layers
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].spec == tuple(w[k]), (arch, k, g[k].spec, w[k])


# -- blocks ------------------------------------------------------------------

@pytest.mark.parametrize("spec", [P("data", "model"), P("model", None),
                                  P(("pod", "data"), None), P(None, "data"),
                                  P()])
def test_local_blocks_tile_the_whole_tensor(spec):
    """Every rank's block, placed at its coordinates, rebuilds the whole
    tensor exactly once (the blocks :func:`unshard_tree` gathers)."""
    shape = {"pod": 2, "data": 2, "model": 2}
    x = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    seen = torch.zeros_like(x)
    for pod in range(2):
        for data in range(2):
            for model in range(2):
                m = StubMesh(shape, ("pod", "data", "model"),
                             {"pod": pod, "data": data, "model": model})
                sh = rules.NamedSharding(m, spec)
                block = sh.local_block(x)
                assert tuple(block.shape) == sh.shard_shape(x.shape)
                # Where the block sits: search its first element.
                r, c = divmod(int(block[0, 0]), 6)
                assert torch.equal(x[r:r + block.shape[0],
                                     c:c + block.shape[1]], block)
                seen[r:r + block.shape[0], c:c + block.shape[1]] += 1
    # Each element is held by the ranks the spec does not name.
    named = {a for e in spec for a in ((e,) if isinstance(e, str) else
                                       (e or ()))}
    copies = int(np.prod([n for a, n in shape.items() if a not in named]))
    assert torch.all(seen == copies)


def test_local_rows_split_the_batch():
    m = StubMesh({"pod": 2, "data": 2, "model": 2}, ("pod", "data", "model"),
                 {"pod": 1, "data": 0, "model": 1})
    ctx = DistContext(mesh=m, batch_axes=("pod", "data"))
    x = np.arange(8)
    assert rules.local_rows(x, ctx).tolist() == [4, 5]
    assert rules.local_rows(x, None) is x
    with pytest.raises(ValueError):
        rules.local_rows(np.arange(6), ctx)
