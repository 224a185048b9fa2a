"""The port's dry run (``repro_torch/launch/dryrun.py``), its abstract
inputs (``launch/specs.py``) and its switches (``models/flags.py``) against
the reference's, on the CPU with no card:

* ``abstract_params`` / ``abstract_opt_state`` / ``abstract_serve_state``
  / ``input_specs`` / ``decode_token_spec`` of all ten configs at full
  width: the shapes and dtypes of the reference's ``eval_shape`` trees with
  the stacked layer axis split, every tensor on ``meta``;
* the count against itself: the full depth counted directly equals the
  reference's method, probe differencing, within 1e-9 relative, on a dense
  and a hybrid config; a full-width qwen3-moe-235b-a22b ``decode_32k`` cell
  grows the process by under 1 GB;
* every kernel wrapper on ``meta`` tensors: counted, nothing launched;
* the switches: each one's effect on the CPU plain versions against the
  reference's with the same switch; remat "dots" gradients equal to
  "nothing"'s and to the reference's, with fewer counted ``mm`` launches;
  ``set_perf`` and ``apply_opts`` resetting as the reference's do;
* the CLI: a cell's result, the reference's keys plus
  ``launches_by_kernel`` and ``memory.param_bytes_sharded``, a skipped
  ``long_500k`` with the reference's reason, and a 512-rank cell.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.configs.shapes import get_shape as jax_get_shape  # noqa: E402
from repro.configs.shapes import applicable as jax_applicable  # noqa: E402
from repro.kernels.flash_attention import ref as jax_fa_ref  # noqa: E402
from repro.kernels.ssd import ref as jax_ssd_ref  # noqa: E402
from repro.launch import specs as jax_S  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import flags as jax_flags  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.models import transformer as jax_T  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec, get_shape  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.bilinear.ops import upscale  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.flash_attention.decode import flash_decode  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention,
)
from repro_torch.kernels.rglru.ops import rglru_scan  # noqa: E402
from repro_torch.kernels.ssd import ref as ssd_ref_mod  # noqa: E402
from repro_torch.kernels.ssd.ops import ssd_scan  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.models import api, attention, flags, ssm  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.roofline.count import counting  # noqa: E402
from repro_torch.train.step import make_grad_step  # noqa: E402

ARCHS = configs.list_archs()
SMALL_TRAIN = ShapeSpec("t", 128, 2, "train")
SMALL_PREFILL = ShapeSpec("p", 256, 2, "prefill")


@pytest.fixture(autouse=True)
def defaults():
    """Both packages' switches at their defaults around every test, and
    one torch thread (many small ops)."""
    def reset():
        for f in (flags, jax_flags):
            f.set_perf(attn_bf16=False, remat="nothing", ssd_chunk=0,
                       decode_sharded=False, ssd_bf16=False)
            f.set_analysis_unroll(False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    reset()
    yield
    reset()
    torch.set_num_threads(n)


def _dt(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _port_leaves(tree):
    return [(tuple(t.shape), _dt(t.dtype)) for t in tree_leaves(tree)]


def _unstack(cfg_j, tree):
    """The reference's parameter-shaped ``eval_shape`` tree in the port's
    layout, leaves as (shape, dtype): a scanned segment's (or an
    encoder-decoder stack's) leading layer axis split, layers in order."""
    def leaf(x, stacked):
        shape = tuple(x.shape[1:] if stacked else x.shape)
        return (shape, jnp.dtype(x.dtype).name)

    def walk(node, stacked=False):
        if isinstance(node, dict):
            return {k: walk(v, stacked) for k, v in node.items()}
        return leaf(node, stacked)

    if "dec_layers" in tree:
        out = {k: walk(v) for k, v in tree.items()
               if k not in ("enc_layers", "dec_layers")}
        out["enc_layers"] = [walk(tree["enc_layers"], True)
                             for _ in range(cfg_j.encoder.n_layers)]
        out["dec_layers"] = [walk(tree["dec_layers"], True)
                             for _ in range(cfg_j.n_layers)]
        return out
    layers = []
    for seg, group in zip(jax_T.decompose(cfg_j), tree["segments"]):
        if seg[0] == "seq":
            layers += [walk(lp) for lp in group]
        else:
            _, unit, reps = seg
            layers += [walk(group[u], True) for _ in range(reps)
                       for u in range(len(unit))]
    out = {k: walk(v) for k, v in tree.items() if k != "segments"}
    out["layers"] = layers
    return out


def _shape_tree(tree):
    if isinstance(tree, dict):
        return {k: _shape_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shape_tree(v) for v in tree]
    return (tuple(tree.shape), _dt(tree.dtype))


def _flat_multiset(leaves_with_stack):
    out = []
    for shape, dtype, reps in leaves_with_stack:
        out += [(shape, dtype)] * reps
    return sorted(out)


def _ref_state_leaves(cfg_j, state):
    """The reference's serve state's leaves as (shape, dtype, copies): a
    stacked leaf (a scanned segment's cache, an encoder-decoder's per-layer
    stack) split into one a layer."""
    out = []
    if isinstance(state, dict):                   # encoder-decoder
        for k, v in state.items():
            for x in jax.tree.leaves(v):
                if k == "pos":
                    out.append((tuple(x.shape), jnp.dtype(x.dtype).name, 1))
                else:
                    out.append((tuple(x.shape[1:]), jnp.dtype(x.dtype).name,
                                x.shape[0]))
        return out
    for seg, group in zip(jax_T.decompose(cfg_j), state):
        for x in jax.tree.leaves(group):
            if seg[0] == "seq":
                out.append((tuple(x.shape), jnp.dtype(x.dtype).name, 1))
            else:
                out.append((tuple(x.shape[1:]), jnp.dtype(x.dtype).name,
                            seg[2]))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_inputs_match_the_references(arch):
    """Full width, every config: parameters, AdamW state, a decode cell's
    serve state, batch and token specs, with no tensor off ``meta``."""
    cfg, cfg_j = configs.get_arch(arch), jax_configs.get_arch(arch)
    params = S.abstract_params(cfg, torch.bfloat16)
    ref = jax_S.abstract_params(cfg_j, jnp.bfloat16)
    assert _shape_tree(params) == _unstack(cfg_j, ref)

    opt = S.abstract_opt_state(params, dryrun.OPT_CFG)
    ref_opt = jax_S.abstract_opt_state(ref, jax_adamw.AdamWConfig(
        moment_dtype="bfloat16"))
    for k in ("m", "v"):
        assert _shape_tree(opt[k]) == _unstack(cfg_j, ref_opt[k])
    assert _shape_tree(opt["step"]) == (tuple(ref_opt["step"].shape),
                                        ref_opt["step"].dtype.name)

    for name in ("train_4k", "prefill_32k"):
        shape, shape_j = get_shape(name), jax_get_shape(name)
        got = S.input_specs(cfg, shape)
        want = jax_S.input_specs(cfg_j, shape_j)
        assert {k: _shape_tree(v) for k, v in got.items()} == {
            k: (tuple(v.shape), jnp.dtype(v.dtype).name)
            for k, v in want.items()}
    shape, shape_j = get_shape("decode_32k"), jax_get_shape("decode_32k")
    tok = S.decode_token_spec(cfg, shape)
    ref_tok = jax_S.decode_token_spec(cfg_j, shape_j)
    assert _shape_tree(tok) == (tuple(ref_tok.shape), ref_tok.dtype.name)

    # A serve state of 2 rows (the full 128 is the same tree, larger).
    small, small_j = (dataclasses.replace(shape, global_batch=2),
                      dataclasses.replace(shape_j, global_batch=2))
    state = S.abstract_serve_state(cfg, small, torch.bfloat16, params=params)
    ref_state = jax_S.abstract_serve_state(cfg_j, small_j, jnp.bfloat16,
                                           params=ref)
    assert sorted(_port_leaves(state)) == _flat_multiset(
        _ref_state_leaves(cfg_j, ref_state))

    leaves = [t for tree in (params, opt, got, tok, state)
              for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]
    assert leaves and all(t.is_meta for t in leaves)


# -- the count against itself --------------------------------------------------

@pytest.mark.parametrize("arch,shape", [
    ("qwen2-1.5b", SMALL_TRAIN),           # dense, a train step
    ("recurrentgemma-9b", SMALL_PREFILL),  # hybrid (RG-LRU + local attention)
], ids=["qwen2-train", "recurrentgemma-prefill"])
def test_full_depth_equals_probe_differencing(arch, shape):
    cfg = configs.get_arch(arch)
    with dryrun.cell_mesh(local=(1, 1)) as mesh:
        full = dryrun.exact_cost_terms(cfg, shape, mesh)
        probed = dryrun.probe_cost_terms(cfg, shape, mesh)
    for key in ("flops", "hbm_bytes", "collective_bytes"):
        assert abs(full[key] - probed[key]) <= 1e-9 * max(abs(full[key]), 1.0)
    assert full["flops"] > 0


def _rss() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def test_a_235b_decode_cell_is_counted_without_memory():
    before = _rss()
    res = dryrun.lower_cell("qwen3-moe-235b-a22b", "decode_32k", False,
                            fsdp=False)
    assert res["status"] == "ok", res
    assert _rss() - before < 1e9
    # 235 B bf16 parameters (470 GB), of which rank 0 holds its blocks over
    # 16 model ranks (experts, heads, vocabulary) beside its cache: counted,
    # not held.
    assert 470e9 / 16 < res["memory"]["peak_bytes"] < 60e9
    assert res["memory"]["fits"]
    assert res["memory"]["param_bytes_sharded"] < 40e9
    assert res["launches_by_kernel"]["flash_decode"] == 94


# -- every kernel wrapper on meta ---------------------------------------------

def _m(*shape, dtype=torch.bfloat16, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


def test_every_wrapper_counts_on_meta_and_launches_nothing():
    before = dict(build.LAUNCHES)
    with counting() as c:
        flash_attention(_m(1, 4, 128, 64), _m(1, 2, 128, 64),
                        _m(1, 2, 128, 64))
        flash_decode(_m(2, 4, 64), _m(2, 2, 256, 64), _m(2, 2, 256, 64),
                     pos=100)
        y, h = ssd_scan(_m(1, 4, 96, dtype=torch.float32, grad=True),
                        _m(1, 96, 4, 16, dtype=torch.float32, grad=True),
                        _m(1, 96, 16, dtype=torch.float32, grad=True),
                        _m(1, 96, 16, dtype=torch.float32, grad=True),
                        _m(1, 4, 16, 16, dtype=torch.float32, grad=True))
        (y.sum() + h.sum()).backward()
        y2, h2 = rglru_scan(_m(1, 80, 32, grad=True), _m(1, 80, 32, grad=True),
                            _m(1, 32, grad=True))
        (y2.sum() + h2.sum()).backward()
        out = upscale(_m(16, 16, dtype=torch.float32), 4)
    assert out.shape == (64, 64) and out.is_meta
    assert build.LAUNCHES == before
    assert c.launches == {"flash_attention": 1, "flash_decode": 1, "ssd": 1,
                          "ssd_bwd": 1, "rglru": 1, "rglru_bwd": 1,
                          "bilinear": 1}
    assert all(c.kernel_flops[k] > 0 for k in c.kernel_flops)
    from repro_torch.kernels.flash_attention.flash_attention import flops
    # Causal, bq = bkv = 64 (bf16 at d 64): 3 of the 4 blocks computed.
    tile = (64, 64)
    assert flops(1, 4, 128, 128, 64, tile) == 4.0 * 64 * 4 * 3 * 64 * 64
    with pytest.raises(ValueError):
        flash_attention(_m(1, 4, 128, 64), torch.zeros(1, 2, 128, 64,
                                                       dtype=torch.bfloat16),
                        _m(1, 2, 128, 64))


def test_bf16_switches_take_the_kernels_bf16_modes():
    """On a card (here: meta) the two bf16 switches hand float32 inputs to
    the kernels' bf16 modes: bf16 operands, float32 results."""
    f32 = torch.float32
    flags.set_perf(attn_bf16=True, ssd_bf16=True)
    with counting() as c:
        out = flash_attention(_m(1, 4, 128, 64, dtype=f32),
                              _m(1, 2, 128, 64, dtype=f32),
                              _m(1, 2, 128, 64, dtype=f32))
        y, h = ssd_scan(_m(1, 4, 96, dtype=f32), _m(1, 96, 4, 16, dtype=f32),
                        _m(1, 96, 16, dtype=f32), _m(1, 96, 16, dtype=f32),
                        _m(1, 4, 16, 16, dtype=f32))
    assert out.dtype == y.dtype == h.dtype == f32
    assert c.kernel_bytes["flash_attention"] == 2 * (2 * 4 + 2 * 2) * 128 * 64
    flags.set_perf(attn_bf16=False, ssd_bf16=False)
    with counting() as c32:
        ssd_scan(_m(1, 4, 96, dtype=f32), _m(1, 96, 4, 16, dtype=f32),
                 _m(1, 96, 16, dtype=f32), _m(1, 96, 16, dtype=f32),
                 _m(1, 4, 16, 16, dtype=f32))
    assert c.kernel_bytes["ssd"] < c32.kernel_bytes["ssd"]


# -- the switches ---------------------------------------------------------------

def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_attn_compute_bf16_matches_the_reference(bf16):
    """``ATTN_COMPUTE_BF16`` on the plain attention of bf16 inputs (GQA,
    causal, 3 KV chunks): the port's and the reference's agree within bf16
    rounding with the switch set alike on both sides."""
    r = _rng()
    q, k, v = (r.standard_normal(s).astype(np.float32)
               for s in ((1, 4, 96, 32), (1, 2, 96, 32), (1, 2, 96, 32)))
    flags.set_perf(attn_bf16=bf16)
    jax_flags.set_perf(attn_bf16=bf16)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = fa_ref.flash_attention_ref(tq, tk, tv, chunk=32).float().numpy()
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jax_fa_ref.flash_attention_ref.__wrapped__(
        jq, jk, jv, chunk=32).astype(jnp.float32))
    assert np.abs(got - want).max() <= 1e-2 * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_ssd_compute_bf16_matches_the_reference(bf16):
    r = _rng(1)
    b, s, h, p, n = 1, 64, 2, 8, 8
    x = r.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.abs(r.standard_normal((b, s, h))).astype(np.float32) * 0.1
    A = -np.abs(r.standard_normal(h)).astype(np.float32)
    Bm, C = (r.standard_normal((b, s, n)).astype(np.float32) for _ in "BC")
    flags.set_perf(ssd_bf16=bf16)
    jax_flags.set_perf(ssd_bf16=bf16)
    args = (x, dt, A, Bm, C)
    got, got_h = ssd_ref_mod.ssd_chunked_ref(
        *(torch.from_numpy(a) for a in args), chunk=16)
    want, want_h = jax_ssd_ref.ssd_chunked_ref.__wrapped__(
        *(jnp.asarray(a) for a in args), chunk=16)
    tol = 1e-2 if bf16 else 1e-5
    for a, w in ((got, want), (got_h, want_h)):
        w = np.asarray(w)
        assert np.abs(a.numpy() - w).max() <= tol * max(1.0, np.abs(w).max())


def _layer_params(defs, seed):
    """One layer's parameters from a numpy seed (small normals, the
    ParamDefs' shapes), as the port's tensors and the reference's arrays."""
    r = _rng(seed)
    arrays = {k: (0.1 * r.standard_normal(d.shape)).astype(np.float32)
              for k, d in defs.items()}
    return ({k: torch.from_numpy(v) for k, v in arrays.items()},
            {k: jnp.asarray(v) for k, v in arrays.items()})


def test_chunk_choices_follow_the_references(monkeypatch):
    """The plain attention's KV chunk (512; 2048 under ANALYSIS_UNROLL, cut
    to the 1024 keys here) and the plain SSD chunk (128; SSD_CHUNK; 512
    under ANALYSIS_UNROLL), as each package passes it to its plain
    version."""
    seen = {"port": [], "ref": []}

    def spy(side, fn):
        def wrapped(*args, **kwargs):
            seen[side].append(kwargs["chunk"])
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(attention, "flash_attention_ref",
                        spy("port", attention.flash_attention_ref))
    monkeypatch.setattr(jax_attention, "flash_attention_ref",
                        spy("ref", jax_attention.flash_attention_ref))
    monkeypatch.setattr(ssm, "ssd_chunked_ref",
                        spy("port", ssm.ssd_chunked_ref))
    monkeypatch.setattr(jax_ssm, "ssd_chunked_ref",
                        spy("ref", jax_ssm.ssd_chunked_ref))
    a_cfg = configs.get_smoke("qwen2-1.5b")
    s_cfg = configs.get_smoke("mamba2-2.7b")
    a_layer, a_layer_j = _layer_params(attention.attn_defs(a_cfg), 5)
    s_layer, s_layer_j = _layer_params(ssm.ssm_defs(s_cfg), 6)
    sa, ss = 1024, 1024
    xa = _rng(2).standard_normal((1, sa, a_cfg.d_model)).astype(np.float32)
    xs = _rng(3).standard_normal((1, ss, s_cfg.d_model)).astype(np.float32)
    pos = np.arange(sa)[None]
    expected = []
    for unroll, chunk in ((False, 0), (True, 0), (False, 256)):
        flags.set_analysis_unroll(unroll)
        jax_flags.set_analysis_unroll(unroll)
        flags.set_perf(ssd_chunk=chunk)
        jax_flags.set_perf(ssd_chunk=chunk)
        attention.attn_forward(a_layer, a_cfg, torch.from_numpy(xa),
                               torch.from_numpy(pos), impl="reference")
        jax_attention.attn_forward(a_layer_j, jax_configs.get_smoke(
            "qwen2-1.5b"), jnp.asarray(xa), jnp.asarray(pos))
        ssm.ssm_forward(s_layer, s_cfg, torch.from_numpy(xs),
                        impl="reference")
        jax_ssm.ssm_forward(s_layer_j, jax_configs.get_smoke("mamba2-2.7b"),
                            jnp.asarray(xs))
        expected += [1024 if unroll else 512,
                     chunk or (512 if unroll else 128)]
    assert seen["port"] == seen["ref"] == expected


def test_remat_dots_gradients_and_launches():
    """remat "dots" keeps every ``mm`` output and recomputes the rest: the
    gradients equal "nothing"'s bit for bit and the reference's with its
    "dots" policy within 1e-4; counted on meta, the ``mm`` launches drop by
    the forward products' count."""
    name = "qwen2-1.5b"
    cfg, cfg_j = configs.get_smoke(name), jax_configs.get_smoke(name)
    pj = jax_api.init_params(cfg_j, jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, pj), device="cpu")
    r = _rng(4)
    batch = {k: r.integers(2, cfg.vocab_size, (2, 16)).astype(np.int32)
             for k in ("tokens", "targets")}
    grads = {}
    for policy in ("nothing", "dots"):
        flags.set_perf(remat=policy)
        _, grads[policy] = make_grad_step(cfg)(params, batch)
    for a, b in zip(tree_leaves(grads["nothing"]), tree_leaves(grads["dots"])):
        assert torch.equal(a, b)
    jax_flags.set_perf(remat="dots")
    (_, _), gj = jax.value_and_grad(
        lambda p, b: jax_api.train_loss(p, cfg_j, b, remat=True),
        has_aux=True)(pj, {k: jnp.asarray(v) for k, v in batch.items()})
    want = params_from_jax(cfg, jax.tree.map(np.asarray, gj), device="cpu")
    for a, b in zip(tree_leaves(grads["dots"]), tree_leaves(want)):
        assert float((a - b).abs().max()) <= 1e-4 * max(
            1.0, float(b.abs().max()))

    mp = S.abstract_params(cfg, torch.float32)
    mb = {k: torch.empty((2, 16), dtype=torch.int32, device="meta")
          for k in batch}
    launches = {}
    for policy in ("nothing", "dots"):
        flags.set_perf(remat=policy)
        with counting(live=(mp, mb)) as c:
            make_grad_step(cfg)(mp, mb)
        launches[policy] = c.launches["matmul"]
    with torch.no_grad(), counting() as c:
        api.train_loss(mp, cfg, mb)
    forward = c.launches["matmul"]
    assert forward == 3 * cfg.n_layers
    assert launches["nothing"] - launches["dots"] == forward


def reference_dryrun():
    """The reference's dry-run module. Importing it sets XLA_FLAGS to 512
    host devices; this process's backend is started first, so the flag
    cannot reach it, and the variable is restored, so it reaches no later
    test's subprocess either."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jax_dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jax_dryrun


def test_set_perf_and_apply_opts_reset_as_the_references():
    jax_dryrun = reference_dryrun()
    state = lambda f: (f.ATTN_COMPUTE_BF16, f.REMAT_POLICY, f.SSD_CHUNK,  # noqa: E731
                       f.DECODE_ATTN_SHARDED, f.SSD_COMPUTE_BF16)
    for opts in ("all", "ssd256,ssd_bf16", "remat_dots", ""):
        dryrun.apply_opts(opts)
        jax_dryrun.apply_opts(opts)
        assert state(flags) == state(jax_flags)
    dryrun.apply_opts("ssd_bf16")
    dryrun.apply_opts("")
    # The reference's reset leaves ssd_bf16 as it was; so does the port's.
    assert state(flags) == (False, "nothing", 0, False, True)
    flags.set_perf(remat="dots", ssd_chunk=64)
    assert flags.remat_policy() == "dots" and flags.SSD_CHUNK == 64
    with pytest.raises(AssertionError):
        flags.set_perf(remat="everything")
    assert dryrun.OPT_PRESETS == jax_dryrun.OPT_PRESETS
    flags.set_analysis_unroll(True)
    assert flags.scan_unroll() is True and flags.ANALYSIS_UNROLL


# -- the CLI -------------------------------------------------------------------

def test_cells_through_the_cli(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path)
    dryrun.main(["--arch", "qwen2-1.5b", "--shape", "decode_32k",
                 "--single-pod", "--force"])
    dryrun.main(["--arch", "qwen2-1.5b", "--shape", "long_500k",
                 "--single-pod", "--force"])
    out = capsys.readouterr().out
    assert "decode_32k   single ok" in out and "long_500k    single skipped" in out
    import json
    res = json.loads((tmp_path / "qwen2-1.5b__decode_32k__single.json")
                     .read_text())
    assert set(res) == {"arch", "shape", "mesh", "status", "n_chips",
                        "microbatches", "compile_s", "probe_s", "memory",
                        "roofline", "launches_by_kernel"}
    assert set(res["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "peak_bytes",
                                  "param_bytes_sharded", "hbm_per_chip",
                                  "fits"}
    assert set(res["roofline"]) == {
        "flops_per_chip", "hbm_bytes_per_chip", "collective_bytes_per_chip",
        "compute_s", "memory_s", "collective_s", "dominant",
        "roofline_fraction", "model_flops_global", "useful_flops_ratio"}
    assert res["n_chips"] == 256
    assert res["launches_by_kernel"] == {"flash_decode": 28, "matmul": 84}
    skipped = json.loads((tmp_path / "qwen2-1.5b__long_500k__single.json")
                         .read_text())
    ok, why = jax_applicable(jax_configs.get_arch("qwen2-1.5b"),
                             jax_get_shape("long_500k"))
    assert skipped["status"] == "skipped" and skipped["reason"] == why
    multi = dryrun.lower_cell("qwen2-1.5b", "decode_32k", True)
    assert multi["status"] == "ok" and multi["n_chips"] == 512
    assert not torch.distributed.is_initialized()
