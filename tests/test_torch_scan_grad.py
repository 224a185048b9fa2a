"""The scans' gradients in the port (``kernels/ssd/ops.py:ssd_scan_backward``
and ``kernels/rglru/ops.py:rglru_scan_backward``), on the CPU.

On CUDA tensors under grad, ``ssd_scan`` and ``rglru_scan`` go through
``_SsdScanFn`` / ``_RglruScanFn``, whose backwards run the kernels: for
the SSD the forward kernels in their reversed mode (the time-reversed
adjoint problem read in place, d log_a's dot products in its output
launch) and one ``repro_ssd_bwd`` launch for dB and dC, for the RG-LRU
``repro_rglru_bwd`` (the forward's scan with the reversal in its
indexing). Here the plain versions take the kernels' place:

(a) both backward formulas against ``torch.autograd.grad`` of the plain
    scans, within 1e-5 of each gradient's max |g| (ragged S, a chunk of 1,
    S = 1, non-zero h0 and dh_last, dh_last None); the SSD's plain
    reversed mode (``reverse=True`` of ``ssd_scan_ref``,
    ``ssd_chunk_states_ref`` and ``ssd_scan_bwd_ref``, and
    ``ssd_scan_rev_ref``'s d log_a terms) against the flipped copies it
    replaces;
(b) the whole layers ``ssd`` and ``rglru`` with the Functions routed
    through the plain scans, against ``jax.vjp`` of the JAX package's
    ``ssd_chunked_ref`` and ``rglru_ref`` on the same numpy inputs, within
    ``LAYER_TOL`` x max(1, max |g|): float32 on both sides, summed in
    other orders (the JAX scans carry the state step by step or chunk by
    chunk; the port's backward sums the adjoint over the reversed scan);
(c) the smoke mamba2-2.7b and recurrentgemma-9b ``api.train_loss``
    gradients through the Functions (a monkeypatch here, not a switch in
    the package) against the reference's, at ``check_train_loss``'s
    per-config tolerances.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.rglru.ref import rglru_ref as jax_rglru_ref  # noqa: E402
from repro.kernels.ssd.ref import ssd_chunked_ref as jax_ssd_chunked_ref  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.rglru import ops as rg_ops  # noqa: E402
from repro_torch.kernels.rglru.ref import rglru_scan_ref  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd.ref import (  # noqa: E402
    ssd_chunk_states_ref, ssd_db_dc_ref, ssd_scan_bwd_ref, ssd_scan_ref,
    ssd_scan_rev_ref,
)
from test_torch_train_step import (  # noqa: E402,F401
    check_train_loss, one_torch_thread,
)

SCAN_TOL = 1e-5
LAYER_TOL = 1e-5


def _rel(got, want) -> float:
    """max |got - want| over max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _plain_ssd_scan(log_a, dtx, Bm, C, h0, chunk):
    return (*ssd_scan_ref(log_a, dtx, Bm, C, h0, chunk=chunk),
            ssd_chunk_states_ref(log_a, dtx, Bm, h0, chunk=chunk))


def _plain_rglru_scan(a, x, h0, tile=None):
    return rglru_scan_ref(a, x, h0)


def _ssd_inputs(b, s, h, p, n, seed):
    rng = np.random.default_rng(seed)
    return dict(
        log_a=-np.log1p(np.exp(rng.standard_normal((b, h, s)))) * 0.5,
        dtx=rng.standard_normal((b, s, h, p)),
        Bm=rng.standard_normal((b, s, n)) * 0.5,
        C=rng.standard_normal((b, s, n)) * 0.5,
        h0=rng.standard_normal((b, h, n, p)),
        dy=rng.standard_normal((b, s, h, p)),
        dh_last=rng.standard_normal((b, h, n, p)))


# ---------------------------------------------------------------------------
# (a) The backward formulas against autograd of the plain scans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,chunk,with_dh", [
    (37, 8, True),      # ragged: the reversed chunks fall elsewhere
    (37, 8, False),     # dh_last None
    (16, 1, True),      # a chunk of one step
    (1, 8, True),       # one step
    (24, 64, True),     # one chunk (no chunk states)
    (24, 8, True),      # chunks that divide S
])
def test_ssd_scan_backward_matches_autograd_of_the_plain_scan(s, chunk, with_dh):
    raw = _ssd_inputs(2, s, 3, 4, 5, seed=s + chunk)
    leaves = {k: _t(raw[k]).requires_grad_(True)
              for k in ("log_a", "dtx", "Bm", "C", "h0")}
    y, h_last = ssd_scan_ref(*leaves.values(), chunk=chunk)
    dy, dh = _t(raw["dy"]), _t(raw["dh_last"]) if with_dh else None
    obj = (y * dy).sum() + ((h_last * dh).sum() if with_dh else 0.0)
    want = torch.autograd.grad(obj, list(leaves.values()))

    inputs = {k: v.detach() for k, v in leaves.items()}
    h_in = ssd_chunk_states_ref(inputs["log_a"], inputs["dtx"], inputs["Bm"],
                                inputs["h0"], chunk=chunk)
    got = ssd_ops.ssd_scan_backward(
        *inputs.values(), y.detach(), h_last.detach(), h_in, dy, dh, chunk,
        ssd_scan_rev_ref, ssd_db_dc_ref)
    for name, g, w in zip(inputs, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert _rel(g, w) <= SCAN_TOL, (name, _rel(g, w))


def _flipped(t, dim=1):
    return torch.flip(t, (dim,)).contiguous()


def _flipped_adjoint_problem(raw):
    """The adjoint scan's inputs as flipped copies (the construction the
    reversed mode replaces): log_a' = [0, log_a reversed without its first
    step], dtx' = dy, B' = C, C' = B, each reversed in time."""
    la = _t(raw["log_a"])
    r_la = torch.cat([torch.zeros_like(la[:, :, :1]), _flipped(la[:, :, 1:], 2)],
                     dim=2)
    return (r_la, _flipped(_t(raw["dy"])), _flipped(_t(raw["C"])),
            _flipped(_t(raw["Bm"])), _t(raw["dh_last"]))


@pytest.mark.parametrize("s,chunk", [
    (37, 8),     # ragged: the short reversed chunk lies at forward step 0
    (16, 1),     # a chunk of one step
    (1, 8),      # one step
    (24, 64),    # one chunk
])
def test_ssd_reversed_mode_is_the_scan_on_flipped_copies(s, chunk):
    """The plain reversed mode, reading forward-ordered tensors in place,
    gives the forward scan on flipped copies: y (d dtx) flipped back, the
    final state, the chunk states in the reversed scan's order, dB through
    ``ssd_scan_bwd_ref``, and d log_a's dot products against the flipped
    d dtx."""
    raw = _ssd_inputs(2, s, 3, 4, 5, seed=100 + s + chunk)
    la, dtx, bm, cm, h0, dy, dh = (_t(raw[k]) for k in (
        "log_a", "dtx", "Bm", "C", "h0", "dy", "dh_last"))
    r_la, r_dy, r_b, r_c, _ = _flipped_adjoint_problem(raw)
    y_f, g_f = ssd_scan_ref(r_la, r_dy, r_b, r_c, dh, chunk=chunk)
    states_f = ssd_chunk_states_ref(r_la, r_dy, r_b, dh, chunk=chunk)
    db_f = _flipped(ssd_scan_bwd_ref(r_la, r_dy, r_b, _flipped(dtx), dh,
                                     states_f, chunk))

    y_fwd, _ = ssd_scan_ref(la, dtx, bm, cm, h0, chunk=chunk)
    d_dtx, g0, states, dcum = ssd_scan_rev_ref(la, dy, cm, bm, dh, y_fwd, dtx,
                                               chunk)
    torch.testing.assert_close(d_dtx, _flipped(y_f), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(g0, g_f, rtol=1e-6, atol=1e-6)
    if s <= chunk:
        assert states is None and states_f.shape[2] == 1
    else:
        torch.testing.assert_close(states, states_f, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(
        ssd_chunk_states_ref(la, dy, cm, dh, chunk=chunk, reverse=True),
        states_f, rtol=1e-6, atol=1e-6)
    h_in = ssd_chunk_states_ref(la, dtx, bm, h0, chunk=chunk)
    db, _ = ssd_db_dc_ref(la, dtx, bm, cm, dy, h0, dh, h_in, states, chunk)
    torch.testing.assert_close(db, db_f, rtol=1e-5, atol=1e-5)
    want = ((dy * y_fwd).sum(-1) - (dtx * _flipped(y_f)).sum(-1)).transpose(1, 2)
    assert dcum.shape == (2, 3, s) and dcum.dtype == torch.float32
    torch.testing.assert_close(dcum, want, rtol=1e-5, atol=1e-5)


def test_ssd_chunk_states_are_the_scans_states():
    """The state entering chunk c is the scan's h_last over the first c
    chunks; the first is h0."""
    raw = _ssd_inputs(2, 20, 3, 4, 5, seed=7)
    la, x, bm, c, h0 = (_t(raw[k]) for k in ("log_a", "dtx", "Bm", "C", "h0"))
    states = ssd_chunk_states_ref(la, x, bm, h0, chunk=8)
    assert states.shape == (2, 3, 3, 5, 4)
    torch.testing.assert_close(states[:, :, 0], h0)
    for ci, t in ((1, 8), (2, 16)):
        _, h_t = ssd_scan_ref(la[:, :, :t], x[:, :t], bm[:, :t], c[:, :t], h0,
                              chunk=8)
        torch.testing.assert_close(states[:, :, ci], h_t, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s,with_dh", [(37, True), (37, False), (1, True),
                                       (9, True)])
def test_rglru_scan_backward_matches_autograd_of_the_plain_scan(s, with_dh):
    rng = np.random.default_rng(s)
    b, f = 2, 5
    leaves = [_t(rng.uniform(0.5, 0.99, (b, s, f))).requires_grad_(True),
              _t(rng.standard_normal((b, s, f))).requires_grad_(True),
              _t(rng.standard_normal((b, f))).requires_grad_(True)]
    dy = _t(rng.standard_normal((b, s, f)))
    dh = _t(rng.standard_normal((b, f))) if with_dh else None
    y, h_last = rglru_scan_ref(*leaves)
    obj = (y * dy).sum() + ((h_last * dh).sum() if with_dh else 0.0)
    want = torch.autograd.grad(obj, leaves)
    a, _, h0 = (t.detach() for t in leaves)
    got = rg_ops.rglru_scan_backward(a, y.detach(), h0, dy, dh,
                                     _plain_rglru_scan)
    for name, g, w in zip(("da", "dx", "dh0"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert _rel(g, w) <= SCAN_TOL, (name, _rel(g, w))


# ---------------------------------------------------------------------------
# (b) The layers through the Functions against the JAX package's jax.vjp
# ---------------------------------------------------------------------------

@pytest.fixture
def routed(monkeypatch):
    """``ssd_scan`` and ``rglru_scan`` through their autograd Functions on
    CPU tensors, the plain scans in the kernels' place, launches counted in
    a dict of this test's own."""
    launches = {k: 0 for k in build.LAUNCHES}
    monkeypatch.setattr(build, "LAUNCHES", launches)
    monkeypatch.setattr(ssd_ops, "_ssd_cuda", _plain_ssd_scan)
    monkeypatch.setattr(ssd_ops, "_ssd_rev_cuda", ssd_scan_rev_ref)
    monkeypatch.setattr(ssd_ops, "_ssd_bwd_cuda", ssd_db_dc_ref)
    monkeypatch.setattr(rg_ops, "_rglru_cuda", _plain_rglru_scan)
    monkeypatch.setattr(
        rg_ops, "_rglru_bwd_cuda", lambda a, y, h0, dy, dh: (
            rg_ops.rglru_scan_backward(a, y, h0, dy, dh, _plain_rglru_scan)))

    def ssd_scan(log_a, dtx, Bm, C, h0, chunk=None):
        b, s, h, p = dtx.shape
        if chunk is None:
            chunk = ssd_ops.SPEC.default_tile(
                dict(s=s, h=h, p=p, n=Bm.shape[-1]), str(dtx.dtype))[0]
        return ssd_ops._SsdScanFn.apply(log_a, dtx, Bm, C, h0, chunk)

    def rglru_scan(a, x, h0, tile=None):
        return rg_ops._RglruScanFn.apply(a, x, h0, tile)

    monkeypatch.setattr(ssd_ops, "ssd_scan", ssd_scan)
    monkeypatch.setattr(rg_ops, "rglru_scan", rglru_scan)
    return launches


def _vjp_check(port_fn, jax_fn, args, cots):
    """The port's gradients of sum(out * cot) against jax.vjp's."""
    leaves = [_t(a).requires_grad_(True) for a in args]
    outs = port_fn(*leaves)
    obj = sum((o * _t(c)).sum() for o, c in zip(outs, cots))
    got = torch.autograd.grad(obj, leaves)
    _, vjp = jax.vjp(jax_fn, *(jnp.asarray(a, jnp.float32) for a in args))
    want = vjp(tuple(jnp.asarray(c, jnp.float32) for c in cots))
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.shape == w.shape, i
        err = float(np.abs(g.numpy() - w).max()) / max(1.0, float(np.abs(w).max()))
        assert err <= LAYER_TOL, (i, err)


def test_the_ssd_layer_through_its_function_matches_jax_vjp(routed):
    rng = np.random.default_rng(11)
    b, s, h, p, n, chunk = 2, 32, 3, 4, 6, 8
    args = [rng.standard_normal((b, s, h, p)),                  # x
            np.log1p(np.exp(rng.standard_normal((b, s, h)))) * 0.3,  # dt
            -np.exp(rng.standard_normal(h) * 0.3),              # A
            rng.standard_normal((b, s, n)) * 0.5,               # Bm
            rng.standard_normal((b, s, n)) * 0.5,               # C
            rng.standard_normal(h),                             # D
            rng.standard_normal((b, h, n, p))]                  # h0
    cots = [rng.standard_normal((b, s, h, p)), rng.standard_normal((b, h, n, p))]
    _vjp_check(lambda *a: ssd_ops.ssd(*a[:5], D=a[5], h0=a[6], chunk=chunk),
               lambda *a: jax_ssd_chunked_ref(*a[:5], D=a[5], h0=a[6],
                                              chunk=chunk),
               args, cots)
    assert routed["ssd"] == 1 and routed["ssd_bwd"] == 1


def test_the_rglru_layer_through_its_function_matches_jax_vjp(routed):
    rng = np.random.default_rng(12)
    b, s, f = 2, 23, 6
    args = [rng.standard_normal((b, s, f)),                     # x
            1 / (1 + np.exp(-rng.standard_normal((b, s, f)))),  # r
            1 / (1 + np.exp(-rng.standard_normal((b, s, f)))),  # i
            rng.standard_normal(f),                             # Lambda
            rng.standard_normal((b, f))]                        # h0
    cots = [rng.standard_normal((b, s, f)), rng.standard_normal((b, f))]
    _vjp_check(lambda *a: rg_ops.rglru(*a[:4], h0=a[4]),
               lambda *a: jax_rglru_ref(*a[:4], h0=a[4]), args, cots)
    assert routed["rglru"] == 1 and routed["rglru_bwd"] == 1


# ---------------------------------------------------------------------------
# (c) The smoke recurrent models' training gradients through the Functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,kernel", [("mamba2-2.7b", "ssd"),
                                         ("recurrentgemma-9b", "rglru")])
def test_smoke_train_gradients_through_the_functions_match_the_reference(
        routed, name, kernel):
    check_train_loss(name)
    # One backward a layer; remat runs each layer's forward twice.
    assert routed[f"{kernel}_bwd"] > 0
    assert routed[kernel] == 2 * routed[f"{kernel}_bwd"]


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 17e, rehearsed on the plain versions
# ---------------------------------------------------------------------------

def test_chip_smoke_phase_17e_rehearses_on_the_cpu(capsys):
    """17e's schedule at smoke width on CPU tensors (``device="cpu"``): the
    scans' gradient checks, both models' loss and gradients on the two
    paths and their train steps, with nothing launched."""
    import importlib.util
    from pathlib import Path

    from repro_torch import configs

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_17e", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    out = smoke.recurrent_train_phase(
        False, device="cpu", mamba2=configs.get_smoke("mamba2-2.7b"),
        recurrentgemma=configs.get_smoke("recurrentgemma-9b"), batch=2,
        seq=16)
    assert len(out["grad_checks"]) == 2 * 2 * 2
    assert all(r["launches"] == (0, 0) for r in out["grad_checks"])
    for key, scan in (("mamba2", "ssd"), ("recurrentgemma", "rglru")):
        res = out[key]
        assert res["parity"]["worst_grad_rel"] <= smoke.SCAN_TRAIN_GRAD_TOL
        assert res["steps"]["launches"] == {scan: 0, f"{scan}_bwd": 0}
        assert all(np.isfinite(res["steps"]["losses"]))
    assert len(out["mamba2"]["steps"]["losses"]) == 5
    assert "17e" in capsys.readouterr().out


def _c_params(source: str, name: str):
    """The ctypes type of each parameter of ``extern "C" ... name(...)`` in
    ``csrc/<source>``: a pointer is c_void_p, an int c_int."""
    import ctypes
    import re

    text = (build.CSRC / source).read_text()
    m = re.search(r'extern "C" \w[\w ]*\b' + name + r"\(([^)]*)\)", text)
    assert m, name
    return [ctypes.c_void_p if "*" in p else ctypes.c_int
            for p in m.group(1).split(",")]


@pytest.mark.parametrize("module,binder,source,entry", [
    ("ssd", "_lib", "ssd.cu", "repro_ssd"),
    ("ssd", "_bwd_lib", "ssd.cu", "repro_ssd_bwd"),
    ("ssd", "_bwd_smem_lib", "ssd.cu", "repro_ssd_bwd_smem"),
    ("rglru", "_lib", "rglru.cu", "repro_rglru"),
    ("rglru", "_bwd_lib", "rglru.cu", "repro_rglru_bwd"),
])
def test_scan_bindings_declare_the_c_entry_points_arguments(
        monkeypatch, module, binder, source, entry):
    """Each ctypes binding of the scans' entry points declares one argument
    type a C parameter, in order (ctypes passes extra arguments by default
    conversions, so a short list would cut the stream pointer to an int)."""
    import types

    fake = types.SimpleNamespace(**{entry: types.SimpleNamespace(
        argtypes=None, restype=None)})
    monkeypatch.setattr(build, "load", lambda name: fake)
    ops = ssd_ops if module == "ssd" else rg_ops
    fn = getattr(ops, binder)()
    assert fn.argtypes == _c_params(source, entry)


@pytest.mark.parametrize("b,s,q,dtype,want", [
    (1, 4096, 64, "float32", 80),    # S 4096: 128 blocks, one wave
    (1, 4096, 64, "bfloat16", 80),
    (8, 512, 64, "float32", 80),     # mamba2-2.7b's train shape
    (1, 4001, 64, "float32", 80),    # ragged: the short chunk's tile counts
    (2, 1024, 128, "float32", 40),   # 64 blocks: two groups fill a wave
    (1, 256, 64, "float32", 5),      # 8 blocks: 16 groups fill a wave
])
def test_ssd_backward_heads_a_block(b, s, q, dtype, want):
    """``repro_ssd_bwd``'s heads a block at mamba2-2.7b's width (H 80, P 64,
    N 128): the fewest waves of blocks times (heads a block + 1), the fewer
    groups on a tie. The split fixes the order heads are summed in, so it
    fixes the gradients' bits."""
    assert ssd_ops.bwd_heads_per_block(b, s, q, 80, 128, 64, dtype) == want
