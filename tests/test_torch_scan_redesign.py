"""The redesigned ssd and rglru scans: what runs before the card does.

The kernels (``csrc/ssd.cu``, ``csrc/rglru.cu``) run only on the card;
their decompositions and launch rules run here and are pinned here:

* ``ssd_scan_split_ref`` (every chunk's own state, a pass carrying the state
  over the chunks, every chunk's output) and ``rglru_scan_chunked_ref``
  (chunk summaries, the carry, a rescan of each chunk) against the JAX
  Pallas kernels in interpret mode, on inputs from a numpy seed: with a
  ragged last chunk, with an initial state carried across two calls, and at
  S = 1. Tolerances: SSD 3e-4 (the chunked dual form reorders the
  recurrence's sums, as the reference suite allows), RG-LRU 1e-5 (the carry
  enters each chunk through a product of up to L decays);
* the ssd products' arithmetic emulated in PyTorch at mamba2-2.7b's head
  (P 64, N 128): 3xTF32 meets the float32 check (2e-5), one TF32 product
  does not; bf16 (float32 operands as two bf16 terms, the scores rounded)
  meets the bf16 check (1e-2);
* the launch rules and KernelSpecs at full width: which chunks and tiles
  launch and are swept, the workspace, the block counts.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.rglru.rglru import rglru_scan as pallas_rglru_scan  # noqa: E402
from repro.kernels.ssd.ssd import ssd_scan as pallas_ssd_scan  # noqa: E402
from repro_torch.core.hardware import H100_SXM  # noqa: E402
from repro_torch.core.tiling import TileShape, enumerate_tiles  # noqa: E402
from repro_torch.kernels.rglru import ops as rg  # noqa: E402
from repro_torch.kernels.ssd import ops as sd  # noqa: E402

SSD_TOL = dict(rtol=3e-4, atol=3e-4)
RG_TOL = dict(rtol=1e-5, atol=1e-5)
MAMBA = dict(h=80, p=64, n=128)          # mamba2-2.7b's SSD head


def _ssd_scan_inputs(seed, b=2, s=32, h=3, p=16, n=8):
    """log_a, dtx, Bm, C, h0 as the layer's discretisation gives them."""
    rng = np.random.default_rng(seed)
    f = np.float32
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(f)
    A = -np.exp(rng.standard_normal(h)).astype(f)
    x = rng.standard_normal((b, s, h, p)).astype(f)
    return dict(
        log_a=np.ascontiguousarray((dt * A).transpose(0, 2, 1)),
        dtx=(dt[..., None] * x).astype(f),
        Bm=(rng.standard_normal((b, s, n)) * 0.5).astype(f),
        C=(rng.standard_normal((b, s, n)) * 0.5).astype(f),
        h0=(rng.standard_normal((b, h, n, p)) * 0.5).astype(f))


def _pallas_ssd(d, chunk):
    y, h = pallas_ssd_scan(*(jnp.asarray(d[k]) for k in
                             ("log_a", "dtx", "Bm", "C", "h0")),
                           chunk=chunk, interpret=True)
    return np.asarray(y), np.asarray(h)


def _split(d, chunk, **kw):
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    y, h = sd.ssd_scan_split_ref(t["log_a"], t["dtx"], t["Bm"], t["C"],
                                 t["h0"], chunk=chunk, **kw)
    return y.numpy(), h.numpy()


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


# ---------------------------------------------------------------------------
# ssd: the three-step decomposition against the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_ssd_split_ref_matches_the_pallas_kernel(chunk):
    d = _ssd_scan_inputs(20 + chunk)
    want_y, want_h = _pallas_ssd(d, chunk)
    y, h = _split(d, chunk)
    _close(y, want_y, SSD_TOL)
    _close(h, want_h, SSD_TOL)


@pytest.mark.parametrize("chunk", [5, 12, 20])
def test_ssd_split_ref_with_a_ragged_last_chunk(chunk):
    # The Pallas kernel takes only chunks that divide S; the function does
    # not depend on the chunk.
    d = _ssd_scan_inputs(30 + chunk)
    want_y, want_h = _pallas_ssd(d, 8)
    y, h = _split(d, chunk)
    _close(y, want_y, SSD_TOL)
    _close(h, want_h, SSD_TOL)


def test_ssd_split_ref_carries_the_state_across_two_calls():
    d = _ssd_scan_inputs(41)
    want_y, want_h = _pallas_ssd(d, 16)
    mid = 13
    first = dict(d, log_a=d["log_a"][..., :mid], dtx=d["dtx"][:, :mid],
                 Bm=d["Bm"][:, :mid], C=d["C"][:, :mid])
    y1, h1 = _split({k: np.ascontiguousarray(v) for k, v in first.items()}, 5)
    rest = dict(log_a=d["log_a"][..., mid:], dtx=d["dtx"][:, mid:],
                Bm=d["Bm"][:, mid:], C=d["C"][:, mid:], h0=h1)
    y2, h2 = _split({k: np.ascontiguousarray(v) for k, v in rest.items()}, 7)
    _close(np.concatenate([y1, y2], axis=1), want_y, SSD_TOL)
    _close(h2, want_h, SSD_TOL)


def test_ssd_split_ref_decode_step_s1():
    d = _ssd_scan_inputs(43, s=1)
    want_y, want_h = _pallas_ssd(d, 1)
    for chunk in (1, 64):
        y, h = _split(d, chunk)
        _close(y, want_y, SSD_TOL)
        _close(h, want_h, SSD_TOL)


def test_ssd_split_ref_agrees_with_the_plain_scan():
    d = _ssd_scan_inputs(44, s=40)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    y_ref, h_ref = sd.ssd_scan_ref(t["log_a"], t["dtx"], t["Bm"], t["C"],
                                   t["h0"], chunk=16)
    y, h = _split(d, 16)
    _close(y, y_ref.numpy(), dict(rtol=1e-5, atol=1e-5))
    _close(h, h_ref.numpy(), dict(rtol=1e-5, atol=1e-5))


# ---------------------------------------------------------------------------
# ssd: the tensor cores' arithmetic at mamba2-2.7b's head
# ---------------------------------------------------------------------------

def _tf32(x):
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero: half an ulp added, the low 13 bits cleared."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def _tf32_truncated(x):
    """What a TF32 mma input keeps of a float32: the low 13 bits dropped."""
    i = x.contiguous().view(torch.int32)
    return (i & -0x2000).view(torch.float32)


def _mm_3xtf32(a, b):
    """The kernels' split (``hopper::split_fast``): hi rounded, lo = x - hi
    passed as it is and truncated by the mma."""
    ahi, bhi = _tf32(a), _tf32(b)
    alo, blo = _tf32_truncated(a - ahi), _tf32_truncated(b - bhi)
    return alo @ bhi + ahi @ blo + ahi @ bhi


def _mm_tf32(a, b):
    return _tf32(a) @ _tf32(b)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _bf16x2(x):
    """x as the bf16 kernels take a float32 operand: hi + lo, both bf16."""
    hi = _bf16(x)
    return hi + _bf16(x - hi)


def _mm_bf16x2(a, b):
    return _bf16x2(a) @ _bf16x2(b)


def _smoke_operands(seed, s=256, h=2, p=64, n=128, dtype=torch.float32):
    """chip_smoke's ssd operands (log_a in [-0.1, 0], dtx ~ 0.05 N(0, 1),
    B, C, h0 ~ N(0, 1)), from a numpy seed."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return [torch.from_numpy(a).to(dtype) for a in (
        -(rng.random((1, h, s)) * 0.1).astype(f),
        (rng.standard_normal((1, s, h, p)) * 0.05).astype(f),
        rng.standard_normal((1, s, n)).astype(f),
        rng.standard_normal((1, s, n)).astype(f),
        rng.standard_normal((1, h, n, p)).astype(f))]


def _rel_err(out, ref):
    return float((out.float() - ref.float()).abs().max()) / max(
        1.0, float(ref.float().abs().max()))


@pytest.mark.parametrize("chunk", [64, 128])
def test_ssd_3xtf32_meets_the_float32_check_and_plain_tf32_does_not(chunk):
    ops_in = _smoke_operands(50 + chunk)
    y_ref, h_ref = sd.ssd_scan_ref(*ops_in, chunk=chunk)
    y3, h3 = sd.ssd_scan_split_ref(*ops_in, chunk=chunk, mm=_mm_3xtf32)
    y1, h1 = sd.ssd_scan_split_ref(*ops_in, chunk=chunk, mm=_mm_tf32)
    want = _pallas_ssd(dict(zip(("log_a", "dtx", "Bm", "C", "h0"),
                                (t.numpy() for t in ops_in))), chunk)
    for ref_y, ref_h in ((y_ref, h_ref),
                         tuple(torch.from_numpy(np.array(w)) for w in want)):
        assert _rel_err(y3, ref_y) <= 2e-5 / 4       # chip_smoke's REL_TOL
        assert _rel_err(h3, ref_h) <= 2e-5 / 4
        assert _rel_err(y1, ref_y) > 2e-5            # why the products split


def test_ssd_bf16_operands_stay_within_the_bf16_check():
    ops_in = _smoke_operands(60, dtype=torch.bfloat16)
    y_ref, h_ref = sd.ssd_scan_ref(*ops_in, chunk=64)
    y, h = sd.ssd_scan_split_ref(*ops_in, chunk=64, mm=_mm_bf16x2,
                                 round_scores=_bf16)
    assert _rel_err(y, y_ref) <= 1e-2 / 2            # chip_smoke's bf16 REL_TOL
    assert _rel_err(h, h_ref) <= 1e-2 / 2


# ---------------------------------------------------------------------------
# ssd: launch rule and KernelSpec at full width
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,smem", [("float32", 106496),   # 2 an SM
                                        ("bfloat16", 62464)])  # 3 an SM
def test_ssd_legal_chunks_at_mamba2_width_include_the_jax_default(dtype, smem):
    prob = dict(MAMBA, s=4096)
    legal = [q for q in (1, 8, 16, 32, 64, 128, 256, 512)
             if math.isfinite(sd.SPEC.vmem_bytes(TileShape((q,)), prob, dtype))]
    assert legal == [1, 8, 16, 32, 64, 128, 256]
    assert sd.launch_chunk(128, prob, dtype) == 128  # the JAX default
    assert sd.smem_bytes(128, dtype) == smem
    # The sweep starts at MIN_SWEPT_CHUNK, and every chunk it holds launches.
    tiles = enumerate_tiles(sd.SPEC.constraints(prob), H100_SXM, dtype,
                            lambda t: sd.SPEC.vmem_bytes(t, prob, dtype))
    assert sorted(t[0] for t in tiles) == [16, 32, 64, 128, 256]
    # One step: the chunk is the sequence, and the sweep is that one chunk.
    one = dict(prob, s=1)
    assert sd.SPEC.vmem_bytes(TileShape((64,)), one, dtype) == float(smem)
    assert [t.dims for t in enumerate_tiles(
        sd.SPEC.constraints(one), H100_SXM, dtype,
        lambda t: sd.SPEC.vmem_bytes(t, one, dtype))] == [(1,)]


@pytest.mark.parametrize("s,q,gib", [(4096, 64, 0.15625), (4096, 256, 0.0390625),
                                     (32768, 64, 1.25), (32768, 16, 5.0),
                                     (1, 1, 0.0)])
def test_ssd_workspace_stays_sane_at_long_sequences(s, q, gib):
    floats = sd.workspace_floats(q, dict(MAMBA, s=s))
    assert floats * 4 / 2**30 == gib


@pytest.mark.parametrize("s,q,blocks", [(4096, 64, 80 * 64),
                                        (4096, 128, 80 * 32 * 2),
                                        (4096, 256, 80 * 16 * 4),
                                        (1, 1, 80), (300, 128, 80 * 3 * 2)])
def test_ssd_n_tiles_count_the_output_blocks(s, q, blocks):
    assert sd.SPEC.n_tiles((q,), dict(MAMBA, s=s)) == blocks


def test_ssd_flops_count_causal_pairs_and_the_ragged_chunk():
    def chunk(ln):      # C B^T and scores . x over ln (ln + 1) / 2 pairs
        return ln * (ln + 1) * (128 + 64) + 4 * ln * 128 * 64

    prob = dict(MAMBA, s=4096)
    assert sd.flops(64, prob) == 80 * 64 * chunk(64)
    assert sd.flops(100, dict(prob, s=250)) == 80 * (2 * chunk(100) + chunk(50))
    assert sd.flops(64, dict(prob, s=1)) == 80 * chunk(1)


def test_ssd_default_chunk_takes_the_wrappers_torch_dtype():
    # ssd_scan asks with str(tensor.dtype), "torch.float32".
    prob = dict(MAMBA, s=4096)
    assert sd.SPEC.default_tile(prob, str(torch.float32)).dims == (64,)
    assert sd.SPEC.default_tile(prob, str(torch.bfloat16)).dims == (128,)


def test_ssd_launch_rule_bounds_chunk_and_width():
    prob = dict(MAMBA, s=4096)
    for bad in (0, 257, 512):
        with pytest.raises(ValueError):
            sd.launch_chunk(bad, prob, "float32")
    with pytest.raises(ValueError):                  # P not a multiple of 8
        sd.launch_chunk(64, dict(prob, p=60), "float32")
    # Shared memory bounds N by dtype: 368 in float32, 544 in bf16.
    for dtype, widest in (("float32", 368), ("bfloat16", 544)):
        assert sd.launch_chunk(64, dict(prob, n=widest), dtype) == 64
        with pytest.raises(ValueError):
            sd.launch_chunk(64, dict(prob, n=widest + 8), dtype)
    work = sd.SPEC.workload((64,), prob, "float32")
    assert work.threads == 128
    # Inputs, outputs and four passes over the chunk states' workspace.
    io = 4096 * (1 + 2 * 64 + 2 * 128) * 4 + 2 * 128 * 64 * 4
    assert work.hbm_bytes * 64 == pytest.approx(io + 16 * 64 * 128 * 64)


# ---------------------------------------------------------------------------
# rglru: the chunked scan against the Pallas kernel
# ---------------------------------------------------------------------------

def _rg_scan_inputs(seed, b=2, s=24, f=40):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(a=rng.random((b, s, f)).astype(f32),
                x=rng.standard_normal((b, s, f)).astype(f32),
                h0=(rng.standard_normal((b, f)) * 0.5).astype(f32))


def _pallas_rg(d, tile):
    y, h = pallas_rglru_scan(*(jnp.asarray(d[k]) for k in ("a", "x", "h0")),
                             tile=tile, interpret=True)
    return np.asarray(y), np.asarray(h)


def _chunked(d, chunk):
    y, h = rg.rglru_scan_chunked_ref(*(torch.from_numpy(d[k])
                                       for k in ("a", "x", "h0")), chunk=chunk)
    return y.numpy(), h.numpy()


@pytest.mark.parametrize("chunk", [1, 5, 8, 24, 64])
def test_rglru_chunked_ref_matches_the_pallas_kernel(chunk):
    d = _rg_scan_inputs(70 + chunk)
    want_y, want_h = _pallas_rg(d, (8, 40))
    y, h = _chunked(d, chunk)
    _close(y, want_y, RG_TOL)
    _close(h, want_h, RG_TOL)


def test_rglru_chunked_ref_carries_the_state_across_two_calls():
    d = _rg_scan_inputs(80)
    want_y, want_h = _pallas_rg(d, (8, 40))
    y1, h1 = _chunked({k: np.ascontiguousarray(v[:, :11] if k != "h0" else v)
                       for k, v in d.items()}, 4)
    y2, h2 = _chunked(dict(a=np.ascontiguousarray(d["a"][:, 11:]),
                           x=np.ascontiguousarray(d["x"][:, 11:]), h0=h1), 6)
    _close(np.concatenate([y1, y2], axis=1), want_y, RG_TOL)
    _close(h2, want_h, RG_TOL)


def test_rglru_chunked_ref_decode_step_s1():
    d = _rg_scan_inputs(81, s=1)
    want_y, want_h = _pallas_rg(d, (1, 40))
    for chunk in (1, 64):
        y, h = _chunked(d, chunk)
        _close(y, want_y, RG_TOL)
        _close(h, want_h, RG_TOL)


# ---------------------------------------------------------------------------
# rglru: launch rule and KernelSpec at full width
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,bf,f,per", [
    ("float32", 256, 4096, 4), ("bfloat16", 256, 4096, 8),
    ("float32", 100, 4096, 4), ("bfloat16", 100, 4096, 1),
    ("float32", 64, 33, 1)])
def test_rglru_features_per_thread_follow_16_byte_loads(dtype, bf, f, per):
    assert rg.features_per_thread(bf, f, dtype) == per


def test_rglru_spec_counts_chunk_blocks_and_needs_no_shared_memory():
    prob = dict(s=4096, f=4096)
    assert rg.SPEC.default_tile(prob, "float32").dims == (32, 128)
    assert rg.SPEC.default_tile(dict(prob, s=1), "bfloat16").dims == (1, 128)
    assert rg.SPEC.n_tiles((64, 256), prob) == 16 * 64
    assert rg.SPEC.n_tiles((64, 256), dict(prob, s=1)) == 16
    assert rg.SPEC.vmem_bytes(TileShape((4096, 1024)), prob, "float32") == 0.0
    assert rg.SPEC.workload((64, 256), prob, "bfloat16").threads == 32
