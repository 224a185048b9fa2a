"""The port's SSD and RG-LRU against the JAX package's Pallas kernels.

On the CPU the port's ``ssd`` and ``rglru`` run their plain PyTorch scans;
these tests hold them against the reference's kernels in interpret mode and
its plain references, on the same numpy-seeded inputs, with an initial
state carried across two calls and at S = 1 (the decode cells). Tolerances
are the reference suites': SSD 3e-4 (the chunked dual form reorders the
recurrence's sums), RG-LRU 1e-5 in float32 (the same sequence of float32
multiply-adds). The CUDA kernels are held against the same plain versions
on the card by ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.rglru.ops import rglru as pallas_rglru  # noqa: E402
from repro.kernels.ssd.ops import ssd as pallas_ssd  # noqa: E402
from repro.kernels.ssd.ref import ssd_chunked_ref as jax_chunked  # noqa: E402
from repro.kernels.ssd.ref import ssd_ref as jax_ssd_ref  # noqa: E402
from repro_torch.kernels.rglru import ops as rg  # noqa: E402
from repro_torch.kernels.ssd import ops as sd  # noqa: E402

SSD_TOL = dict(rtol=3e-4, atol=3e-4)
RG_TOL = dict(rtol=1e-5, atol=1e-5)


def _ssd_inputs(seed, b=2, s=32, h=3, p=16, n=8):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        x=rng.standard_normal((b, s, h, p)).astype(f),
        dt=np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(f),
        A=-np.exp(rng.standard_normal(h)).astype(f),
        Bm=(rng.standard_normal((b, s, n)) * 0.5).astype(f),
        C=(rng.standard_normal((b, s, n)) * 0.5).astype(f),
        D=rng.standard_normal(h).astype(f),
        h0=(rng.standard_normal((b, h, n, p)) * 0.5).astype(f))


def _torch(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


def _jax(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_ssd_matches_the_pallas_kernel_and_the_chunked_ref(chunk):
    d = _ssd_inputs(chunk)
    j = _jax(d)
    y_k, h_k = pallas_ssd(j["x"], j["dt"], j["A"], j["Bm"], j["C"], j["D"],
                          h0=j["h0"], chunk=chunk, interpret=True)
    y_c, h_c = jax_chunked(j["x"], j["dt"], j["A"], j["Bm"], j["C"], j["D"],
                           h0=j["h0"], chunk=chunk)
    t = _torch(d)
    y, h = sd.ssd(t["x"], t["dt"], t["A"], t["Bm"], t["C"], t["D"],
                  h0=t["h0"], chunk=chunk)
    for ref_y, ref_h in ((y_k, h_k), (y_c, h_c)):
        _close(y.numpy(), ref_y, SSD_TOL)
        _close(h.numpy(), ref_h, SSD_TOL)
    yc, hc = sd.ssd_chunked_ref(t["x"], t["dt"], t["A"], t["Bm"], t["C"],
                                t["D"], h0=t["h0"], chunk=chunk)
    _close(yc.numpy(), y_c, SSD_TOL)
    _close(hc.numpy(), h_c, SSD_TOL)


def test_ssd_state_carries_across_two_calls_and_ragged_chunks():
    d = _ssd_inputs(7)
    j, t = _jax(d), _torch(d)
    y_full, h_full = jax_ssd_ref(j["x"], j["dt"], j["A"], j["Bm"], j["C"],
                                 j["D"], h0=j["h0"])
    mid = 12
    first = {k: (v[:, :mid] if k in ("x", "dt", "Bm", "C") else v)
             for k, v in t.items()}
    rest = {k: (v[:, mid:] if k in ("x", "dt", "Bm", "C") else v)
            for k, v in t.items()}
    # Chunk 5 divides neither part: the last chunk of each call is ragged.
    y1, h1 = sd.ssd(first["x"], first["dt"], first["A"], first["Bm"],
                    first["C"], first["D"], h0=first["h0"], chunk=5)
    y2, h2 = sd.ssd(rest["x"], rest["dt"], rest["A"], rest["Bm"], rest["C"],
                    rest["D"], h0=h1, chunk=5)
    _close(torch.cat([y1, y2], dim=1).numpy(), y_full, SSD_TOL)
    _close(h2.numpy(), h_full, SSD_TOL)
    y_lit, h_lit = sd.ssd_ref(t["x"], t["dt"], t["A"], t["Bm"], t["C"],
                              t["D"], h0=t["h0"])
    _close(y_lit.numpy(), y_full, SSD_TOL)
    _close(h_lit.numpy(), h_full, SSD_TOL)


def test_ssd_decode_step_s1():
    d = _ssd_inputs(3, s=1)
    j, t = _jax(d), _torch(d)
    y_k, h_k = pallas_ssd(j["x"], j["dt"], j["A"], j["Bm"], j["C"], j["D"],
                          h0=j["h0"], chunk=1, interpret=True)
    y, h = sd.ssd(t["x"], t["dt"], t["A"], t["Bm"], t["C"], t["D"],
                  h0=t["h0"])
    _close(y.numpy(), y_k, SSD_TOL)
    _close(h.numpy(), h_k, SSD_TOL)


def test_ssd_spec_bounds_the_chunk_by_shared_memory():
    # mamba2-2.7b: P 64, N 128. The kernels tile the chunk by 64 rows, so a
    # block's shared memory (104 KB) no longer grows with the chunk: the JAX
    # default 128 launches, up to the 256 steps the cumsum holds; the state
    # width N is what shared memory bounds.
    prob = dict(s=4096, h=80, p=64, n=128)
    assert sd.launch_chunk(64, prob, "float32") == 64
    assert sd.launch_chunk(128, prob, "float32") == 128
    with pytest.raises(ValueError):
        sd.launch_chunk(512, prob, "float32")
    with pytest.raises(ValueError):                 # 552 KB at N = 1024
        sd.launch_chunk(128, dict(prob, n=1024), "float32")
    assert sd.SPEC.default_tile(prob, "float32").dims == (64,)
    assert sd.SPEC.default_tile(prob, "bfloat16").dims == (128,)
    assert sd.SPEC.default_tile(dict(prob, s=1), "float32").dims == (1,)
    assert sd.SPEC.n_tiles((64,), prob) == 80 * 64


def _rg_inputs(seed, b=2, s=24, f=40):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    sig = lambda a: 1.0 / (1.0 + np.exp(-a))  # noqa: E731
    return dict(
        x=rng.standard_normal((b, s, f)).astype(f32),
        r=sig(rng.standard_normal((b, s, f))).astype(f32),
        i=sig(rng.standard_normal((b, s, f))).astype(f32),
        a=rng.standard_normal(f).astype(f32),
        h0=(rng.standard_normal((b, f)) * 0.5).astype(f32))


@pytest.mark.parametrize("s,tile", [(24, (8, 40)), (24, (24, 8)), (1, (1, 40))])
def test_rglru_matches_the_pallas_kernel(s, tile):
    d = _rg_inputs(s, s=s)
    j, t = _jax(d), _torch(d)
    y_k, h_k = pallas_rglru(j["x"], j["r"], j["i"], j["a"], h0=j["h0"],
                            tile=tile, interpret=True)
    y, h = rg.rglru(t["x"], t["r"], t["i"], t["a"], h0=t["h0"], tile=tile)
    _close(y.numpy(), y_k, RG_TOL)
    _close(h.numpy(), h_k, RG_TOL)
    y_r, h_r = rg.rglru_ref(t["x"], t["r"], t["i"], t["a"], h0=t["h0"])
    _close(y_r.numpy(), y_k, RG_TOL)


def test_rglru_state_carries_across_two_calls():
    d = _rg_inputs(5)
    j, t = _jax(d), _torch(d)
    y_k, h_k = pallas_rglru(j["x"], j["r"], j["i"], j["a"], h0=j["h0"],
                            tile=(8, 40), interpret=True)
    cut = lambda v, sl: v[:, sl]  # noqa: E731
    y1, h1 = rg.rglru(cut(t["x"], slice(0, 10)), cut(t["r"], slice(0, 10)),
                      cut(t["i"], slice(0, 10)), t["a"], h0=t["h0"])
    y2, h2 = rg.rglru(cut(t["x"], slice(10, None)), cut(t["r"], slice(10, None)),
                      cut(t["i"], slice(10, None)), t["a"], h0=h1)
    _close(torch.cat([y1, y2], dim=1).numpy(), y_k, RG_TOL)
    _close(h2.numpy(), h_k, RG_TOL)


def test_rglru_spec_tiles_are_thread_blocks():
    prob = dict(s=4096, f=4096)
    assert rg.launch_tile((64, 128), prob) == (64, 128)
    assert rg.launch_tile((64, 1024), prob) == (64, 1024)   # no shared memory
    for bad in ((1, 2048), (0, 128)):   # over 1024 features a block; no steps
        with pytest.raises(ValueError):
            rg.launch_tile(bad, prob)
    # A block a (chunk, feature block): 32 feature blocks x 64 chunks.
    assert rg.SPEC.n_tiles((64, 128), prob) == 32 * 64
    assert rg.SPEC.workload((64, 128), prob, "float32").threads == 32
