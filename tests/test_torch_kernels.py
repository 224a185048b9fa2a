"""The port's kernels: plain PyTorch versions against the JAX Pallas kernels.

On the CPU each wrapper of the port (``mm``, ``flash_attention``,
``flash_decode``) runs its plain PyTorch version; these tests hold it
against the reference's Pallas TPU kernel run in interpret mode, on the same
inputs made from a numpy seed. Cases: GQA 16/2 (qwen2's padded heads),
``q_offset``, ``window``, ``softcap`` and a ``kv_pos`` slot map with ``-1``
(unwritten) slots, plus ragged matmul edges. Tolerance: float32, 1e-5
(both sides accumulate in float32 and differ only in summation order).

The hand-written CUDA kernels themselves are held against the same plain
versions on the card by ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ref as jax_ref  # noqa: E402
from repro.kernels.flash_attention.decode import (  # noqa: E402
    flash_decode as pallas_decode,
)
from repro.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention as pallas_flash,
)
from repro.kernels.matmul.matmul import matmul as pallas_matmul  # noqa: E402
from repro_torch.core.hardware import H100_SXM  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.decode import (  # noqa: E402
    flash_decode, flash_decode_ref,
)
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention,
)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_dense_ref, fit_bkv, flash_attention_ref,
)
from repro_torch.kernels.matmul import ops as mm_ops  # noqa: E402
from repro_torch.kernels.matmul.ref import matmul_ref  # noqa: E402
from repro_torch.launch.specs import kernel_problems  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _qkv(seed, b=1, hq=16, hkv=2, sq=64, skv=64, d=32):
    rng = np.random.default_rng(seed)
    return (_rand(rng, (b, hq, sq, d), 0.3), _rand(rng, (b, hkv, skv, d), 0.3),
            _rand(rng, (b, hkv, skv, d)))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ---------------------------------------------------------------------------
# matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n,tile", [(64, 128, 96, (32, 64, 32)),
                                        (8, 64, 192, (8, 32, 64))])
def test_matmul_plain_vs_pallas(m, k, n, tile):
    rng = np.random.default_rng(0)
    a, b = _rand(rng, (m, k)), _rand(rng, (k, n))
    want = np.asarray(pallas_matmul(jnp.asarray(a), jnp.asarray(b), tile=tile,
                                    interpret=True))
    at, bt = _t(a, b)
    np.testing.assert_allclose(matmul_ref(at, bt).numpy(), want, **TOL)
    np.testing.assert_allclose(mm_ops.mm(at, bt, tile=tile).numpy(), want,
                               **TOL)


@pytest.mark.parametrize("m,k,n", [(1, 70, 33), (5, 130, 257), (67, 9, 200)])
def test_matmul_ragged_edges(m, k, n):
    """Shapes no tile divides: the port takes them (the kernel masks its
    ragged edges) where the Pallas kernel refuses them."""
    rng = np.random.default_rng(1)
    a, b = _rand(rng, (m, k)), _rand(rng, (k, n))
    at, bt = _t(a, b)
    want = a.astype(np.float64) @ b.astype(np.float64)
    np.testing.assert_allclose(mm_ops.mm(at, bt).numpy(), want, **TOL)
    np.testing.assert_allclose(matmul_ref(at, bt).numpy(), want, **TOL)
    with pytest.raises(ValueError):
        pallas_matmul(jnp.asarray(a), jnp.asarray(b), tile=(4, 8, 16),
                      interpret=True)


def test_matmul_bf16_plain_accumulates_in_f32():
    rng = np.random.default_rng(2)
    a, b = _t(_rand(rng, (4, 512)), _rand(rng, (512, 16)))
    out = matmul_ref(a.bfloat16(), b.bfloat16())
    assert out.dtype == torch.bfloat16
    want = a.bfloat16().double() @ b.bfloat16().double()
    np.testing.assert_allclose(out.double().numpy(), want.numpy(), rtol=1e-2,
                               atol=1e-2)


def test_wrappers_refuse_non_cpu_non_cuda_tensors():
    """A wrapper takes its plain version only for CPU tensors. ``meta``
    tensors (the dry run's count) take the card's path up to the launch and
    launch nothing: meta outputs, no launch counted. A call that mixes meta
    and CPU tensors is refused, never computed some other way."""
    from repro_torch.kernels import build

    before = dict(build.LAUNCHES)
    a = torch.empty((4, 8), device="meta")
    b = torch.empty((8, 4), device="meta")
    assert mm_ops.mm(a, b).is_meta
    q = torch.empty((1, 4, 8, 16), device="meta")
    kv = torch.empty((1, 2, 8, 16), device="meta")
    assert flash_attention(q, kv, kv).is_meta
    assert flash_decode(q[:, :, 0].contiguous(), kv, kv, pos=3).is_meta
    assert build.LAUNCHES == before
    with pytest.raises(ValueError):
        mm_ops.mm(a, torch.zeros((8, 4)))
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros((1, 2, 8, 16)), kv)
    with pytest.raises(ValueError):
        flash_decode(q[:, :, 0].contiguous(), kv, torch.zeros((1, 2, 8, 16)),
                     pos=3)


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

ATTN_CASES = [
    dict(),
    dict(window=24),
    dict(softcap=5.0),
    dict(window=40, softcap=20.0),
]


@pytest.mark.parametrize("kw", ATTN_CASES)
def test_flash_attention_plain_vs_pallas_gqa16_2(kw):
    q, k, v = _qkv(3)
    want = np.asarray(pallas_flash(*map(jnp.asarray, (q, k, v)), causal=True,
                                   tile=(32, 32), interpret=True, **kw))
    out = flash_attention(*_t(q, k, v), causal=True, tile=(32, 32), **kw)
    np.testing.assert_allclose(out.numpy(), want, **TOL)
    ref = flash_attention_ref(*_t(q, k, v), causal=True, chunk=16, **kw)
    np.testing.assert_allclose(ref.numpy(), want, **TOL)


@pytest.mark.parametrize("q_offset", [16, 32])
def test_flash_attention_q_offset(q_offset):
    """Chunk continuation: queries start at absolute ``q_offset``."""
    q, k, v = _qkv(4, sq=32, skv=64)
    want = np.asarray(pallas_flash(*map(jnp.asarray, (q, k, v)), causal=True,
                                   q_offset=q_offset, tile=(16, 32),
                                   interpret=True))
    out = flash_attention(*_t(q, k, v), causal=True, q_offset=q_offset,
                          tile=(16, 32))
    np.testing.assert_allclose(out.numpy(), want, **TOL)


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False),
                                dict(causal=True, window=16, softcap=10.0)])
def test_attention_dense_ref_vs_jax(kw):
    q, k, v = _qkv(5, hq=4, hkv=2, sq=48, skv=48, d=16)
    want = np.asarray(jax_ref.attention_dense_ref(*map(jnp.asarray, (q, k, v)),
                                                  **kw))
    out = attention_dense_ref(*_t(q, k, v), **kw)
    np.testing.assert_allclose(out.numpy(), want, **TOL)
    chunked = flash_attention_ref(*_t(q, k, v), chunk=16, **kw)
    np.testing.assert_allclose(chunked.numpy(), want, **TOL)


@pytest.mark.parametrize("bkv,s", [(32, 128), (512, 128), (40, 96), (7, 13),
                                   (512, 600)])
def test_fit_bkv_matches_reference(bkv, s):
    assert fit_bkv(bkv, s) == jax_ref.fit_bkv(bkv, s)


# ---------------------------------------------------------------------------
# flash_decode
# ---------------------------------------------------------------------------

def _ring_kv_pos(s: int, pos: int) -> np.ndarray:
    lo = max(0, pos - s + 1)
    written = np.arange(lo, pos + 1)
    kv_pos = np.full(s, -1, np.int32)
    kv_pos[written % s] = written
    return kv_pos


DECODE_CASES = [
    dict(pos=0),
    dict(pos=77),
    dict(pos=127),
    dict(pos=100, window=48),
    dict(pos=90, softcap=20.0),
    dict(pos=100, window=48, softcap=20.0),
]


@pytest.mark.parametrize("kw", DECODE_CASES)
def test_flash_decode_plain_vs_pallas_gqa16_2(kw):
    q, k, v = _qkv(6, skv=128)
    q = q[:, :, 0]
    want = np.asarray(pallas_decode(*map(jnp.asarray, (q, k, v)), bkv=32,
                                    interpret=True, **kw))
    out = flash_decode(*_t(q, k, v), bkv=32, **kw)
    np.testing.assert_allclose(out.numpy(), want, **TOL)


@pytest.mark.parametrize("kv_pos_kind", ["holes", "ring"])
def test_flash_decode_kv_pos_with_unwritten_slots(kv_pos_kind):
    s = 64
    q, k, v = _qkv(7, skv=s)
    q = q[:, :, 0]
    if kv_pos_kind == "holes":
        pos = 50
        kv_pos = np.arange(s, dtype=np.int32)
        kv_pos[np.random.default_rng(8).random(s) < 0.3] = -1
        kw = dict(pos=pos)
    else:
        pos = 150
        kv_pos = _ring_kv_pos(s, pos)
        kv_pos[:5] = -1          # slots the ring has not reached again
        kw = dict(pos=pos, window=40)
    assert (kv_pos == -1).any()
    want = np.asarray(pallas_decode(*map(jnp.asarray, (q, k, v)),
                                    kv_pos=jnp.asarray(kv_pos), bkv=16,
                                    interpret=True, **kw))
    out = flash_decode(*_t(q, k, v), kv_pos=torch.from_numpy(kv_pos), bkv=16,
                       **kw)
    np.testing.assert_allclose(out.numpy(), want, **TOL)


@pytest.mark.parametrize("bkv", [16, 48, 128])
def test_flash_decode_ref_split_independent(bkv):
    q, k, v = _qkv(9, skv=128)
    q = q[:, :, 0]
    base = flash_decode_ref(*_t(q, k, v), pos=93, bkv=128)
    out = flash_decode_ref(*_t(q, k, v), pos=93, bkv=bkv)
    np.testing.assert_allclose(out.numpy(), base.numpy(), **TOL)


# ---------------------------------------------------------------------------
# Hopper tiles: shared memory, not VMEM, bounds them
# ---------------------------------------------------------------------------

def test_hopper_default_tiles_fit_shared_memory_at_qwen2_width():
    cfg = get_arch("qwen2-1.5b")
    limit = H100_SXM.vmem_bytes
    assert limit == 232_448
    cells = [kernel_problems(cfg, 1, s, "prefill") for s in (16, 600, 4096)]
    cells += [kernel_problems(cfg, b, 1024, "decode") for b in (1, 4)]
    seen = set()
    for problems in cells:
        for name, problem in problems.items():
            spec = {"matmul": mm_ops.SPEC, "flash_attention": fa_ops.FLASH_SPEC,
                    "flash_decode": fa_ops.DECODE_SPEC}.get(name)
            if spec is None:
                continue
            problem = dict(problem, hq=cfg.padded_heads,
                           hkv=cfg.padded_kv_heads) if "hq" in problem \
                else problem
            tile = spec.default_tile(problem, "float32")
            assert spec.vmem_bytes(tile, problem, "float32") <= limit, \
                (name, problem, tile)
            seen.add(name)
    assert seen == {"matmul", "flash_attention", "flash_decode"}
    # The TPU defaults do not fit a Hopper block.
    full = dict(sq=600, skv=600, d=128, hq=16, hkv=2, window=0)
    assert fa_ops.FLASH_SPEC.vmem_bytes((512, 1024), full, "float32") > limit
    assert mm_ops._vmem_bytes((256, 512, 512), dict(m=600, k=1536, n=8960),
                              "float32") > limit


def test_matmul_default_tiles_are_compiled():
    for m in (1, 4, 16, 17, 600):
        assert tuple(mm_ops.default_tile(m, 1536, 8960)) in mm_ops.COMPILED_TILES
