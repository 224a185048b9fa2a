"""The port's int8 gradient compression (``repro_torch/optim/compression.py``)
against the reference's (``tests/test_optim.py:64-88``): ``_quantize`` on
the same numpy input (``q`` exactly, ``scale`` within 1e-7 relative), the
dequantization error bound, and the 20-round error-feedback case at world
size 1 — a one-rank gloo group in this process — round by round against
the reference's ``compress_psum`` under a one-device ``shard_map``. The
two-rank case runs with the mesh suite (``tests/test_torch_mesh.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import compression as jax_compression  # noqa: E402
from repro_torch.distributed.process_group import (  # noqa: E402
    init_process_group,
)
from repro_torch.optim import compression  # noqa: E402


@pytest.fixture
def one_rank(tmp_path):
    import torch.distributed as dist

    init_process_group("gloo", 0, 1, tmp_path / "store", timeout_s=60)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(256) * 10.0 ** -seed).astype(np.float32)
    q, scale = compression._quantize(torch.from_numpy(x))
    qj, sj = jax_compression._quantize(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    assert abs(float(scale) - float(sj)) <= 1e-7 * abs(float(sj))


def test_quantize_dequantize_error_bounded():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(256)
                         .astype(np.float32))
    q, scale = compression._quantize(x)
    err = (q.float() * scale - x).abs()
    assert float(err.max()) <= float(scale) * 0.5 + 1e-6


def test_error_feedback_accumulates_residual(one_rank):
    """EF keeps the quantization residual, so the running sum tracks the
    true one within 3 scales; every round equals the reference's."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as JP

    mesh = jax.make_mesh((1,), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    g_np = (np.random.default_rng(1).standard_normal(64) * 1e-3).astype(
        np.float32)
    g = {"w": torch.from_numpy(g_np)}
    e = compression.init_error(g)
    gj = {"w": jnp.asarray(g_np)}
    ej = jax_compression.init_error(gj)

    def f(gg, ee):
        return jax_compression.compress_psum(gg, ee, ("data",))

    fj = jax.jit(shard_map(f, mesh=mesh, in_specs=(JP(), JP()),
                           out_specs=(JP(), JP()), check_vma=False))
    scale = np.abs(g_np).max() / 127.0
    total_true = np.zeros(64)
    total_deq = np.zeros(64)
    for _ in range(20):
        out, e = compression.compress_psum(g, e)
        outj, ej = fj(gj, ej)
        np.testing.assert_allclose(out["w"].numpy(), np.asarray(outj["w"]),
                                   rtol=1e-6, atol=1e-12)
        # The residual x - q * scale cancels: XLA's fused multiply-add and
        # PyTorch's two roundings differ by ~1e-5 of a scale there.
        np.testing.assert_allclose(e["w"].numpy(), np.asarray(ej["w"]),
                                   rtol=0, atol=1e-4 * scale)
        total_true += g_np
        total_deq += out["w"].numpy()
    assert np.abs(total_true - total_deq).max() <= 3 * scale


def test_compress_psum_keeps_the_tree(one_rank):
    g = {"a": torch.ones(3), "b": [torch.zeros(2, 2), torch.full((4,), 2.0)]}
    out, err = compression.compress_psum(g, compression.init_error(g))
    assert out.keys() == g.keys() and len(out["b"]) == 2
    assert out["b"][0].shape == (2, 2) and err["b"][1].dtype == torch.float32
    np.testing.assert_allclose(out["a"].numpy(), 1.0, rtol=1e-6)
