"""The port's bilinear upscale against the JAX package's Pallas kernel.

On the CPU the port's ``upscale`` runs its plain PyTorch version (the
paper's four-point gather); these tests hold it against the reference's
``bilinear_upscale`` (separable tent-weight matmuls) run in interpret mode,
on the same numpy-seeded image, with the reference suite's tolerance
(rtol = atol = 1e-5 in float32: the two differ in summation order). Cases:
scale 1 to 10, non-square images and several of the reference's legal
tiles. The CUDA kernel is held against the same plain version on the card
by ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.bilinear.bilinear import bilinear_upscale  # noqa: E402
from repro_torch.core import H100_SXM  # noqa: E402
from repro_torch.kernels.bilinear import ops  # noqa: E402
from repro_torch.kernels.bilinear.ref import bilinear_upscale_ref  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _image(seed, h, w):
    return np.random.default_rng(seed).uniform(0.0, 1.0, (h, w)).astype(np.float32)


@pytest.mark.parametrize("scale", [1, 2, 3, 4, 6, 8, 10])
@pytest.mark.parametrize("hw", [(8, 16), (12, 5)])
def test_upscale_matches_the_pallas_kernel(scale, hw):
    src = _image(scale, *hw)
    oh, ow = hw[0] * scale, hw[1] * scale
    ref = bilinear_upscale(jnp.asarray(src), scale, tile=(oh, ow),
                           interpret=True)
    out = ops.upscale(torch.from_numpy(src), scale)
    assert out.shape == (oh, ow) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("tile", [(8, 32), (16, 16), (32, 64), (64, 128)])
def test_every_reference_tile_gives_the_same_image(tile):
    src = _image(0, 16, 32)
    ref = bilinear_upscale(jnp.asarray(src), 4, tile=tile, interpret=True)
    out = ops.upscale(torch.from_numpy(src), 4, tile=tile)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_bfloat16_image():
    src = _image(1, 16, 16)
    ref = bilinear_upscale(jnp.asarray(src, jnp.bfloat16), 2, tile=(16, 32),
                           interpret=True)
    out = ops.upscale(torch.from_numpy(src).to(torch.bfloat16), 2)
    assert out.dtype == torch.bfloat16
    # The reference suite's bfloat16 tolerance.
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=2e-2, atol=2e-2)


def test_scale_1_is_the_identity_and_edges_replicate():
    src = torch.from_numpy(_image(2, 6, 9))
    assert torch.equal(bilinear_upscale_ref(src, 1), src)
    out = bilinear_upscale_ref(src, 3)
    # The last source row/column is held, not extrapolated.
    assert torch.equal(out[-3:, -1], src[-1, -1].expand(3))


def test_the_hopper_tile_is_a_thread_block():
    prob = dict(src_h=800, src_w=800, scale=4)
    assert ops.launch_tile((4, 32), prob) == (4, 32)
    assert ops.launch_tile((1, 1024), prob) == (1, 1024)
    for bad in ((32, 64), (0, 32)):
        with pytest.raises(ValueError):
            ops.launch_tile(bad, prob)
    assert ops.SPEC.vmem_bytes((32, 64), prob, "float32") == float("inf")
    work = ops.SPEC.workload((4, 32), prob, "float32")
    assert work.threads == 128 and work.threads <= H100_SXM.max_threads_per_block
    assert ops.SPEC.n_tiles((4, 32), prob) == 800 * 100
    with pytest.raises(ValueError):
        ops.upscale(torch.zeros(4), 2)
