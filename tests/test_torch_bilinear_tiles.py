"""The bilinear kernel's decomposition, on the CPU.

The CUDA kernel (``csrc/bilinear.cu``) runs a block of (bh, bw) threads,
each writing V pixels of a row (16 bytes: 4 float32, 8 bf16) on R rows
(``ROWS``, 4),
from tables of source positions, with the horizontal lerps of two source
rows held across rows and three source columns a run at scale >= V.
``bilinear_upscale_tiled_ref`` does the same in plain PyTorch; here it must
be bit-equal (``torch.equal``) to the plain image ``bilinear_upscale_ref``
over the paper's 16 Fig. 3 tiles, R = 1, 2, 4, 8, ragged and unaligned widths,
scales 1, 3, 4 and 10, in both dtypes. Then the wrapper's launch rule and
the spec must agree, so that every tile a sweep offers launches. The kernel
itself is held against the plain image on the card by
``tests/test_torch_cuda.py``.
"""
import itertools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import H100_SXM, registry, tiling  # noqa: E402
from repro_torch.kernels.bilinear import ops  # noqa: E402
from repro_torch.kernels.bilinear.ref import (  # noqa: E402
    bilinear_upscale_ref, bilinear_upscale_tiled_ref,
)
from repro_torch.launch.compile_plans import BILINEAR_PROBLEMS  # noqa: E402

FIG3 = list(itertools.product((4, 8, 16, 32), repeat=2))    # (bh, bw)
DTYPES = [torch.float32, torch.bfloat16]
# (h, w): a width no vector divides, one narrower than a thread's run.
IMAGES = [(7, 19), (5, 3)]


def _image(seed, h, w, dtype):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(0.0, 1.0, (h, w)).astype(np.float32)
                            ).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tile", FIG3)
def test_tiled_ref_is_the_plain_image_over_the_fig3_tiles(tile, dtype):
    v = ops.vector_pixels(dtype)
    for (h, w), scale in itertools.product(IMAGES, (1, 3, 4, 10)):
        src = _image(h * w + scale, h, w, dtype)
        want = bilinear_upscale_ref(src, scale)
        got = bilinear_upscale_tiled_ref(src, scale, tile, v, ops.ROWS)
        assert torch.equal(got, want), (tile, (h, w), scale)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows", (1, 2, 4, 8))
@pytest.mark.parametrize("hw,scale,tile", [
    ((13, 9), 10, (3, 5)), ((11, 17), 3, (7, 33)), ((6, 40), 4, (2, 16)),
    ((9, 12), 3, (4, 4)), ((4, 5), 16, (16, 4)), ((8, 6), 1, (1, 64)),
])
def test_tiled_ref_is_the_plain_image_at_every_row_count(dtype, rows, hw,
                                                         scale, tile):
    src = _image(rows, *hw, dtype)
    got = bilinear_upscale_tiled_ref(src, scale, tile, ops.vector_pixels(dtype),
                                     rows)
    assert torch.equal(got, bilinear_upscale_ref(src, scale))


def test_tiled_ref_would_see_a_wrong_column_pair():
    # At scale 10 a 4-pixel run straddles source columns, so reading one
    # pair for the whole run (the three-column shortcut done wrong) differs.
    src = _image(0, 6, 9, torch.float32)
    out = bilinear_upscale_tiled_ref(src, 10, (4, 4), 4, 4)
    x = torch.arange(90, dtype=torch.float64) / 10
    assert (torch.floor(x[8:12]).long() == torch.tensor([0, 0, 1, 1])).all()
    assert torch.equal(out, bilinear_upscale_ref(src, 10))


def test_vector_pixels_and_footprint():
    assert ops.ROWS == 4    # read from the source
    assert ops.vector_pixels(torch.float32) == 4
    assert ops.vector_pixels("bfloat16") == 8
    assert ops.footprint((8, 32), "float32") == (32, 128)
    assert ops.footprint((8, 32), torch.bfloat16) == (32, 256)
    assert ops.smem_bytes((8, 32), "float32") == 4 * (32 + 128)


def test_launch_tile_refuses_what_the_kernel_cannot_launch():
    prob = dict(src_h=800, src_w=800, scale=10)
    for dtype in ("float32", "bfloat16"):
        assert ops.launch_tile((4, 32), prob, dtype) == (4, 32)
    for bad in ((0, 4), (4, 0), (33, 32), (1, 1025)):
        with pytest.raises(ValueError):
            ops.launch_tile(bad, prob)
    # grid.y: 300000 output rows in blocks of bh x 4 rows.
    tall = dict(src_h=300000, src_w=2, scale=1)
    with pytest.raises(ValueError):
        ops.launch_tile((1, 32), tall, "float32")
    assert ops.launch_tile((2, 32), tall, "float32") == (2, 32)
    with pytest.raises(ValueError):
        ops.launch_tile((4, 32), dict(src_h=1 << 22, src_w=2, scale=8))


@pytest.mark.parametrize("prob", BILINEAR_PROBLEMS + [
    dict(src_h=37, src_w=53, scale=3), dict(src_h=5, src_w=3, scale=1)])
def test_every_swept_tile_launches_and_the_spec_counts_its_footprint(prob):
    spec = registry.get("bilinear")
    oh, ow = prob["src_h"] * prob["scale"], prob["src_w"] * prob["scale"]
    cons = spec.constraints(prob)
    # The tile is bounded by the thread grid (float32's footprint).
    assert cons.max_dims == (tiling.cdiv(oh, ops.ROWS), tiling.cdiv(ow, 4))
    tiles = tiling.enumerate_tiles(cons, H100_SXM, "float32",
                                   lambda t: spec.vmem_bytes(t, prob, "float32"),
                                   max_candidates=512)
    assert tiles
    for t in tiles + [spec.default_tile(prob, "float32")]:
        for dtype in ("float32", "bfloat16"):
            assert ops.launch_tile(t, prob, dtype) == tuple(t)
        assert spec.vmem_bytes(t, prob, "float32") == ops.smem_bytes(t, "float32")
        fh, fw = ops.footprint(t, "float32")
        assert spec.n_tiles(t, prob) == tiling.cdiv(oh, fh) * tiling.cdiv(ow, fw)
        work = spec.workload(t, prob, "float32")
        assert work.threads == t[0] * t[1] <= H100_SXM.max_threads_per_block
        assert work.row_segments >= fh
    assert math.isinf(spec.vmem_bytes((64, 32), prob, "float32"))
