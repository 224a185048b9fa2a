"""The paper's empirical claims through the port's cost model
(``tests/test_paper_claims.py`` on the port's GTX260 and 8800 GTS
descriptors), and the port's Fig. 3 optima against the JAX package's.

Each test pins one claim from the paper (section references inline); the
last holds the port's best tile per scale (2-10) on each of the paper's
GPUs equal to the reference's, with the same score.
"""
import itertools

import pytest

torch = pytest.importorskip("torch")

import repro.kernels.bilinear.ops  # noqa: E402,F401  (registers bilinear_cuda)
from repro.core import Autotuner as JaxAutotuner  # noqa: E402
from repro.core import HARDWARE_REGISTRY as JAX_HARDWARE  # noqa: E402
from repro.core.tiling import TileShape as JaxTileShape  # noqa: E402
from repro_torch.core import (GEFORCE_8800GTS, GTX260, Autotuner,  # noqa: E402
                              TilingPolicy, registry)
from repro_torch.core.cost_model import estimate  # noqa: E402
from repro_torch.core.tiling import TileShape  # noqa: E402
from repro_torch.kernels import register_all  # noqa: E402

register_all()

# The paper's sweep axis (Fig. 3): CUDA (x=width, y=height); TileShape is
# (height, width).
SWEEP = [TileShape((h, w)) for h, w in itertools.product((4, 8, 16, 32),
                                                         repeat=2)]
AT = Autotuner()


def _prob(scale):
    return dict(src_h=800, src_w=800, scale=scale)


def _cost(hw, prob, tile):
    spec = registry.get("bilinear_cuda")
    return estimate(hw, spec.workload(tile, prob, "float32"),
                    spec.n_tiles(tile, prob), 0.0).total_s


def test_central_claim_optima_differ_across_models():
    """§IV/§V: the best tile on one GPU model is not the best on another."""
    diffs = 0
    for scale in (2, 4, 6, 8, 10):
        b1 = AT.sweep("bilinear_cuda", _prob(scale), "float32", GTX260,
                      tiles=SWEEP).best.tile
        b2 = AT.sweep("bilinear_cuda", _prob(scale), "float32",
                      GEFORCE_8800GTS, tiles=SWEEP).best.tile
        diffs += b1 != b2
    assert diffs >= 1


def test_fig4_wide_beats_tall():
    """Fig. 4: at fixed thread count, row-major-wide tiles win (both GPUs)."""
    prob = _prob(8)
    for hw in (GTX260, GEFORCE_8800GTS):
        assert _cost(hw, prob, TileShape((4, 8))) < \
            _cost(hw, prob, TileShape((8, 4)))
        assert _cost(hw, prob, TileShape((4, 32))) < \
            _cost(hw, prob, TileShape((32, 4)))


def test_sensitivity_higher_on_smaller_gpu_at_large_scales():
    """§IV.C: fewer cores => more tile-shape sensitivity (scales >= 6)."""
    for scale in (6, 8):
        s1 = AT.sweep("bilinear_cuda", _prob(scale), "float32", GTX260,
                      tiles=SWEEP).sensitivity()
        s2 = AT.sweep("bilinear_cuda", _prob(scale), "float32",
                      GEFORCE_8800GTS, tiles=SWEEP).sensitivity()
        assert s2 > s1


def test_occupancy_cliff_512_thread_tiles():
    """§III.B: a 32x16 tile fills GTX260 (2x512 active) but leaves the
    8800GTS at 512/768 — its relative cost vs the best tile is worse there."""
    prob = _prob(4)
    t = TileShape((16, 32))  # 512 threads
    rel_gtx = _cost(GTX260, prob, t) / AT.sweep(
        "bilinear_cuda", prob, "float32", GTX260, tiles=SWEEP).best.score
    rel_8800 = _cost(GEFORCE_8800GTS, prob, t) / AT.sweep(
        "bilinear_cuda", prob, "float32", GEFORCE_8800GTS,
        tiles=SWEEP).best.score
    assert rel_8800 > rel_gtx


def test_32x4_robust_choice():
    """§V conclusion: 32x4 is within ~10% of optimal on the worst-case GPU
    at every scale, and the robust policy picks a 32-wide small-height tile."""
    for scale in (2, 4, 6, 8, 10):
        best = AT.sweep("bilinear_cuda", _prob(scale), "float32",
                        GEFORCE_8800GTS, tiles=SWEEP).best.score
        c = _cost(GEFORCE_8800GTS, _prob(scale), TileShape((4, 32)))
        assert c <= 1.10 * best, scale

    pol = TilingPolicy(mode="robust", fleet=(GTX260, GEFORCE_8800GTS))
    t = pol.tile_for("bilinear_cuda", _prob(8), "float32")
    assert t[1] >= 32 and t[0] <= 8


@pytest.mark.parametrize("scale", range(2, 11))
@pytest.mark.parametrize("hw", [GTX260, GEFORCE_8800GTS],
                         ids=lambda hw: hw.name)
def test_best_tile_per_scale_equals_the_jax_packages(hw, scale):
    """The Fig. 3 sweep's winner at every scale, and its score, are the
    reference's on the same descriptor."""
    ours = AT.sweep("bilinear_cuda", _prob(scale), "float32", hw,
                    tiles=SWEEP).best
    theirs = JaxAutotuner().sweep(
        "bilinear_cuda", _prob(scale), "float32", JAX_HARDWARE[hw.name],
        tiles=[JaxTileShape(tuple(t.dims)) for t in SWEEP]).best
    assert tuple(ours.tile.dims) == tuple(theirs.tile.dims)
    assert ours.score == theirs.score
