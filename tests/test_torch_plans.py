"""The port's tile-plan compiler against the JAX package's.

The port keeps its own copies of the tiling constraints, the GPU cost model,
the autotuner, the tiling policy and the plan artifact. These tests hold
them against the reference on the paper's two modelled GPUs (identical
descriptors and workloads must give identical tiles and scores, to 1e-12
relative), pin what the Hopper estimator adds (shared memory bounds a tile
and the blocks per SM), check that every tile the port would sweep at full
width is one its kernel launches, and round-trip plan artifacts between the
two packages. No card is needed: wall-clock timing of the H100 raises here,
and an analytic compile launches no kernel.
"""
import itertools
import json
import math
import os
import subprocess
import sys
import warnings
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro.kernels  # noqa: E402
from repro.core import GEFORCE_8800GTS as REF_8800  # noqa: E402
from repro.core import GTX260 as REF_GTX260  # noqa: E402
from repro.core import TPU_V5E  # noqa: E402
from repro.core import Autotuner as RefAutotuner  # noqa: E402
from repro.core import TilingPolicy as RefPolicy  # noqa: E402
from repro.core import registry as ref_registry  # noqa: E402
from repro.core import tiling as ref_tiling  # noqa: E402
from repro.core.cost_model import estimate as ref_estimate  # noqa: E402
from repro.core.plans import TilePlan as RefPlan  # noqa: E402
from repro.core.plans import compile_plan as ref_compile  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.core import (  # noqa: E402
    GEFORCE_8800GTS, GTX260, H100_SXM, Autotuner, NoLegalTileError,
    PlanTransferWarning, PlanVersionWarning, TilePlan, TilingPolicy,
    compile_plan, registry,
)
from repro_torch.core import tiling  # noqa: E402
from repro_torch.core.cost_model import TileWorkload, estimate  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.bilinear import ops as bil_ops  # noqa: E402
from repro_torch.kernels.flash_attention import decode as fa_decode  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.matmul import ops as mm_ops  # noqa: E402
from repro_torch.kernels.rglru import ops as rg_ops  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.launch import compile_plans, measure  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SCALES = (2, 4, 6, 8, 10)
PAPER = ((GTX260, REF_GTX260), (GEFORCE_8800GTS, REF_8800))
# The paper's Fig. 3 axis: TileShape is (height, width).
AXIS = list(itertools.product((4, 8, 16, 32), repeat=2))

repro.kernels.register_all()
kernels.register_all()


def _prob(scale):
    return dict(src_h=800, src_w=800, scale=scale)


def _rel(a, b):
    if a == b:                                   # inf == inf included
        return 0.0
    return abs(a - b) / max(abs(b), 1e-300)


# ---------------------------------------------------------------------------
# Constraints, cost model, sweep and policy: identical on the paper's GPUs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rank,max_dims,kw", [
    (2, (1600, 1600), dict(lane_dim=1, sublane_dim=0)),
    (2, (100, 48), dict(lane_dim=None, sublane_dim=None)),
    (3, (600, 1536, 8960), dict(lane_dim=2, sublane_dim=0, mxu_dims=(1,))),
    (1, (4096,), dict(mxu_dims=(0,), lane_dim=0)),
])
def test_enumerate_tiles_matches_the_reference_on_gtx260(rank, max_dims, kw):
    def vmem(t):
        return 4.0 * t.size

    mine = tiling.enumerate_tiles(
        tiling.TileConstraints(rank=rank, max_dims=max_dims, **kw), GTX260,
        "float32", vmem)
    ref = ref_tiling.enumerate_tiles(
        ref_tiling.TileConstraints(rank=rank, max_dims=max_dims, **kw),
        REF_GTX260, "float32", vmem)
    assert mine and [t.dims for t in mine] == [t.dims for t in ref]


@pytest.mark.parametrize("scale", SCALES)
def test_estimate_matches_the_reference_on_bilinear_cuda(scale):
    spec, ref_spec = registry.get("bilinear_cuda"), ref_registry.get("bilinear_cuda")
    prob = _prob(scale)
    for hw, ref_hw in PAPER:
        for dims in AXIS + [(1, 512), (2, 256), (16, 64), (32, 32)]:
            t, rt = tiling.TileShape(dims), ref_tiling.TileShape(dims)
            c = estimate(hw, spec.workload(t, prob, "float32"),
                         spec.n_tiles(t, prob))
            r = ref_estimate(ref_hw, ref_spec.workload(rt, prob, "float32"),
                             ref_spec.n_tiles(rt, prob))
            for name in ("compute_s", "memory_s", "overhead_s", "total_s",
                         "utilization"):
                assert _rel(getattr(c, name), getattr(r, name)) <= 1e-12, \
                    (hw.name, dims, name)


@pytest.mark.parametrize("scale", SCALES)
def test_fig3_sweep_gives_the_reference_best_tiles_and_sensitivities(scale):
    for hw, ref_hw in PAPER:
        mine = Autotuner().sweep("bilinear_cuda", _prob(scale), "float32", hw,
                                 tiles=[tiling.TileShape(d) for d in AXIS])
        ref = RefAutotuner().sweep(
            "bilinear_cuda", _prob(scale), "float32", ref_hw,
            tiles=[ref_tiling.TileShape(d) for d in AXIS])
        assert mine.best.tile.dims == ref.best.tile.dims
        assert mine.best.tile[1] == 32          # every Fig. 3 winner is 32 wide
        assert _rel(mine.sensitivity(), ref.sensitivity()) <= 1e-12


def test_robust_policy_over_the_paper_gpus_gives_the_32x4_principle():
    pol = TilingPolicy(mode="robust", fleet=(GTX260, GEFORCE_8800GTS))
    ref = RefPolicy(mode="robust", fleet=(REF_GTX260, REF_8800))
    for scale in SCALES:
        t = pol.tile_for("bilinear_cuda", _prob(scale), "float32")
        assert t.dims == ref.tile_for("bilinear_cuda", _prob(scale),
                                      "float32").dims
        assert t[1] >= 32 and t[0] <= 8      # wide, shallow
    # §V: on the paper's axis, 32x4 (W x H) is within 10% of the best tile
    # on the worst-case GPU at every scale.
    spec = registry.get("bilinear_cuda")
    t = tiling.TileShape((4, 32))
    for scale in SCALES:
        best = Autotuner().sweep(
            "bilinear_cuda", _prob(scale), "float32", GEFORCE_8800GTS,
            tiles=[tiling.TileShape(d) for d in AXIS]).best.score
        cost = estimate(GEFORCE_8800GTS, spec.workload(t, _prob(scale), "float32"),
                        spec.n_tiles(t, _prob(scale))).total_s
        assert cost <= 1.10 * best, scale


def test_tuned_and_heuristic_policies_and_the_autotuner_cache(tmp_path):
    prob = _prob(6)
    cache = str(tmp_path / "cache.json")
    at = Autotuner(cache_path=cache)
    tuned = TilingPolicy(mode="tuned", hardware=GTX260, autotuner=at)
    best = tuned.tile_for("bilinear_cuda", prob, "float32")
    assert best == Autotuner().sweep("bilinear_cuda", prob, "float32",
                                     GTX260).best.tile
    assert at.sweep_count == 1
    again = Autotuner(cache_path=cache)            # read back from disk
    assert again.best_tile("bilinear_cuda", prob, "float32", GTX260) == best
    assert again.sweep_count == 0
    # Heuristic: the plan's tile where it has the cell, the Hopper default
    # where it has none.
    plan = compile_plan([("bilinear", prob, "float32", H100_SXM)])
    pol = TilingPolicy(mode="heuristic", plans=plan)
    assert pol.tile_for("bilinear", prob, "float32") == plan.entries()[0].tile
    bare = TilingPolicy(mode="heuristic")
    assert bare.tile_for("bilinear", prob, "float32").dims == (4, 32)
    assert tiling.grid_for((1600, 1601), tiling.TileShape((4, 32))) == (400, 51)
    assert tiling.padded_extent(1601, 32) == 1632


# ---------------------------------------------------------------------------
# The Hopper estimator
# ---------------------------------------------------------------------------

def test_h100_estimator_bounds_tiles_and_blocks_by_shared_memory():
    work = TileWorkload(flops=1e6, hbm_bytes=1e5, row_segments=1,
                        row_stride_bytes=4096.0, threads=256)
    limit = H100_SXM.vmem_bytes
    assert limit == 232_448 and H100_SXM.smem_per_sm == 233_472
    assert math.isinf(estimate(H100_SXM, work, 1000, vmem_bytes=limit + 1).total_s)
    assert math.isfinite(estimate(H100_SXM, work, 1000, vmem_bytes=limit).total_s)
    # Threads alone allow 8 blocks of 256 per SM; shared memory allows
    # 233472 // vmem of them.
    for vmem, blocks in ((0, 8), (40_000, 5), (100_000, 2), (200_000, 1)):
        c = estimate(H100_SXM, work, 132 * 8, vmem_bytes=vmem)
        assert c.utilization == pytest.approx(blocks * 256 / 2048)
    # Fewer resident blocks, more waves, more time.
    times = [estimate(H100_SXM, work, 132 * 8, vmem_bytes=v).total_s
             for v in (0, 100_000, 200_000)]
    assert times == sorted(times) and times[0] < times[-1]
    with pytest.raises(ValueError):
        estimate(H100_SXM, TileWorkload(1.0, 1.0, 1, 1.0), 1)


def _full_width_cells():
    jobs, _ = compile_plans.build_jobs(
        compile_plans.DEFAULT_ARCHS, ["h100_sxm"], ["float32", "bfloat16"],
        serve_buckets=(512,), serve_slots=4, serve_max_len=1024)
    return jobs


def _launchable(kernel, tile, problem):
    """Raise unless the kernel's wrapper takes ``tile`` for ``problem``."""
    if kernel == "matmul":
        assert tuple(tile) in mm_ops.COMPILED_TILES
    elif kernel == "flash_attention":
        fa.launch_tile(tile, problem["sq"], problem["skv"], problem["d"])
    elif kernel == "flash_decode":
        fa_decode.launch_bkv(tile[0], problem["skv"], problem["d"],
                             problem["hq"] // problem["hkv"])
    elif kernel == "bilinear":
        bil_ops.launch_tile(tile, problem)
    elif kernel == "ssd":
        ssd_ops.launch_chunk(tile[0], problem)
    elif kernel == "rglru":
        rg_ops.launch_tile(tile, problem)
    else:
        raise AssertionError(kernel)


def test_every_candidate_the_port_sweeps_at_full_width_launches():
    seen = set()
    for kernel, problem, dtype, hw in _full_width_cells():
        spec = registry.get(kernel)
        tiles = tiling.enumerate_tiles(
            spec.constraints(problem), hw, dtype,
            lambda t: spec.vmem_bytes(t, problem, dtype), max_candidates=256)
        assert tiles, (kernel, problem, dtype)
        for t in tiles:
            _launchable(kernel, t, problem)
            cost = estimate(hw, spec.workload(t, problem, dtype),
                            spec.n_tiles(t, problem),
                            vmem_bytes=spec.vmem_bytes(t, problem, dtype))
            assert math.isfinite(cost.total_s), (kernel, problem, t)
        _launchable(kernel, spec.default_tile(problem, dtype), problem)
        seen.add(kernel)
    assert seen == {"matmul", "flash_attention", "flash_decode", "bilinear",
                    "ssd", "rglru"}


def test_attention_at_head_dim_256_has_launchable_tiles():
    # recurrentgemma-9b: Hq 16, Hkv 1, head_dim 256, window 2048.
    assert fa.bq_max(256) == 64 and fa.bq_max(128) == 128
    assert fa.launch_tile((64, 64), 4096, 4096, 256) == (64, 64)
    for bad in ((128, 32), (64, 128)):
        with pytest.raises(ValueError):
            fa.launch_tile(bad, 4096, 4096, 256)
    prob = dict(b=1, skv=2048, d=256, hq=16, hkv=1, window=2048)
    bkv = registry.get("flash_decode").default_tile(prob, "float32")[0]
    assert fa_decode.launch_bkv(bkv, 2048, 256, 16) == 64
    with pytest.raises(ValueError):
        fa_decode.launch_bkv(128, 2048, 256, 16)


# ---------------------------------------------------------------------------
# Plan artifacts between the two packages
# ---------------------------------------------------------------------------

def _small_jobs():
    jobs, _ = compile_plans.build_jobs(
        ["qwen2-1.5b"], ["h100_sxm", "gtx260", "geforce_8800gts"],
        ["float32"], serve_buckets=(64,), serve_max_len=128)
    return jobs


def test_analytic_compile_round_trips_through_the_reference(tmp_path):
    launches = dict(build.LAUNCHES)
    plan = compile_plan(_small_jobs(), autotuner=Autotuner(),
                        meta={"by": "test"})
    assert build.LAUNCHES == launches           # analytic: nothing launched
    assert plan.meta["skipped_jobs"] == 0
    assert set(plan.hardware_names()) == {"h100_sxm", "gtx260",
                                          "geforce_8800gts"}
    assert {"bilinear", "bilinear_cuda", "matmul", "flash_attention",
            "flash_decode"} <= set(plan.kernels())
    assert not any(e.measured for e in plan.entries())
    path = str(tmp_path / "port.json")
    plan.save(path)
    ref = RefPlan.load(path)
    assert len(ref) == len(plan)
    for e in plan.entries():
        r = ref.lookup(e.kernel, e.problem_dict, e.dtype, e.hardware)
        assert r is not None and r.tile.dims == e.tile.dims
        assert r.score_s == e.score_s and r.curve == e.curve
    # The paper's kernel on the paper's GPUs: the same model, the same plan.
    ref_jobs = [("bilinear_cuda", _prob(s), "float32", hw)
                for s in SCALES for hw in (REF_GTX260, REF_8800)]
    ref_plan = ref_compile(ref_jobs, autotuner=RefAutotuner())
    for e in ref_plan.entries():
        mine = plan.lookup(e.kernel, e.problem_dict, e.dtype, e.hardware)
        assert mine.tile.dims == e.tile.dims
        assert _rel(mine.score_s, e.score_s) <= 1e-12


def test_a_reference_artifact_loads_in_the_port(tmp_path):
    jobs = ([("bilinear_cuda", _prob(s), "float32", hw)
             for s in SCALES for hw in (REF_GTX260, REF_8800)]
            + [("matmul", dict(m=512, k=1536, n=8960), "bfloat16", TPU_V5E)])
    ref_plan = ref_compile(jobs, autotuner=RefAutotuner())
    path = str(tmp_path / "ref.json")
    ref_plan.save(path)
    plan = TilePlan.load(path)
    assert len(plan) == len(ref_plan)
    for e in ref_plan.entries():
        mine = plan.lookup(e.kernel, e.problem_dict, e.dtype, e.hardware)
        assert mine is not None and mine.tile.dims == e.tile.dims
        assert not mine.measured
    res = plan.resolve("bilinear_cuda", _prob(6), "float32", "gtx260")
    assert res.source == "exact"
    # Older schemas load with a warning; unknown ones degrade to no plan.
    art = json.loads(Path(path).read_text())
    with pytest.warns(PlanVersionWarning):
        assert len(TilePlan.from_dict(dict(art, schema_version=2))) == len(plan)
    Path(path).write_text(json.dumps(dict(art, schema_version=99)))
    assert TilePlan.load_or_none(path) is None
    # A shape the artifact lacks resolves to the nearest one on the same GPU.
    res = plan.resolve("bilinear_cuda", _prob(7), "float32", "gtx260")
    assert res.source == "nearest_shape"


def test_cross_hardware_resolution_among_the_ports_descriptors():
    plan = compile_plan([("bilinear_cuda", _prob(8), "float32", GTX260)])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = plan.resolve("bilinear_cuda", _prob(8), "float32",
                           "geforce_8800gts")
    assert res.source == "cross_hardware" and res.donor_hardware == "gtx260"
    assert any(issubclass(w.category, PlanTransferWarning) for w in caught)


# ---------------------------------------------------------------------------
# No fallback that hides the card or a kernel
# ---------------------------------------------------------------------------

def test_wallclock_timing_of_the_h100_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    prob = _prob(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        measure.make_measure_fn("bilinear", prob, "float32", H100_SXM)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        measure.make_cell_timer("bilinear", prob, "float32", H100_SXM)
    assert measure.make_measure_fn("bilinear_cuda", prob, "float32",
                                   GTX260) is None
    timer = measure.make_cell_timer("bilinear_cuda", prob, "float32", GTX260)
    assert math.isfinite(timer((4, 32)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compile_plan([("bilinear", prob, "float32", H100_SXM)],
                     measure_fn_factory=measure.make_measure_fn)


def test_compile_skips_only_cells_without_a_legal_tile():
    # No chunk of an SSD head this wide fits a block's shared memory.
    wide = dict(s=64, h=1, p=256, n=256)
    plan = compile_plan([("ssd", wide, "float32", H100_SXM),
                         ("ssd", dict(s=64, h=1, p=8, n=8), "float32",
                          H100_SXM)])
    assert plan.meta["skipped_jobs"] == 1 and len(plan) == 1
    with pytest.raises(NoLegalTileError):
        Autotuner().sweep("ssd", wide, "float32", H100_SXM)

    def broken(kernel, problem, dtype, hw):
        def fail(tile):
            raise RuntimeError("kernel launch failed")
        return fail

    with pytest.raises(RuntimeError, match="launch failed"):
        compile_plan([("bilinear", _prob(2), "float32", H100_SXM)],
                     measure_fn_factory=broken)
    with pytest.raises(KeyError):
        compile_plan([("kv_page", dict(skv=64, d=16, hkv=1), "float32",
                       H100_SXM)])


def test_measured_times_outrank_the_model_and_mark_the_entry():
    times = {}

    def factory(kernel, problem, dtype, hw):
        # A fake card on which the model's worst candidates are fastest.
        def fn(tile):
            times[tuple(tile)] = 1.0 / tile.size
            return times[tuple(tile)]
        return fn

    plan = compile_plan([("bilinear", _prob(2), "float32", H100_SXM)],
                        measure_fn_factory=factory)
    (entry,) = plan.entries()
    assert entry.measured and plan.meta["measured_jobs"] == 1
    assert len(times) == 8                       # the model's best 8 timed
    assert entry.tile.dims == max(times, key=lambda d: 1.0 / times[d])
    assert entry.score_s == min(times.values())


def test_measured_report_and_artifact_reuse(tmp_path, capsys):
    # A fake card on which the model's fifth-best tile is fastest.
    def factory(kernel, problem, dtype, hw):
        if hw.name != "h100_sxm":
            return None
        ranked = sorted(Autotuner().sweep(kernel, problem, dtype, hw).entries,
                        key=lambda e: e.cost.total_s)
        fastest = ranked[4].tile
        return lambda tile: 1e-3 if tile == fastest else 2e-3

    plan = compile_plan([("bilinear", _prob(4), "float32", H100_SXM),
                         ("bilinear_cuda", _prob(4), "float32", GTX260)],
                        measure_fn_factory=factory)
    (row,) = compile_plans.measured_report(plan)
    assert row["kernel"] == "bilinear" and row["timed"] == 8
    assert row["model_best_s"] == 2e-3 and row["measured_best_s"] == 1e-3
    assert row["model_best"] != row["measured_best"] and row["spread"] == 2.0
    path = str(tmp_path / "m.json")
    plan.save(path)
    compile_plans.print_report(path)
    out = capsys.readouterr().out
    assert f"model best {row['model_best']} (2.0000 ms)" in out
    assert f"measured best {row['measured_best']} (1.0000 ms)" in out
    cells = [("bilinear", _prob(4))]
    assert compile_plans.load_or_compile_cells(
        path, cells, ["h100_sxm"], print_fn=lambda m: None) is not None
    fresh = compile_plans.load_or_compile_cells(
        path, [("bilinear", _prob(6))], ["h100_sxm"], print_fn=lambda m: None)
    assert fresh.lookup("bilinear", _prob(6), "float32", "h100_sxm") is not None


def test_compile_plans_cli_names_the_unported_kernels(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    out = tmp_path / "plans.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.compile_plans",
         "--measure", "analytic", "--hardware", "h100_sxm", "--out", str(out)],
        capture_output=True, text=True, env=env, timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert "not ported yet, cells left out: kv_page" in proc.stdout
    art = json.loads(out.read_text())
    kinds = {e["kernel"] for e in art["entries"]}
    assert {"bilinear", "ssd", "rglru", "matmul", "flash_attention",
            "flash_decode"} == kinds
    assert {e["hardware"] for e in art["entries"]} == {"h100_sxm"}
    assert art["meta"]["unported_kernels"] == ["kv_page"]
    assert art["meta"]["skipped_jobs"] == 0
    if not torch.cuda.is_available():
        # Wall-clock timing, asked for or by default (h100_sxm is the
        # default target), needs the card.
        for measure in (["--measure", "wallclock"], []):
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.compile_plans",
                 *measure, "--archs", "mamba2-2.7b",
                 "--out", str(tmp_path / "w.json")],
                capture_output=True, text=True, env=env, timeout=300,
                cwd=tmp_path)
            assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    # Only the modelled GPUs: nothing to time, so the model scores by default.
    modelled = compile_plans.main(["--hardware", "gtx260", "--archs",
                                   "mamba2-2.7b", "--out",
                                   str(tmp_path / "m.json")])
    art = json.loads(Path(modelled).read_text())
    assert art["meta"]["measure"] == "analytic"
    assert {e["kernel"] for e in art["entries"]} == {"bilinear_cuda"}
