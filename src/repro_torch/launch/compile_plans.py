"""Compile the ahead-of-time tile-plan artifact for the H100 (and the paper's
modelled GPUs).

The port's ``repro/launch/compile_plans.py``. Sweeps every registered kernel
across the requested hardware models and the problem families of the
assigned shape set (``repro_torch.configs.shapes.SHAPES``) for each
architecture, plus the paper's bilinear scale family, and writes one
schema-v3 JSON artifact that either package loads:

    PYTHONPATH=src python -m repro_torch.launch.compile_plans --out plans.json
    PYTHONPATH=src python -m repro_torch.launch.compile_plans --measure analytic

``--measure wallclock`` (the default whenever ``h100_sxm`` is a target)
times the analytically best tile candidates of every ``h100_sxm`` cell on
the card (``repro_torch.launch.measure``), and measured times outrank the
model's; without a CUDA device it raises rather than fall back. Cells of
the paper's modelled GPUs (``gtx260``, ``geforce_8800gts``) are always
scored by the cost model. ``--measure analytic`` asks for the cost model
everywhere: it launches nothing and runs on the CPU. After a wall-clock
compile it prints, for every measured cell, the model's best tile against
the measured best (:func:`print_report`, which reads any saved artifact).

Which kernels a descriptor gets: the paper's gather kernel ``bilinear_cuda``
only the modelled GPUs; every kernel the port runs only the H100. Cells of
kernels the port has not ported yet (chunked_prefill, packed_prefill,
kv_page) are left out, and named on stdout and in ``meta["unported_kernels"]``.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch import configs, kernels
from repro_torch.configs import shapes as shape_families
from repro_torch.core import HARDWARE_REGISTRY, MODELLED, Autotuner, registry
from repro_torch.core.plans import PLAN_SCHEMA_VERSION, PlanJob, compile_plan
from repro_torch.launch.specs import cell_problems, kernel_problems

# Representative arch coverage: dense attention, hybrid attention+RG-LRU,
# and pure SSD — together they exercise every ported model kernel.
DEFAULT_ARCHS = ("qwen2-1.5b", "recurrentgemma-9b", "mamba2-2.7b")

# The paper's Fig. 3 sweep family (image kernels are shape-family-independent).
BILINEAR_PROBLEMS = [dict(src_h=800, src_w=800, scale=s) for s in (2, 4, 6, 8, 10)]

Cell = Tuple[str, Dict[str, int]]


def kernel_dtypes(kernel: str, dtypes: Sequence[str]) -> Tuple[str, ...]:
    """The dtypes to compile one kernel's cells for: image kernels run
    float32 only, model kernels the requested list (dtype is part of the
    plan key)."""
    return ("float32",) if kernel.startswith("bilinear") else tuple(dtypes)


def runs_on(kernel: str, hw_name: str) -> bool:
    """The paper's gather kernel is modelled on the paper's GPUs; every
    other kernel is the port's and runs on the H100."""
    return (hw_name in MODELLED) == (kernel == "bilinear_cuda")


def _dedupe(cells: Dict, kernel: str, problem: Dict[str, int]) -> None:
    cells[(kernel, tuple(sorted(problem.items())))] = problem


def serve_bucket_cells(arch_names: Sequence[str], edges: Sequence[int],
                       slots: int, max_len: int) -> List[Cell]:
    """The serving scheduler's shape family as deduped (kernel, problem)
    cells: a (batch=1, seq=edge) prefill cell plus chunked- and
    packed-prefill cells per bucket edge, and the engine's (slots, max_len)
    decode cell, per architecture."""
    cells: Dict = {}
    for arch in arch_names:
        cfg = configs.get_arch(arch)
        for edge in edges:
            for kind in ("prefill", "chunked_prefill", "packed_prefill"):
                for kernel, problem in kernel_problems(cfg, 1, edge, kind).items():
                    _dedupe(cells, kernel, problem)
        for kernel, problem in kernel_problems(cfg, slots, max_len,
                                               "decode").items():
            _dedupe(cells, kernel, problem)
    return [(k, p) for (k, _), p in cells.items()]


def model_cells(arch_names: Sequence[str]) -> List[Cell]:
    """Deduped (kernel, problem) cells of every applicable (arch x shape)."""
    cells: Dict = {}
    for arch in arch_names:
        cfg = configs.get_arch(arch)
        for shape in shape_families.SHAPES:
            if shape_families.applicable(cfg, shape)[0]:
                for kernel, problem in cell_problems(cfg, shape).items():
                    _dedupe(cells, kernel, problem)
    return [(k, p) for (k, _), p in cells.items()]


def build_jobs(arch_names: Sequence[str], hw_names: Sequence[str],
               dtypes: Sequence[str],
               serve_buckets: Sequence[int] = (),
               serve_slots: int = 4,
               serve_max_len: int = 0) -> Tuple[List[PlanJob], List[str]]:
    """Problem families (archs x shapes + paper bilinear + serve buckets) x
    hardware. Returns ``(jobs, unported)``: the jobs, and the kernels whose
    cells were left out because the port has no kernel for them yet."""
    kernels.register_all()
    cells = model_cells(arch_names)
    if serve_buckets:
        cells += serve_bucket_cells(
            arch_names, serve_buckets, serve_slots,
            serve_max_len or max(serve_buckets))
    cells += ([("bilinear", p) for p in BILINEAR_PROBLEMS]
              + [("bilinear_cuda", p) for p in BILINEAR_PROBLEMS])
    known = set(registry.names())
    unported = sorted({k for k, _ in cells if k not in known})

    jobs: List[PlanJob] = []
    seen = set()
    for kernel, problem in cells:
        if kernel not in known:
            continue
        for name in hw_names:
            if not runs_on(kernel, name):
                continue
            for dtype in kernel_dtypes(kernel, dtypes):
                job = (kernel, tuple(sorted(problem.items())), dtype, name)
                if job not in seen:
                    seen.add(job)
                    jobs.append((kernel, problem, dtype, HARDWARE_REGISTRY[name]))
    return jobs, unported


def load_or_compile_cells(plans_path, cells, hw_names: Sequence[str],
                          dtype: str = "float32", meta=None, print_fn=print):
    """Reuse a compiled artifact when it covers ``cells`` on every listed
    hardware model; compile exactly those cells (analytically) otherwise."""
    from repro_torch.core.plans import TilePlan

    kernels.register_all()
    plan = TilePlan.load_or_none(plans_path)
    if plan is not None:
        covered = all(
            plan.lookup(kernel, problem, dtype, hw) is not None
            for kernel, problem in cells for hw in hw_names)
        if covered:
            print_fn(f"# reusing plan artifact {plans_path} "
                     f"({len(plan)} cells)")
            return plan
        print_fn(f"# plan artifact {plans_path} does not cover the "
                 f"requested cells; recompiling")
    jobs = [(kernel, problem, dtype, HARDWARE_REGISTRY[hw])
            for kernel, problem in cells for hw in hw_names]
    return compile_plan(jobs, autotuner=Autotuner(), meta=meta)


def measured_report(plan, top_k: int = 8) -> List[Dict]:
    """Per measured cell of ``plan``: the cost model's best tile and the
    measured best, each with its time on the card, and the spread (slowest
    over fastest) of the ``top_k`` tiles the sweep timed — the model's best
    ``top_k``, recomputed here, whose curve scores are the measured ones."""
    kernels.register_all()
    rows = []
    for e in plan.entries():
        if not e.measured:
            continue
        hw = HARDWARE_REGISTRY[e.hardware]
        sweep = Autotuner().sweep(e.kernel, e.problem_dict, e.dtype, hw)
        timed = sorted(sweep.entries, key=lambda x: x.cost.total_s)[:top_k]
        scores = dict(e.curve)
        times = [scores[t.tile.dims] for t in timed]
        rows.append(dict(kernel=e.kernel, problem=e.problem_dict,
                         dtype=e.dtype, model_best=timed[0].tile,
                         model_best_s=times[0], measured_best=e.tile,
                         measured_best_s=e.score_s,
                         spread=max(times) / min(times), timed=len(times)))
    return rows


def print_report(path: str) -> None:
    """Print :func:`measured_report` of the artifact at ``path``."""
    from repro_torch.core.plans import TilePlan, problem_key

    for r in measured_report(TilePlan.load(path)):
        print(f"{r['kernel']:16s} {problem_key(r['problem']):44s} "
              f"{r['dtype']:8s} model best {r['model_best']} "
              f"({r['model_best_s'] * 1e3:.4f} ms), measured best "
              f"{r['measured_best']} ({r['measured_best_s'] * 1e3:.4f} ms), "
              f"spread {r['spread']:.2f}x over {r['timed']} tiles")


def main(argv: Optional[Sequence[str]] = None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="plans.json",
                    help="artifact path (JSON)")
    ap.add_argument("--hardware", nargs="*", default=["h100_sxm"],
                    choices=sorted(HARDWARE_REGISTRY))
    ap.add_argument("--archs", nargs="*", default=list(DEFAULT_ARCHS),
                    choices=configs.list_archs())
    ap.add_argument("--all-archs", action="store_true",
                    help="cover every architecture, not just the "
                         "representative set")
    ap.add_argument("--dtypes", nargs="*", default=["bfloat16", "float32"])
    ap.add_argument("--max-candidates", type=int, default=256,
                    help="sweep candidates per cell (bounds the curve size)")
    ap.add_argument("--measure", choices=("analytic", "wallclock"),
                    default=None,
                    help="wallclock (the default when h100_sxm is a target): "
                         "time the best candidates of every h100_sxm cell "
                         "on the card, raising without one; analytic: score "
                         "every cell with the cost model, on the CPU")
    args = ap.parse_args(argv)

    if args.all_archs:
        args.archs = configs.list_archs()
    if args.measure is None:
        args.measure = ("wallclock" if "h100_sxm" in args.hardware
                        else "analytic")
    measure_factory = None
    if args.measure == "wallclock":
        from repro_torch.launch.measure import make_measure_fn

        measure_factory = make_measure_fn

    jobs, unported = build_jobs(args.archs, args.hardware, args.dtypes)
    if unported:
        print(f"not ported yet, cells left out: {', '.join(unported)}")
    t0 = time.perf_counter()
    plan = compile_plan(
        jobs,
        autotuner=Autotuner(),
        max_candidates=args.max_candidates,
        measure_fn_factory=measure_factory,
        meta={
            "generated_by": "repro_torch.launch.compile_plans",
            "archs": list(args.archs),
            "dtypes": list(args.dtypes),
            "measure": args.measure,
            "unported_kernels": unported,
        },
    )
    seconds = time.perf_counter() - t0
    plan.save(args.out)
    measured = sum(e.measured for e in plan.entries())
    print(f"schema v{PLAN_SCHEMA_VERSION}: {len(plan)} entries "
          f"({len(jobs)} jobs, {plan.meta['skipped_jobs']} infeasible, "
          f"{measured} measured on the card) in {seconds:.1f} s -> {args.out}")
    print(f"kernels:  {', '.join(plan.kernels())}")
    print(f"hardware: {', '.join(plan.hardware_names())}")
    if measured:
        print_report(args.out)
    return args.out


if __name__ == "__main__":
    main()
