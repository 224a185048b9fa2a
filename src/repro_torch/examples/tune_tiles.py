"""Autotune every registered kernel for a hardware fleet and dump the cache.

The paper's methodology as an operational tool: run once per hardware
model, ship the cache with the binary. The port's kernels are tuned for
the H100; the paper's two GPUs (modelled by the cost model) tune the
paper's gather kernel (``bilinear_cuda``), the one kernel that runs on
them (``launch.compile_plans.runs_on``).

Run:  PYTHONPATH=src python -m repro_torch.examples.tune_tiles --cache tiles.json

With ``--compile-plans OUT.json`` the same sweep is packaged as a portable,
schema-versioned TilePlan artifact (best tile per hardware + the full
sensitivity curve) instead of a bare cache: the input to
``ServeEngine(plans=...)``. The full compiler with shape-family problems
is ``python -m repro_torch.launch.compile_plans``. The sweep is the cost
model's; ``--device`` only checks that the device asked for is there.
"""
import argparse
import json
import os
import tempfile

from repro_torch import resolve_device
from repro_torch.core import HARDWARE_REGISTRY, Autotuner
from repro_torch.kernels import register_all
from repro_torch.launch.compile_plans import kernel_dtypes, runs_on

PROBLEMS = {
    "matmul": [dict(m=4096, k=4096, n=4096), dict(m=65536, k=4096, n=1536)],
    "flash_attention": [
        dict(sq=4096, skv=4096, d=128, hq=16, hkv=8, window=0),
        dict(sq=32768, skv=32768, d=128, hq=16, hkv=8, window=4096),
    ],
    "rglru": [dict(s=4096, f=4096)],
    "ssd": [dict(s=4096, h=80, p=64, n=128)],
    "bilinear": [dict(src_h=800, src_w=800, scale=s) for s in (2, 6, 10)],
    "bilinear_cuda": [dict(src_h=800, src_w=800, scale=s)
                      for s in (2, 6, 10)],
}


def _jobs(hardware):
    for hw_name in hardware:
        for kernel, problems in PROBLEMS.items():
            if runs_on(kernel, hw_name):
                for prob in problems:
                    yield hw_name, kernel, prob


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cache", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_tiles.json"))
    ap.add_argument("--hardware", nargs="*",
                    default=["h100_sxm", "gtx260", "geforce_8800gts"],
                    choices=sorted(HARDWARE_REGISTRY))
    ap.add_argument("--compile-plans", default=None, metavar="OUT",
                    help="write a portable TilePlan artifact instead of a "
                         "bare autotuner cache")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    register_all()

    if args.compile_plans:
        from repro_torch.core.plans import PLAN_SCHEMA_VERSION, compile_plan

        # dtype is part of the plan key: cover what consumers run (the
        # engine defaults to float32, production bf16); image kernels run
        # float32 only.
        jobs = [(kernel, prob, dtype, HARDWARE_REGISTRY[hw_name])
                for hw_name, kernel, prob in _jobs(args.hardware)
                for dtype in kernel_dtypes(kernel, ("bfloat16", "float32"))]
        plan = compile_plan(jobs,
                            meta={"generated_by": "examples.tune_tiles"})
        plan.save(args.compile_plans)
        for e in sorted(plan.entries(), key=lambda e: e.key):
            print(f"{e.hardware:16s} {e.kernel:16s} "
                  f"{str(e.problem_dict)[:48]:50s} -> {e.tile}")
        print(f"\nplan artifact (schema v{PLAN_SCHEMA_VERSION}, "
              f"{len(plan)} entries) written to {args.compile_plans}")
        return

    at = Autotuner(cache_path=args.cache)
    for hw_name, kernel, prob in _jobs(args.hardware):
        dtype = kernel_dtypes(kernel, ("bfloat16",))[0]
        tile = at.best_tile(kernel, prob, dtype, HARDWARE_REGISTRY[hw_name])
        print(f"{hw_name:16s} {kernel:16s} "
              f"{str(dict(prob))[:48]:50s} -> {tile}")
    print(f"\ncache written to {args.cache}")
    with open(args.cache) as f:
        print(f"{len(json.load(f))} entries")


if __name__ == "__main__":
    main()
