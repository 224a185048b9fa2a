#!/usr/bin/env python3
"""Run chip_smoke's phase 18 (the mesh runtime) and phase 19 (c) (its
FSDP train steps, qwen2-1.5b's and whisper-large-v3's, against the dry
run's counts) alone, on one
NVIDIA card: the quick way to iterate on the mesh without the whole run.

    python3 tools/mesh_phase.py [--rows] [--out chiprun_out/mesh_phase.json]

It builds the kernels, optionally times the kernels at a tensor-parallel
rank's shapes (``--rows``: ``chip_smoke.tp_slice_checks`` and
``chip_smoke.scan_tp_checks``, phase 3's local-shape rows), runs ``chip_smoke.mesh_phase`` (18a and 18b,
each check held against the one-process path of the same ranks) and
``chip_smoke.mesh_train_counts``, and writes every figure as JSON. Exits
non-zero on the first check that fails. The card's name and power limit
come first.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", action="store_true",
                    help="also time the kernels at a rank's local shapes")
    ap.add_argument("--out", default="chiprun_out/mesh_phase.json")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    sys.path.insert(0, str(cs.SRC))
    import torch

    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        print("mesh_phase: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    cs.log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.log(f"  built {build.build()}")
    rows = []
    if args.rows:
        gen = torch.Generator(device="cuda").manual_seed(0)

        def randn(shape, dtype, scale=1.0):
            return (torch.randn(shape, generator=gen, device="cuda")
                    * scale).to(dtype)

        def record(kernel, case, dname, out, ref, timing=None):
            err = cs.max_err(out, ref)
            row = dict(kernel=kernel, case=case, dtype=dname,
                       max_abs_err=err, ok=cs.within(err, ref, dname),
                       **{k: v for k, v in (timing or {}).items()
                          if k != "shape"})
            rows.append(row)
            cs.log(f"  {json.dumps(row)}")
            cs.check(row["ok"], f"{kernel} {case} {dname}: err {err:.3e}")

        dtypes = (("float32", torch.float32), ("bfloat16", torch.bfloat16))
        cs.tp_slice_checks(record, randn, dtypes, False)
        cs.scan_tp_checks(record, dtypes, False)
    try:
        t1 = time.perf_counter()
        mesh = cs.mesh_phase()
        cs.log(f"  [18: {time.perf_counter() - t1:.1f} s]")
        count = cs.mesh_train_counts(mesh["checks"])
    except cs.SmokeError as exc:
        print(f"mesh_phase: FAIL: {exc}", file=sys.stderr)
        return 1
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(card=card, rows=rows, mesh=mesh,
                                   count=count), indent=1, default=str))
    cs.log(f"  done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
