#!/usr/bin/env python3
"""Time the port's ssd kernels (the chunk scan and its backward) at
mamba2-2.7b's width (H 80, P 64, N 128), in the source tree named by
``--src``, on one NVIDIA card.

    python3 tools/time_ssd.py --src OLD/src --what fwd
    python3 tools/time_ssd.py --src src --what fwd bwd
    python3 tools/time_ssd.py --src src --what bwd --bwd-variant no-products
    python3 tools/time_ssd.py --src src --build-only [--bwd-variant ...]

It compares versions of the kernels in one call: run it once per tree
(old, new, new, old) and read the JSON lines. ``fwd`` times ``ssd_scan``
at S 4096 (the default chunk) and S 1, float32 and bf16; ``bwd`` times the
backward (``ssd_scan_backward`` from a forward's saved outputs) and its
``repro_ssd_bwd`` launch alone, at (B 1, S 4096) and mamba2-2.7b's train
shape (B 8, S 512), for a tree whose backward reads the reversed problem in
place. Times are ``chip_smoke.time_ms``'s: CUDA events around the replay of
a CUDA graph of the calls, the forward's on input copies that overflow the
L2 cache.

``--bwd-variant no-products`` builds a copy of the tree's ``ssd.cu`` whose
backward kernel (``ssd_bwd_kernel``) skips its tensor-core products (and
so their shared-memory operand loads): its gradients are wrong, and its
time is what the kernel takes for everything but the products. The copy is
built with the port's nvcc flags into ``build/variants/`` of this checkout.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
H, P, N = 80, 64, 128
FWD_LENGTHS = (4096, 1)
BWD_SHAPES = ((1, 4096), (8, 512))
CHUNK = 64

SKIP = ("template <typename... A>\n"
        "__device__ __forceinline__ void skip_mma(A&&...) {}\n\n")


def variant_source(text: str, variant: str) -> str:
    """``ssd.cu``'s text with ``variant`` applied."""
    if variant != "no-products":
        raise ValueError(f"unknown variant {variant}")
    start = text.index("ssd_bwd_kernel(const T*")
    start = text.rindex("template <typename T>", 0, start)
    end = text.index("\n}\n", start)
    body = text[start:end]
    assert "M::mma(" in body
    return text[:start] + SKIP + body.replace("M::mma(", "skip_mma(") + \
        text[end:]


def build_variant(build, variant: str) -> Path:
    """The variant's library, built (once) into build/variants/<variant>/."""
    out = ROOT / "build" / "variants" / variant
    lib = out / "libssd.so"
    if lib.exists():
        return lib
    csrc = out / "csrc"
    if csrc.exists():
        shutil.rmtree(csrc)
    shutil.copytree(build.CSRC, csrc)
    src = csrc / build.SOURCES["ssd"]
    src.write_text(variant_source(src.read_text(), variant))
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {src} (rc {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", required=True,
                    help="the src directory whose repro_torch to time")
    ap.add_argument("--what", nargs="+", choices=("fwd", "bwd"),
                    default=["fwd", "bwd"])
    ap.add_argument("--bwd-variant", choices=("no-products",))
    ap.add_argument("--build-only", action="store_true",
                    help="build the tree's ssd library (and the variant)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("time_ssd: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd import ops

    if args.bwd_variant:
        lib = build_variant(build, args.bwd_variant)
        build._LIBS["ssd"] = ctypes.CDLL(str(lib))
    else:
        build.build(["ssd"])
    if args.build_only:
        return 0
    from chip_smoke import (_scan_grad_operands, _ssd_operands, copies_for,
                            time_ms)

    tag = dict(src=args.src, variant=args.bwd_variant)
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        for s in FWD_LENGTHS if "fwd" in args.what else ():
            prob = dict(s=s, h=H, p=P, n=N)
            (q,) = ops.SPEC.default_tile(prob, dname)
            one = _ssd_operands(1, s, H, P, N, dt, seed=s)
            nb = sum(t.numel() * t.element_size() for t in one)
            copies = [_ssd_operands(1, s, H, P, N, dt, seed=100 + i)
                      for i in range(copies_for(nb))]
            ms = time_ms([lambda c=c: ops.ssd_scan(*c, chunk=q)
                          for c in copies])
            print(json.dumps(dict(what="fwd", dtype=dname, b=1, s=s, chunk=q,
                                  ms=ms, **tag)), flush=True)
            del one, copies
        for b, s in BWD_SHAPES if "bwd" in args.what else ():
            width = dict(h=H, p=P, n=N, chunk=CHUNK)
            inputs, weights = _scan_grad_operands("ssd", width, s, dt, "cuda",
                                                  seed=7, b=b)
            dy, dh = (w.to(dt) for w in weights)
            y, hl, h_in = ops._ssd_cuda(*inputs, CHUNK)
            log_a, dtx, bm, cm, h0 = inputs
            _, _, r_h_in, _ = ops._ssd_rev_cuda(log_a, dy, cm, bm, dh, y, dtx,
                                                CHUNK)
            whole = time_ms([lambda: ops.ssd_scan_backward(
                *inputs, y, hl, h_in, dy, dh, CHUNK, ops._ssd_rev_cuda,
                ops._ssd_bwd_cuda)], iters=8)
            alone = time_ms([lambda: ops._ssd_bwd_cuda(
                log_a, dtx, bm, cm, dy, h0, dh, h_in, r_h_in, CHUNK)], iters=8)
            hpb = ops.bwd_heads_per_block(b, s, CHUNK, H, N, P, dt)
            print(json.dumps(dict(what="bwd", dtype=dname, b=b, s=s,
                                  chunk=CHUNK, ms=whole, repro_ssd_bwd_ms=alone,
                                  heads_per_block=hpb, **tag)), flush=True)
            del inputs, weights, dy, dh, y, hl, h_in, r_h_in
    return 0


if __name__ == "__main__":
    sys.exit(main())
