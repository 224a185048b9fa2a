"""Quickstart: the paper's workflow end to end, on the port.

1. Upscale an image with the tile-parameterised bilinear kernel (on the
   card, the Hopper kernel at the H100's tuned thread block; on the CPU its
   plain version) and hold it against the paper's Eq. 1-5 oracle.
2. Sweep tile shapes per hardware model with the autotuner — the paper's
   Fig. 3 experiment on its two GPUs — and see the per-model optima differ.
3. Ask the TilingPolicy for a robust (worst-case-fleet) tile (paper §V).
4. The H100's side: the autotuned tile of a large bf16 matmul.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse
import itertools

import torch

from repro_torch import resolve_device
from repro_torch.core import (
    GEFORCE_8800GTS, GTX260, H100_SXM, Autotuner, TilingPolicy,
)
from repro_torch.core.tiling import TileShape
from repro_torch.kernels import register_all
from repro_torch.kernels.bilinear.ops import upscale
from repro_torch.kernels.bilinear.ref import bilinear_upscale_ref

TOLERANCE = 2e-5  # float32, against the oracle


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the Hopper kernel) or cpu (its plain version)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    register_all()

    # -- 1. run the kernel --------------------------------------------------
    gen = torch.Generator().manual_seed(0)
    src = torch.rand((64, 128), generator=gen).to(device)
    prob = dict(src_h=64, src_w=128, scale=4)
    tile = TilingPolicy(mode="tuned", hardware=H100_SXM).tile_for(
        "bilinear", prob, "float32")
    out = upscale(src, 4, tile=tuple(tile))
    ref = bilinear_upscale_ref(src, 4)
    err = float((out - ref).abs().max())
    if err > TOLERANCE:
        raise SystemExit(f"bilinear upscale is {err:.3g} off the oracle")
    print(f"bilinear upscale {tuple(src.shape)} -> {tuple(out.shape)} on "
          f"{device.type}, tile {tuple(tile)}: matches the oracle "
          f"(max |err| {err:.2g})")

    # -- 2. the paper's per-model sweep --------------------------------------
    at = Autotuner()
    sweep = [TileShape((h, w))
             for h, w in itertools.product((4, 8, 16, 32), repeat=2)]
    prob = dict(src_h=800, src_w=800, scale=6)
    for hw in (GTX260, GEFORCE_8800GTS):
        res = at.sweep("bilinear_cuda", prob, "float32", hw, tiles=sweep)
        b = res.best
        print(f"{hw.name:18s} best tile {b.tile[1]}x{b.tile[0]} "
              f"({b.score * 1e3:.2f} ms model-time, "
              f"sensitivity {res.sensitivity():.1f}x)")

    # -- 3. robust fleet tile (paper §V) -------------------------------------
    pol = TilingPolicy(mode="robust", fleet=(GTX260, GEFORCE_8800GTS))
    t = pol.tile_for("bilinear_cuda", prob, "float32")
    print(f"robust fleet tile: {t[1]}x{t[0]}  (the paper's 32x4 principle)")

    # -- 4. the H100's side: an autotuned matmul tile -------------------------
    mm_tile = at.best_tile("matmul", dict(m=4096, k=4096, n=4096), "bfloat16",
                           H100_SXM)
    print(f"h100_sxm matmul tile (bm, bk, bn) = {tuple(mm_tile)}")


if __name__ == "__main__":
    main()
