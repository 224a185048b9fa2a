"""The paper's application on the port: batch image upscaling with a tuned
tile.

Generates a batch of images from a seed, takes the H100's tile for the
problem from the TilingPolicy (the cost model's pick), and upscales each on
the card with the Hopper bilinear kernel, timed, holding every output
against the oracle. With ``--device cpu`` the kernel's plain version runs.

Run:  PYTHONPATH=src python -m repro_torch.examples.resize_images --scale 4
"""
import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.core import H100_SXM, TilingPolicy
from repro_torch.kernels import register_all
from repro_torch.kernels.bilinear.ops import upscale
from repro_torch.kernels.bilinear.ref import bilinear_upscale_ref

TOLERANCE = 2e-5  # float32, against the oracle


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=4)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--count", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the Hopper kernel) or cpu (its plain version)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    register_all()

    pol = TilingPolicy(mode="tuned", hardware=H100_SXM)
    prob = dict(src_h=args.size, src_w=args.size, scale=args.scale)
    tile = tuple(pol.tile_for("bilinear", prob, "float32"))
    print(f"device={device.type} h100_sxm tile={tile}")

    gen = torch.Generator().manual_seed(0)
    images = [torch.rand((args.size, args.size), generator=gen).to(device)
              for _ in range(args.count)]
    total = 0.0
    worst = 0.0
    for i, img in enumerate(images):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = upscale(img, args.scale, tile=tile)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        total += dt
        err = float((out - bilinear_upscale_ref(img, args.scale)).abs().max())
        worst = max(worst, err)
        if err > TOLERANCE:
            raise SystemExit(f"image {i}: the kernel is {err:.3g} off the "
                             f"oracle")
        print(f"image {i}: {tuple(img.shape)} -> {tuple(out.shape)} "
              f"mean={float(out.mean()):.4f} {dt * 1e3:.3f} ms")
    print(f"total {total * 1e3:.3f} ms for {args.count} images on the host "
          f"clock (the first includes loading the kernel); max |err| "
          f"{worst:.2g}")


if __name__ == "__main__":
    main()
