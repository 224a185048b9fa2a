#!/usr/bin/env python3
"""Time the port's flash_decode kernel at the shapes of PERF.md's table, in
the source tree named by ``--src``, on one NVIDIA card.

    python3 tools/time_flash_decode.py --src src --pos device
    python3 tools/time_flash_decode.py --src OLD/src --pos int
    python3 tools/time_flash_decode.py --src src --lse

It compares two versions of the kernel in one call: run it once per tree
(old, new, new, old) and read the JSON lines. ``--pos device`` passes the
position as a 0-d int32 tensor on the card (the kernel reads it from device
memory); ``--pos int`` as a Python int, for a wrapper that takes only that.
``--lse`` times each shape both without and with each row's log-sum-exp
(``return_lse=True``, which a wrapper older than that output does not
take), in turns off, on, on, off within the process.
Times are ``chip_smoke.time_ms``'s: CUDA events around the replay of a CUDA
graph of many calls on input copies that overflow the L2 cache; beside them
each launch's device time from ``torch.profiler`` (``chip_smoke.
device_kernels``, warm inputs): the split kernel and the combine.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (label, b, hq, hkv, s, d, pos, window, dtype)
SHAPES = [
    ("qwen2 pos 0", 1, 16, 2, 1024, 128, 0, None, "float32"),
    ("qwen2 pos 511", 1, 16, 2, 1024, 128, 511, None, "float32"),
    ("qwen2 pos 1023", 1, 16, 2, 1024, 128, 1023, None, "float32"),
    ("qwen2 pos 511 bf16", 1, 16, 2, 1024, 128, 511, None, "bfloat16"),
    ("D=256 window 2048 pos 4095", 1, 16, 1, 4096, 256, 4095, 2048,
     "float32"),
    ("D=80 b=1 pos 4095", 1, 32, 8, 4096, 80, 4095, None, "float32"),
    ("D=80 b=1 pos 4095 bf16", 1, 32, 8, 4096, 80, 4095, None, "bfloat16"),
    ("D=80 b=32 pos 4095", 32, 32, 8, 4096, 80, 4095, None, "float32"),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", required=True,
                    help="the src directory whose repro_torch to time")
    ap.add_argument("--pos", choices=("device", "int"), default="device")
    ap.add_argument("--lse", action="store_true",
                    help="also time the calls that return the log-sum-exp")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("time_flash_decode: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    from chip_smoke import copies_for, device_kernels, time_ms
    from repro_torch.kernels.flash_attention.decode import flash_decode

    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, b, hq, hkv, s, d, pos, window, dname in SHAPES:
        dt = getattr(torch, dname)

        def randn(shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dt)

        nb = (2 * b * hq * d + 2 * b * hkv * s * d) * dt.itemsize
        copies = [(randn((b, hq, d)), randn((b, hkv, s, d)),
                   randn((b, hkv, s, d))) for _ in range(copies_for(nb))]
        p = (torch.full((), pos, dtype=torch.int32, device="cuda")
             if args.pos == "device" else pos)
        def calls(lse):
            kw = dict(return_lse=True) if lse else {}
            return [lambda x=x, y=y, z=z: flash_decode(
                x, y, z, pos=p, window=window, **kw) for x, y, z in copies]

        if not args.lse:
            fns = calls(False)
            print(json.dumps(dict(shape=label, ms=time_ms(fns),
                                  launch_ms=device_kernels(fns[0]),
                                  src=args.src)), flush=True)
            continue
        modes = {False: calls(False), True: calls(True)}
        ms = {False: [], True: []}
        for lse in (False, True, True, False):
            ms[lse].append(time_ms(modes[lse]))
        print(json.dumps(dict(
            shape=label, ms_off=ms[False], ms_on=ms[True],
            launch_ms_off=device_kernels(modes[False][0]),
            launch_ms_on=device_kernels(modes[True][0]), src=args.src)),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
