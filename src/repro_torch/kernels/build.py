"""Build and load the hand-written CUDA kernels (nvcc + ctypes).

Each source under ``csrc/`` compiles on its own, with ``nvcc -gencode
arch=compute_90a,code=sm_90a``, into a shared library with a plain C
interface, which the wrappers load with ``ctypes``. Libraries are built at
first use into ``build/repro_torch/`` at the repository root, named by a
hash of the source and the flags, so an edited source rebuilds and an
unchanged one is reused. :func:`build`
starts one ``nvcc`` per source, all at once.

Nothing here runs at import time: the CPU tests import every module of the
port on a host without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {
    "matmul": "matmul.cu",
    "flash_attention": "flash_attention.cu",
    "flash_decode": "flash_decode.cu",
    "bilinear": "bilinear.cu",
    "ssd": "ssd.cu",
    "rglru": "rglru.cu",
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

# Kernel launches per wrapper: each wrapper adds one where it launches its
# kernel on the card, and nowhere else (the plain CPU path does not count).
LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}

_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def lib_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"lib{name}-{h}.so"


def build(names: Optional[Iterable[str]] = None,
          verbose: bool = False) -> Dict[str, float]:
    """Compile every missing library in parallel; returns seconds per build.

    ``verbose`` adds ``-Xptxas -v`` and prints what ptxas reports (registers,
    shared memory, spills per kernel). Raises with nvcc's output on failure.
    """
    names = list(names or SOURCES)
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = lib_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target, time.perf_counter())
    times: Dict[str, float] = {}
    failures = []
    for name, (proc, tmp, target, t0) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"--- nvcc {SOURCES[name]} (rc {proc.returncode})"
                            f"\n{log}")
            continue
        if verbose and log.strip():
            print(f"--- ptxas {SOURCES[name]}\n{log.strip()}")
        os.replace(tmp, target)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library for one kernel (built first if it is missing)."""
    lib = _LIBS.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a kernel's C entry point reported a launch error."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def dtype_code(dtype) -> int:
    """The ``dtype`` argument of the C entry points: 0 float32, 1 bfloat16."""
    import torch

    return {torch.float32: 0, torch.bfloat16: 1}[dtype]


def check_cuda_operands(name: str, *tensors) -> None:
    """Raise unless every tensor is a contiguous float32/bfloat16 CUDA
    tensor of one device and dtype."""
    import torch

    first = tensors[0]
    for t in tensors:
        if t.device.type != "cuda" or t.device != first.device:
            raise ValueError(f"{name} needs its operands on one CUDA device, "
                             f"got {[str(x.device) for x in tensors]}")
        if (t.dtype not in (torch.float32, torch.bfloat16)
                or t.dtype != first.dtype):
            raise TypeError(f"{name} takes float32 or bfloat16 operands of "
                            f"one dtype, got {[x.dtype for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous operands")
