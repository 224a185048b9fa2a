"""Start a process group, and run a function on a group of local ranks.

The reference's mesh is every device one JAX process sees; the port's is
one process a rank under ``torch.distributed`` (explicit SPMD). Nothing on
the machine names a cluster, so the caller gives each process its backend,
rank, world size and a ``FileStore`` path: a file that all ranks of one
group share (never a TCP port, so that groups started side by side, such
as the tests' in several workers, cannot collide). NCCL is the backend on
the card; gloo runs on the CPU, and on one card it lets several ranks share
the device (NCCL cannot put two ranks on one GPU).

:func:`run_ranks` starts ``world_size`` processes (the ``spawn`` method,
so each starts from a fresh import), each of which initialises the group
and calls ``fn(rank, world_size, *args)``. It waits for all of them under
one deadline: a rank that hangs in a collective fails the call at the
deadline (every process is killed) instead of holding its caller forever.
A rank's exception is written beside the store and raised in the caller.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

# What bounds each collective of a group that run_ranks starts: a rank left
# waiting for a peer fails at this, well inside the callers' deadlines.
COLLECTIVE_TIMEOUT_S = 120.0


def init_process_group(backend: str, rank: int, world_size: int,
                       store_path, timeout_s: float = 120.0,
                       device=None) -> None:
    """Join the default process group through a ``FileStore`` at
    ``store_path``. ``timeout_s`` bounds every collective of the group, so
    a rank left waiting for a peer fails instead of hanging. On a CUDA
    ``device`` the current device is set (and CUDA initialised) first, so
    the mesh built next keeps it."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised here")
    bound = {}
    if device is not None and torch.device(device).type == "cuda":
        index = torch.device(device).index
        index = torch.cuda.current_device() if index is None else index
        torch.cuda.set_device(index)
        torch.cuda.init()
        if backend == "nccl":          # NCCL would guess it from the rank
            bound["device_id"] = torch.device("cuda", index)
    store = dist.FileStore(str(store_path), world_size)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s), **bound)


def _rank_main(fn, rank, world_size, backend, store_path, timeout_s, device,
               err_dir, args):
    try:
        init_process_group(backend, rank, world_size, store_path,
                           timeout_s=timeout_s, device=device)
        fn(rank, world_size, *args)
        if dist.is_initialized():   # fn may have left or remade its group
            dist.barrier()
    except BaseException:
        Path(err_dir, f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable[..., Any], world_size: int, store_dir,
              backend: str = "gloo", args: Sequence[Any] = (),
              timeout_s: float = 300.0, device: Optional[str] = None
              ) -> None:
    """Run ``fn(rank, world_size, *args)`` on ``world_size`` new processes.

    ``fn`` must be importable by name (a module-level function) and is run
    after the group is up (``backend`` through a ``FileStore`` in
    ``store_dir``, which must exist). Raises ``RuntimeError`` with the
    failing ranks' tracebacks if any rank fails, ``TimeoutError`` if the
    ranks are not done within ``timeout_s`` (all are killed then)."""
    store_dir = Path(store_dir)
    store = store_dir / f"store.{os.getpid()}.{time.monotonic_ns()}"
    err_dir = store_dir / (store.name + ".errors")
    err_dir.mkdir(parents=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, backend, str(store),
                               COLLECTIVE_TIMEOUT_S, device, str(err_dir),
                               tuple(args)))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        if hung:
            raise TimeoutError(f"ranks {hung} of {world_size} still running "
                               f"after {timeout_s:.0f} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    errors = sorted(err_dir.glob("rank*.err"))
    failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if errors or failed:
        text = "\n".join(f.read_text() for f in errors)
        raise RuntimeError(f"ranks {failed} of {world_size} failed:\n{text}")
