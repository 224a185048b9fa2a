"""The dry run's count: what one rank's step does, counted on ``meta``
tensors — the port's counterpart of XLA's ``cost_analysis()`` and
``memory_analysis()``.

Open a count with :func:`counting` and run a step whose parameters, state
and inputs are ``meta`` tensors (shapes and dtypes, no memory). Nothing is
launched and no data exists; five things are recorded as the step runs:

* **Kernel launches.** Each kernel wrapper, given ``meta`` tensors, makes
  every decision it makes on the card (regime, tile, split plan,
  workspaces, the autograd Function) and, where it would call its kernel,
  reports the launch instead (``kernels/build.py:launched`` and
  ``meta_work``): a count a kernel in the keys of ``build.LAUNCHES``, and
  the launch's FLOPs (from the kernel module's own formula) and bytes
  (operands, outputs and workspaces).
* **Torch ops outside the kernels**, through a ``TorchDispatchMode``:
  products by ``torch.utils.flop_counter``'s formulas (FlopCounterMode's);
  elementwise ops one FLOP an output element and reductions one an input
  element, as XLA counts them (transcendental functions, which XLA counts
  apart, and copies none); bytes as the op's inputs plus outputs. Views,
  and ops that only make tensors, count nothing.
* **Collectives**: every call of ``distributed/collectives.py`` on a
  ``meta`` tensor records its kind and its result's bytes.
* **Peak live bytes**: every storage a ``meta`` op makes is live until the
  last tensor on it is freed (a finalizer on the storage), beside the
  tensors given as ``live`` (the step's arguments); the peak is the
  reference's ``argument + temp``.

Counts on ``meta`` are the same on any host: they are counts, not
measurements.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_ACTIVE: Optional["Count"] = None
# torch.utils.flop_counter's formulas, imported at the first count.
_FLOP_REGISTRY = None

aten = torch.ops.aten

# Elementwise ops with no FLOPs: the functions XLA counts as
# transcendentals, and copies (bytes only).
_NO_FLOPS = {
    aten.exp, aten.exp2, aten.expm1, aten.log, aten.log1p, aten.log2,
    aten.tanh, aten.sigmoid, aten.rsqrt, aten.sqrt, aten.sin, aten.cos,
    aten.erf, aten.pow, aten.clone, aten.copy, aten.copy_,
}
# Reductions: FLOPs a reduced (input) element.
_REDUCTIONS = {
    aten.sum: 1, aten.mean: 1, aten.amax: 1, aten.amin: 1, aten.max: 1,
    aten.min: 1, aten.prod: 1, aten.var: 2, aten.var_mean: 3,
    aten.std: 2, aten.cumsum: 1, aten.logsumexp: 3, aten.norm: 2,
    aten.linalg_vector_norm: 2, aten.argmax: 1, aten.argmin: 1,
    aten.any: 1, aten.all: 1, aten.topk: 1,
    # max, subtract, sum, divide (or log and subtract): XLA's decomposition
    # with its exp (or log) left out.
    aten._softmax: 4, aten._log_softmax: 4,
    aten._softmax_backward_data: 4, aten._log_softmax_backward_data: 4,
}


def active() -> Optional["Count"]:
    """The open count, or None."""
    return _ACTIVE


class Count:
    """What a counted step did: launches and work by kernel, the torch ops'
    work, the collective calls and the peak of live bytes."""

    def __init__(self):
        self.launches: Dict[str, int] = {}
        self.kernel_flops: Dict[str, float] = {}
        self.kernel_bytes: Dict[str, float] = {}
        self.op_flops = 0.0
        self.op_bytes = 0.0
        self.collectives: List[Tuple[str, int]] = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self._storages: Dict[int, int] = {}

    # -- totals ---------------------------------------------------------------
    @property
    def flops(self) -> float:
        return sum(self.kernel_flops.values()) + self.op_flops

    @property
    def hbm_bytes(self) -> float:
        return sum(self.kernel_bytes.values()) + self.op_bytes

    @property
    def collective_bytes(self) -> float:
        from repro_torch.roofline.analysis import collective_stats

        return collective_stats(self.collectives).total_bytes

    def totals(self) -> Tuple[float, float, float]:
        """(FLOPs, HBM bytes, collective bytes), the reference's terms."""
        return self.flops, self.hbm_bytes, self.collective_bytes

    # -- what the wrappers and collectives report ----------------------------
    def count_launch(self, name: str) -> None:
        self.launches[name] = self.launches.get(name, 0) + 1

    def kernel_work(self, name: str, flops: float, nbytes: float) -> None:
        self.kernel_flops[name] = self.kernel_flops.get(name, 0.0) + flops
        self.kernel_bytes[name] = self.kernel_bytes.get(name, 0.0) + nbytes

    def collective(self, kind: str, nbytes: int) -> None:
        self.collectives.append((kind, int(nbytes)))

    # -- live bytes -----------------------------------------------------------
    def track(self, tree: Any) -> None:
        """Count the ``meta`` tensors of ``tree`` live (the step's
        arguments), each storage once."""
        for leaf in tree_leaves(tree):
            if isinstance(leaf, torch.Tensor):
                self._hold(leaf)

    def _hold(self, t: torch.Tensor) -> None:
        if not t.is_meta:
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._release, key)

    def _release(self, key: int) -> None:
        self.live_bytes -= self._storages.pop(key, 0)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _op_flops(func, args, kwargs, out) -> float:
    global _FLOP_REGISTRY
    if _FLOP_REGISTRY is None:
        from torch.utils.flop_counter import flop_registry as _FLOP_REGISTRY
    packet = func.overloadpacket
    if packet in _FLOP_REGISTRY:
        return float(_FLOP_REGISTRY[packet](*args, **kwargs, out_val=out))
    if packet in _REDUCTIONS:
        first = next((a for a in tree_leaves(args)
                      if isinstance(a, torch.Tensor)), None)
        return float(_REDUCTIONS[packet] * first.numel()) if first is not None \
            else 0.0
    if torch.Tag.pointwise in func.tags and packet not in _NO_FLOPS:
        first = next((o for o in tree_leaves(out)
                      if isinstance(o, torch.Tensor)), None)
        return float(first.numel()) if first is not None else 0.0
    return 0.0


class _CountMode(TorchDispatchMode):
    """Records every aten op's work and the storages it makes."""

    def __init__(self, count: Count):
        super().__init__()
        self.count = count

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        c = self.count
        outs = [o for o in tree_leaves(out) if isinstance(o, torch.Tensor)]
        for o in outs:
            c._hold(o)
        ins = [a for a in tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        if func.is_view or not ins:
            return out
        c.op_flops += _op_flops(func, args, kwargs, out)
        c.op_bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(o)
                                                          for o in outs)
        return out


@contextlib.contextmanager
def counting(live: Any = ()) -> Iterator[Count]:
    """Open a count over what runs inside; ``live``: the tensors alive when
    it opens (the step's arguments), counted in the live bytes. Counts do
    not nest."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("a count is already open")
    count = Count()
    count.track(live)
    _ACTIVE = count
    try:
        with _CountMode(count):
            yield count
    finally:
        _ACTIVE = None


__all__ = ["Count", "active", "counting"]
