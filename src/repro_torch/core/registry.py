"""Kernel registry of the port: each Hopper kernel declares its tile space.

Same interface as ``repro/core/registry.py``, in a registry of the port's
own (the reference's raises on a duplicate name, and the tests load both
packages in one process). Kernel names match the reference's, so plan cells
line up.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Sequence

from repro_torch.core.cost_model import TileWorkload
from repro_torch.core.tiling import TileConstraints, TileShape


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Declaration of one kernel's tunable space.

    ``vmem_bytes`` is the tile's shared-memory working set per thread block;
    a legal tile keeps it within ``HardwareModel.vmem_bytes`` (227 KB on the
    H100), and a tile the kernel cannot launch has an infinite one, so no
    sweep ranks it. ``workload`` is one block's work (``threads`` set to the
    block size) and ``n_tiles`` the blocks of one launch, which the Hopper
    estimator turns into time. All callables are pure.
    """

    name: str
    constraints: Callable[[Mapping[str, int]], TileConstraints]
    vmem_bytes: Callable[[TileShape, Mapping[str, int], str], float]
    workload: Callable[[TileShape, Mapping[str, int], str], TileWorkload]
    n_tiles: Callable[[TileShape, Mapping[str, int]], int]
    default_tile: Callable[[Mapping[str, int], str], TileShape]


_REGISTRY: Dict[str, KernelSpec] = {}


def register(spec: KernelSpec) -> KernelSpec:
    if spec.name in _REGISTRY:
        raise ValueError(f"kernel {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def get(name: str) -> KernelSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"kernel {name!r} not registered; known: {sorted(_REGISTRY)}"
        ) from None


def names() -> Sequence[str]:
    return sorted(_REGISTRY)
