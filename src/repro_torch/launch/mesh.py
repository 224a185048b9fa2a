"""Mesh construction — the port's ``repro/launch/mesh.py``.

The reference's mesh is JAX's view of every device; the port's is one
process a rank under ``torch.distributed``: a
``torch.distributed.device_mesh.init_device_mesh`` over the reference's
axes (``("data", "model")``, or ``("pod", "data", "model")``), with the
same names and shapes, built inside a process group that is already
initialised (NCCL on the card, gloo on the CPU;
``distributed/process_group.py`` starts one). Every rank of the group
builds the mesh together: it creates the axes' process groups.

:class:`Mesh` is what the sharding rules and the model's bodies read: the
reference's ``shape`` (axis name -> size) and ``axis_names``, this rank's
coordinate on each axis, and the process group of each axis (and of the
batch axes together, the ranks that share a model coordinate).
"""
from __future__ import annotations

import itertools
from typing import Dict, Sequence, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch import resolve_device


class Mesh:
    """A device mesh of this process group, by axis name."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device_type: str):
        if not dist.is_initialized():
            raise RuntimeError(
                "a mesh needs an initialised process group "
                "(repro_torch.distributed.process_group.init_process_group)")
        n = 1
        for s in shape:
            n *= int(s)
        world = dist.get_world_size()
        if n != world:
            raise ValueError(f"a mesh of shape {tuple(shape)} needs {n} "
                             f"ranks; this process group has {world}")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(s) for s in shape)))
        self.device_type = device_type
        self.device_mesh = init_device_mesh(
            device_type, tuple(self.shape.values()),
            mesh_dim_names=self.axis_names)
        coord = self.device_mesh.get_coordinate()
        self.coords: Dict[str, int] = dict(zip(self.axis_names, coord))
        self._groups = {(a,): self.device_mesh.get_group(a)
                        for a in self.axis_names}
        # Lines over several axes (the batch axes with a pod axis): one
        # group for each setting of the other axes, created by every rank
        # in the same order.
        for k in range(2, len(self.axis_names)):
            for axes in itertools.combinations(self.axis_names, k):
                self._groups[axes] = self._line_group(axes)

    def _line_group(self, axes: Tuple[str, ...]):
        ranks = self.device_mesh.mesh
        names = self.axis_names
        rest = [a for a in names if a not in axes]
        mine = None
        for fixed in itertools.product(*(range(self.shape[a])
                                         for a in rest)):
            index = []
            for a in names:
                index.append(fixed[rest.index(a)] if a in rest
                             else slice(None))
            members = sorted(int(r) for r in ranks[tuple(index)].flatten())
            g = dist.new_group(members)
            if dist.get_rank() in members:
                mine = g
        return mine

    def group(self, axes: Tuple[str, ...]):
        """The process group of this rank's line along ``axes``."""
        axes = tuple(a for a in self.axis_names if a in axes)
        if len(axes) == len(self.axis_names):
            return dist.group.WORLD
        return self._groups[axes]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank coords {self.coords}, "
                f"{self.device_type})")


def _device_type(device) -> str:
    return resolve_device(device).type


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """16x16 single pod (256 ranks) or 2x16x16 multi-pod (512 ranks).
    Raises unless the process group has exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, _device_type(device))


def make_local_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """A ``data`` x ``model`` mesh over the ranks of this process group
    (tests, the card's checks); its product must be the world size."""
    return Mesh((data, model), ("data", "model"), _device_type(device))


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              device=None) -> Mesh:
    """Any mesh over this process group, e.g. ``((2,), ("pod",))`` for the
    pipeline."""
    return Mesh(shape, axis_names, _device_type(device))

