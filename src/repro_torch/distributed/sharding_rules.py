"""Logical-axis -> mesh-axis mapping and sharding trees — the port's
``repro/distributed/sharding_rules.py``.

Parameters carry logical axes (``models/layers.py`` ``ParamDef``); this
module turns them into the port's :class:`NamedSharding` for a mesh: a
:class:`~repro_torch.models.context.PartitionSpec` (a tuple with the
reference's entries) on a mesh. The rules are the reference's:

* ``fsdp`` — additionally shard the largest remaining parameter axis over
  the data axis (ZeRO-3 style), on top of the model-axis mapping;
* batch axes: ("pod", "data") when the mesh has a pod axis, else ("data",).

A leaf shards by its spec: this rank holds its block of every mesh axis the
spec names (the blocks of an axis in coordinate order, of a tuple entry the
first axis the slowest). :func:`shard_tree` cuts a whole tree into this
rank's blocks and :func:`unshard_tree` gathers the blocks back (the
checkpoint round trip).

The tree a rank holds its parameters in on a mesh is the model's
(``models/api.py:rank_shardings``), built from each leaf's logical axes:
the model axis where the port computes a layer tensor-parallel, and with
FSDP the data axis on the largest dim left (``models/context.py:data_dim``,
:func:`param_spec`'s test). :func:`param_shardings` is the reference's
rule, which the dry run's ``param_bytes_sharded`` reports.

``mesh`` is anything with the reference's ``shape`` (axis name -> size) and
``axis_names``: a ``launch.mesh.Mesh``, or a stub in the tests.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.distributed import collectives
from repro_torch.models.context import DistContext, PartitionSpec

P = PartitionSpec

# logical axis -> model-parallel mesh axis
_MODEL_AXES = {
    "heads": "model", "kv_heads": "model", "ff": "model", "vocab": "model",
    "experts": "model", "lru": "model", "ssm_heads": "model",
}


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""
    mesh: Any
    spec: PartitionSpec

    def _entry_axes(self, entry) -> Tuple[str, ...]:
        if entry is None:
            return ()
        return tuple(entry) if isinstance(entry, tuple) else (entry,)

    @property
    def axes(self) -> Tuple[str, ...]:
        """The mesh axes the spec names, in the mesh's order: the groups a
        leaf's blocks are spread over (``()``: whole on every rank)."""
        named = {a for e in self.spec for a in self._entry_axes(e)}
        return tuple(a for a in self.mesh.axis_names if a in named)

    def _fits(self, ndim: int) -> None:
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec} names {len(self.spec)} dims; "
                             f"the array has {ndim}")

    def shard_shape(self, shape) -> Tuple[int, ...]:
        """This rank's block shape of an array of ``shape``. Raises when
        the spec has more entries than the shape has dims."""
        self._fits(len(shape))
        out = []
        for i, n in enumerate(shape):
            k = 1
            if i < len(self.spec):
                for a in self._entry_axes(self.spec[i]):
                    k *= self.mesh.shape[a]
            out.append(n // k)
        return tuple(out)

    def _block(self, i: int, ndim: int) -> Tuple[int, int]:
        """(index, count) of this rank's block along dim ``i`` of ``ndim``."""
        self._fits(ndim)
        idx, cnt = 0, 1
        if i < len(self.spec):
            for a in self._entry_axes(self.spec[i]):
                idx = idx * self.mesh.shape[a] + self.mesh.coords[a]
                cnt *= self.mesh.shape[a]
        return idx, cnt

    def local_block(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole array ``x`` (a copy)."""
        for i in range(x.dim()):
            idx, cnt = self._block(i, x.dim())
            if cnt > 1:
                n = x.shape[i] // cnt
                x = x.narrow(i, idx * n, n)
        return x.clone(memory_format=torch.contiguous_format)

    def gather(self, block: torch.Tensor) -> torch.Tensor:
        """The whole array from every rank's ``block`` (collective over the
        axes the spec names; every rank gets it)."""
        self._fits(block.dim())
        x = block
        for i in range(len(self.spec)):
            axes = self._entry_axes(self.spec[i])
            # The last axis of a tuple entry is the fastest: gather it first.
            for a in reversed(axes):
                if self.mesh.shape[a] > 1:
                    x = collectives.all_gather(x, i, self.mesh.group((a,)))
        return x


def batch_axes_for(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def make_context(mesh, fsdp: bool = True) -> DistContext:
    """The model's view of ``mesh``. ``fsdp`` (the reference's default, on):
    the parameters are also split over the data axis where it has more
    than one rank (``context.data_dim``); False keeps them whole over it."""
    if mesh is None:
        return DistContext(mesh=None)
    if not (hasattr(mesh, "shape") and hasattr(mesh, "axis_names")
            and hasattr(mesh, "group")):
        raise TypeError(f"not a mesh: {mesh!r} (launch/mesh.py builds one "
                        "over a process group)")
    return DistContext(mesh=mesh, batch_axes=batch_axes_for(mesh),
                       fsdp=fsdp)


def param_spec(
    logical_axes: Tuple[Optional[str], ...],
    shape: Tuple[int, ...],
    mesh,
    fsdp: bool = True,
) -> PartitionSpec:
    """PartitionSpec for one parameter from its logical axes.

    TP axes map via _MODEL_AXES; with ``fsdp``, the largest axis not already
    sharded (and divisible) is additionally sharded over 'data'.
    """
    assign: list = [None] * len(shape)
    for i, ax in enumerate(logical_axes):
        mapped = _MODEL_AXES.get(ax) if ax else None
        if (mapped and shape[i] % mesh.shape[mapped] == 0
                and shape[i] >= mesh.shape[mapped]):
            assign[i] = mapped
    if fsdp and "data" in mesh.axis_names:
        dsize = mesh.shape["data"]
        order = sorted(range(len(shape)), key=lambda i: -shape[i])
        for i in order:
            if assign[i] is None and shape[i] % dsize == 0 and shape[i] >= dsize:
                assign[i] = "data"
                break
    return P(*assign)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _map2(fn, a, b):
    """``fn`` over two trees of one structure (dicts and lists); ``a``'s
    leaves are axes tuples or tensors."""
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    if isinstance(a, list):
        return [_map2(fn, x, y) for x, y in zip(a, b)]
    return fn(a, b)


def param_shardings(axes_tree: Any, shape_tree: Any, mesh,
                    fsdp: bool = True) -> Any:
    """Tree of :class:`NamedSharding` matching the params tree.
    ``shape_tree``'s leaves are tensors (or anything with ``.shape``)."""
    return _map2(lambda ax, t: NamedSharding(
        mesh, param_spec(ax, tuple(t.shape), mesh, fsdp)),
        axes_tree, shape_tree)


def batch_sharding(mesh, ndim: int, batch_dim: int = 0) -> NamedSharding:
    spec: list = [None] * ndim
    baxes = batch_axes_for(mesh)
    spec[batch_dim] = baxes if len(baxes) > 1 else baxes[0]
    return NamedSharding(mesh, P(*spec))


def opt_state_shardings(param_shard_tree: Any, mesh) -> Any:
    """AdamW moments shard like their parameters; step is replicated."""
    return {
        "m": param_shard_tree,
        "v": param_shard_tree,
        "step": NamedSharding(mesh, P()),
    }


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def local_rows(x, ctx: Optional[DistContext], dim: int = 0):
    """This rank's rows of a global batch array (tensor or numpy): the
    block :func:`batch_sharding` gives its coordinate on the batch axes.
    Without a mesh, ``x`` itself."""
    if ctx is None or ctx.mesh is None:
        return x
    n, i = ctx.axis_size("batch"), ctx.axis_index("batch")
    b = x.shape[dim]
    if b % n:
        raise ValueError(f"a batch of {b} rows does not split over {n} "
                         "batch ranks")
    rows = b // n
    index = [slice(None)] * x.ndim
    index[dim] = slice(i * rows, (i + 1) * rows)
    return x[tuple(index)]


def local_batch(batch, ctx: Optional[DistContext]):
    """:func:`local_rows` of every array of a batch dict."""
    return {k: local_rows(v, ctx) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Whole trees <-> this rank's blocks
# ---------------------------------------------------------------------------

def shard_tree(tree: Any, shardings: Any) -> Any:
    """This rank's block of every leaf of a whole tree."""
    return _map2(lambda t, sh: sh.local_block(t), tree, shardings)


def unshard_tree(blocks: Any, shardings: Any) -> Any:
    """The whole tree from every rank's blocks (collective; every rank of
    the mesh calls it with the same structure)."""
    return _map2(lambda t, sh: sh.gather(t), blocks, shardings)


# ---------------------------------------------------------------------------
# Serve-state (KV cache / recurrent state) sharding
# ---------------------------------------------------------------------------

def _batch_entry(mesh, b: int):
    """Shard batch over as many batch axes as divide it (pods first)."""
    baxes = batch_axes_for(mesh)
    use = []
    rem = b
    for ax in baxes:
        if rem % mesh.shape[ax] == 0 and rem >= mesh.shape[ax]:
            use.append(ax)
            rem //= mesh.shape[ax]
    if not use:
        return None
    return tuple(use) if len(use) > 1 else use[0]


def _leaf_spec(name: Optional[str], shape: Tuple[int, ...], mesh
               ) -> PartitionSpec:
    msize = mesh.shape["model"]

    def div(n: int) -> bool:
        return n % msize == 0 and n >= msize

    nd, sh = len(shape), shape
    out: list = [None] * nd
    if name in ("pos", "slot_pos") or nd <= 1:
        return P()
    if name in ("k", "v", "self_k", "self_v", "cross"):
        # [*lead, B, H, S, hd] — heads over model if divisible, else seq.
        off = nd - 4
        out[off] = _batch_entry(mesh, sh[off])
        if div(sh[off + 1]):
            out[off + 1] = "model"
        elif div(sh[off + 2]):
            out[off + 2] = "model"
    elif name == "h" and nd >= 4:
        # SSD state [*lead, B, H, N, P] — heads over model.
        off = nd - 4
        out[off] = _batch_entry(mesh, sh[off])
        if div(sh[off + 1]):
            out[off + 1] = "model"
    elif name and name.startswith("conv"):
        # [*lead, B, W, F] — features over model.
        off = nd - 3
        out[off] = _batch_entry(mesh, sh[off])
        if div(sh[-1]):
            out[-1] = "model"
    else:
        # [*lead, B, F] recurrent vector state.
        off = nd - 2
        out[off] = _batch_entry(mesh, sh[off])
        if div(sh[-1]):
            out[-1] = "model"
    return P(*out)


def serve_state_shardings(state: Any, mesh) -> Any:
    """Shardings for a ``models.api.make_serve_state`` tree (by leaf name
    and rank), the reference's rule.

    KV caches [*, B, H, S, hd]: batch over batch axes; heads over 'model'
    when divisible, else the cache SEQUENCE shards over 'model'. Recurrent
    states shard features/heads over 'model'. Leaves that are not arrays
    are left out (None)."""
    def walk(node, name=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, name) for v in node)
        if not hasattr(node, "shape"):
            return None
        return NamedSharding(mesh, _leaf_spec(name, tuple(node.shape), mesh))
    return walk(state)
