"""DistContext: how model code sees the mesh without naming mesh axes — the
port's ``repro/models/context.py``.

``None`` context (or one without a mesh) = one device, every existing path.
With a mesh, the reference lets GSPMD partition the model under logical
sharding constraints and runs two bodies by hand (``shard_map``); the port
has no GSPMD, so it writes out what each rank computes (explicit SPMD, one
process a rank):

* a rank takes the batch rows of its coordinate on the batch axes;
* with more than one model rank it holds its block of every leaf the
  reference's ``param_spec(..., fsdp=False)`` splits over the model axis
  among the attention, dense FF, MoE, RG-LRU, SSD, ``embed`` and
  ``lm_head`` leaves, an encoder-decoder's attention, FF and tied
  embedding among them (``models/api.py:rank_shardings``), and computes
  those layers Megatron-style on it: column-parallel in, row-parallel out,
  one sum over the model group a block (``distributed/collectives.py``);
  a recurrent block keeps its block of the serve state (its features, its
  SSD heads). The blocks and every module's ranges come from
  :func:`local_range`, the logical axis alone deciding (with the whole
  units an axis is made of, ``ParamDef.units``: an SSD block splits by
  its heads), so the rule lives once. The other leaves (norms, the
  router, an SSD block's ``in_B`` / ``in_C`` and their convs) stay whole
  over the model axis and are computed whole on every rank;
* with FSDP (``DistContext.fsdp``, on by default as the reference's is)
  and more than one data rank, a rank also holds only its data block of
  every leaf, on the dim :func:`data_dim` picks (the reference's
  ``param_spec(..., fsdp=True)`` test on the dims the model ranks leave
  whole). The model gathers a layer's blocks over the data group before
  it uses them and frees them after (``transformer.forward``,
  ``encdec.encode`` and its decoder passes); the gather's backward
  reduce-scatters the gradients. GPipe's stage weights stay whole;
* the expert-parallel MoE (``models/moe.py``) and the sequence-sharded
  decode (``models/attention.py``) run collectives over the model axis's
  process group, at the rank's coordinate (:meth:`DistContext.axis_index`,
  the reference's ``axis_index``).

:meth:`DistContext.constrain` only states a layout and returns ``x``
unchanged, as the reference's does without a mesh: the port's layouts are
the blocks each module computes on. The logical -> mesh axis mapping is the
reference's ``rules`` (and ``distributed/sharding_rules.py``);
:meth:`DistContext.spec_for` gives the port's :class:`PartitionSpec`, a
tuple with the reference's entries.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple


class PartitionSpec(tuple):
    """A tuple of mesh-axis entries, one per array dim: ``None``
    (replicated), an axis name, or a tuple of names. Equal, as a tuple, to
    the reference's ``jax.sharding.PartitionSpec`` with the same entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


# The logical axes the port computes tensor-parallel: every axis that
# ``DistContext.rules`` (the reference's) maps onto the model axis.
TP_AXES = ("heads", "kv_heads", "ff", "vocab", "experts", "lru",
           "ssm_heads")


@dataclasses.dataclass(frozen=True)
class DistContext:
    mesh: Optional[Any] = None              # launch.mesh.Mesh
    batch_axes: Tuple[str, ...] = ("data",)   # axes sharding the batch dim
    model_axis: str = "model"                 # TP / EP axis
    fsdp: bool = True                         # parameters split over data
    # Logical axis name -> mesh axis (None = replicated).
    rules: Tuple[Tuple[str, Optional[object]], ...] = (
        ("batch", None),        # filled from batch_axes by spec_for
        ("seq", None),
        ("d_model", None),
        ("heads", "model"),
        ("kv_heads", "model"),
        ("ff", "model"),
        ("vocab", "model"),
        ("experts", "model"),
        ("lru", "model"),
        ("ssm_heads", "model"),
    )

    def spec_for(self, logical_axes: Tuple[Optional[str], ...]
                 ) -> PartitionSpec:
        table = dict(self.rules)
        out = []
        for ax in logical_axes:
            if ax == "batch":
                out.append(self.batch_axes if len(self.batch_axes) > 1
                           else self.batch_axes[0])
            elif ax is None:
                out.append(None)
            else:
                out.append(table.get(ax))
        return PartitionSpec(*out)

    def constrain(self, x, *logical_axes):
        """The layout ``x`` has under :meth:`spec_for`. The port has no
        compiler to lay it out: each module computes on its rank's blocks
        (:func:`local_range`), so ``x`` comes back as it is."""
        return x

    # -- the explicit bodies' view of the mesh ------------------------------
    def _mesh(self):
        if self.mesh is None:
            raise ValueError("this context has no mesh")
        return self.mesh

    def axis_size(self, axis: str) -> int:
        """Ranks on ``axis``; ``"batch"`` is the product of the batch axes."""
        m = self._mesh()
        if axis == "batch":
            n = 1
            for a in self.batch_axes:
                n *= m.shape[a]
            return n
        return m.shape[axis]

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (on ``"batch"``, its index
        over the batch axes, the first the slowest)."""
        m = self._mesh()
        if axis == "batch":
            i = 0
            for a in self.batch_axes:
                i = i * m.shape[a] + m.coords[a]
            return i
        return m.coords[axis]

    def group(self, axis: str):
        """The process group of this rank's line along ``axis`` (``"batch"``:
        the ranks that share its model coordinate)."""
        m = self._mesh()
        if axis == "batch":
            return m.group(self.batch_axes)
        return m.group((axis,))

    @property
    def model_size(self) -> int:
        return self.axis_size(self.model_axis)

    @property
    def model_index(self) -> int:
        return self.axis_index(self.model_axis)

    @property
    def model_group(self):
        return self.group(self.model_axis)


def null_context() -> DistContext:
    return DistContext(mesh=None)


def has_mesh(ctx: Optional[DistContext]) -> bool:
    return ctx is not None and ctx.mesh is not None


def tensor_parallel(ctx: Optional[DistContext]) -> bool:
    """Whether the model axis splits the dense layers: a mesh with more
    than one model rank. A model axis of one rank is the one-device path,
    bit for bit."""
    return has_mesh(ctx) and ctx.mesh.shape.get(ctx.model_axis, 1) > 1


def _model_splits(axis: Optional[str], n: int, m: int,
                  units: Optional[int] = None) -> bool:
    # An axis of TP_AXES whose whole units (default: its n elements) the m
    # model ranks divide: param_spec's test, on the units.
    u = n if units is None else units
    return axis in TP_AXES and u % m == 0 and u >= m


def local_range(ctx: Optional[DistContext], axis: str, n: int,
                units: Optional[int] = None) -> Optional[Tuple[int, int]]:
    """This rank's ``[start, stop)`` along a logical ``axis`` of size ``n``
    where the model ranks split it, else None (the rank computes it whole).
    They split an axis of :data:`TP_AXES` that they divide, ``param_spec``'s
    test, and nothing without :func:`tensor_parallel`. ``units``: the whole
    units the axis is made of, which no block may cut (an SSD block's
    ``d_inner`` is ``head_dim`` columns of each head): then the ranks must
    divide ``units``, where the reference tests the size alone."""
    if not tensor_parallel(ctx):
        return None
    m = ctx.model_size
    if not _model_splits(axis, n, m, units):
        return None
    i = ctx.model_index
    return i * (n // m), (i + 1) * (n // m)


def data_sharded(ctx: Optional[DistContext]) -> bool:
    """Whether FSDP splits the parameters over the data axis: on
    (``ctx.fsdp``), on a mesh whose data axis has more than one rank."""
    return (has_mesh(ctx) and ctx.fsdp
            and ctx.mesh.shape.get("data", 1) > 1)


def holds_blocks(ctx: Optional[DistContext]) -> bool:
    """Whether a rank holds blocks of the parameters rather than the whole
    tree: tensor parallelism or FSDP."""
    return tensor_parallel(ctx) or data_sharded(ctx)


def data_dim(ctx: Optional[DistContext], axes: Tuple[Optional[str], ...],
             shape: Tuple[int, ...], units: Optional[int] = None
             ) -> Optional[int]:
    """The dim of a leaf (its logical ``axes``, its whole ``shape``, the
    ``units`` of its model-axis dims: ``ParamDef.units``) that FSDP splits
    over the data axis, or None: of the dims the model axis does not take
    (:func:`local_range`'s test, a model axis of one rank included), the
    largest that the data ranks divide, the first of equals, as
    ``param_spec(..., fsdp=True)`` picks. None without
    :func:`data_sharded`."""
    if not data_sharded(ctx):
        return None
    n, m = ctx.mesh.shape["data"], ctx.mesh.shape.get(ctx.model_axis, 1)
    free = [i for i, (ax, k) in enumerate(zip(axes, shape))
            if not _model_splits(ax, k, m, units)]
    for i in sorted(free, key=lambda i: -shape[i]):
        if shape[i] % n == 0 and shape[i] >= n:
            return i
    return None
