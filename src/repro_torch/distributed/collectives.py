"""The collectives of the port's explicit SPMD bodies, and their gradients.

The reference writes its two ``shard_map`` bodies (the expert-parallel MoE
and the sequence-sharded decode) and its pipeline with ``jax.lax``
collectives; the port runs the same bodies on one process a rank, with
``torch.distributed`` over a process group:

* ``pmax`` -> :func:`all_reduce` ``"max"``; ``psum`` / ``pmean`` ->
  ``"sum"`` (divided by the group size for the mean);
* ``all_gather(tiled=True)`` -> :func:`all_gather` (``all_gather_into_tensor``
  along dim 0, the gathered dim moved there and back);
* ``ppermute`` -> :func:`permute` (``batch_isend_irecv``);
* ``psum_scatter(tiled=True)`` -> :func:`reduce_scatter`
  (``reduce_scatter_tensor`` along dim 0, moved as for the gather);
* ``axis_index`` -> the rank's coordinate (``models/context.py``).

Every rank must call the same collectives in the same order; nothing here
branches around one. On ``meta`` tensors (a dry run's count, under a fake
process group) each call records its kind and result bytes in the open
count (``roofline/count.py``) and moves nothing: no host staging, no
transfer.

gloo on CUDA tensors. gloo reduces and broadcasts CUDA tensors, but it has
no CUDA all-gather or reduce-scatter and its point-to-point sends take
host tensors. For those three, a CUDA tensor under a gloo group is copied
through pinned host memory here, explicitly; the compute stays on the
card. This is how several
ranks share one card (NCCL cannot put two ranks on one GPU); in production
NCCL runs every collective on the device.

Under grad (the train step, the pipeline) the model-axis sums are
``autograd.Function`` s with the cotangents a replicated computation needs:
each rank of a group computes the same loss from the group's sum, so

* :func:`sum_from_group` (the body's closing ``psum``) sums forward and
  passes its cotangent through unchanged backward: every rank already
  holds the whole cotangent of the sum;
* :func:`copy_to_group` (a value entering the body: its input and the
  weights it reads) is the identity forward and sums the ranks' partial
  cotangents backward;
* :func:`mean_from_group` (the aux loss's ``pmean``) averages forward and
  divides its cotangent by the group size backward;
* :func:`gather_from_group` (FSDP: a parameter's data blocks gathered
  whole before use) all-gathers forward and reduce-scatters its cotangent
  backward: each rank's whole-leaf cotangent is over its own rows, so the
  sum of the ranks' cotangents of its block is its block's gradient over
  the group's rows (the step divides it by the group size);
* :func:`sum_scatter_from_group` (a row-parallel product whose output a
  column-parallel op continues: the RG-LRU gates, ``xa`` on the rank's
  rows of ``wr`` / ``wi``) reduce-scatters forward, each rank keeping its
  block of the ranks' partial sums, and all-gathers its cotangent
  backward: the transpose of :func:`gather_from_group`. A
  :func:`sum_from_group` and a slice would hand each rank only its own
  block's cotangent;
* :func:`sum_partials` (the ranks' partial sums of a quantity that every
  rank then uses for its own block alone: the mean of squares of the SSD
  block's gated norm over its whole ``d_inner``) all-reduces forward and
  backward, since each rank's cotangent of the sum is partial too.

A differentiable ``all_reduce`` whose backward is another all-reduce would
count a replicated cotangent once a rank, the group size too often: only
:func:`sum_partials` has one, for a cotangent that is not replicated.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.roofline import count as _count
from repro_torch.roofline.analysis import result_bytes

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _host_staged(x: torch.Tensor, group) -> bool:
    """A CUDA tensor under a gloo group: gloo has no CUDA all-gather or
    point-to-point, so these go through pinned host memory."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(x: torch.Tensor) -> torch.Tensor:
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    return h


def _counted(kind: str, out: torch.Tensor, group) -> bool:
    """On a ``meta`` tensor (a dry run's count): record the call's kind and
    result bytes in the open count and return True; the caller then skips
    the transfer (no data exists, nothing is staged). A group of one rank
    moves nothing and records nothing. False off ``meta``."""
    if not out.is_meta:
        return False
    count = _count.active()
    if count is not None and dist.get_world_size(group) > 1:
        count.collective(kind, result_bytes([(out.shape, out.dtype)]))
    return True


def all_reduce(x: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """A new tensor: ``x`` reduced over ``group`` (gloo and NCCL reduce CUDA
    tensors in place, so nothing is staged)."""
    out = x.detach().clone().contiguous()
    if _counted("all-reduce", out, group):
        return out
    dist.all_reduce(out, op=_OPS[op], group=group)
    return out


def all_gather(x: torch.Tensor, dim: int = 0, group=None) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order (the
    reference's ``all_gather(tiled=True)``)."""
    n = dist.get_world_size(group)
    if n == 1:
        return x.detach().clone()
    moved = x.detach().movedim(dim, 0).contiguous()
    if moved.is_meta:
        out = moved.new_empty((n * moved.shape[0],) + moved.shape[1:])
        _counted("all-gather", out, group)
        return out.movedim(0, dim).contiguous()
    if _host_staged(x, group):
        src = _to_host(moved)
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=group)
        out = torch.cat(parts).to(x.device)
    else:
        out = torch.empty((n * moved.shape[0],) + moved.shape[1:],
                          dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, moved, group=group)
    return out.movedim(0, dim).contiguous()


def reduce_scatter(x: torch.Tensor, dim: int = 0,
                   group=None) -> torch.Tensor:
    """This rank's block of ``x`` summed over ``group``: ``dim`` cut into
    the group's size of blocks in rank order, group rank ``r`` getting
    block ``r`` of the ranks' sum (the reference's ``psum_scatter(
    tiled=True)``). Raises when the group's size does not divide ``dim``."""
    n = dist.get_world_size(group)
    if n == 1:
        return x.detach().clone()
    moved = x.detach().movedim(dim, 0).contiguous()
    if moved.shape[0] % n:
        raise ValueError(f"a dim of {moved.shape[0]} does not split over "
                         f"{n} ranks")
    shape = (moved.shape[0] // n,) + moved.shape[1:]
    if moved.is_meta:
        out = moved.new_empty(shape)
        _counted("reduce-scatter", out, group)
        return out.movedim(0, dim).contiguous()
    if _host_staged(x, group):
        src = _to_host(moved)
        out = torch.empty(shape, dtype=x.dtype, pin_memory=True)
        dist.reduce_scatter_tensor(out, src, group=group)
        out = out.to(x.device)
    else:
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, moved, group=group)
    return out.movedim(0, dim).contiguous()


def permute(x: torch.Tensor, pairs: Sequence[Tuple[int, int]],
            group=None) -> torch.Tensor:
    """The reference's ``ppermute``: the group rank ``src`` of each
    ``(src, dst)`` pair sends its ``x`` to ``dst``; a rank that receives
    nothing gets zeros. Ranks are the group's own."""
    me = dist.get_rank(group)
    if x.is_meta:
        recv = torch.empty_like(x.detach().contiguous())
        _counted("collective-permute", recv, group)
        return recv
    staged = _host_staged(x, group)
    send = x.detach().contiguous()
    if staged:
        send = _to_host(send)
    recv = torch.zeros_like(send)
    ops = []
    for src, dst in pairs:
        if src == me:
            ops.append(dist.P2POp(dist.isend, send,
                                  dist.get_global_rank(group, dst)
                                  if group is not None else dst, group))
        if dst == me:
            ops.append(dist.P2POp(dist.irecv, recv,
                                  dist.get_global_rank(group, src)
                                  if group is not None else src, group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return recv.to(x.device) if staged else recv


class _SumFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, "sum", ctx.group), None


class _MeanFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.n = dist.get_world_size(group)
        return all_reduce(x, "sum", group) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def sum_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """``psum`` over ``group``; backward passes the cotangent through."""
    return _SumFromGroup.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is; backward sums the ranks' cotangents. Outside grad
    mode it is ``x`` itself."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToGroup.apply(x, group)


def mean_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """``pmean`` over ``group``; backward divides the cotangent by the
    group size."""
    return _MeanFromGroup.apply(x, group)


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.group), None, None


def gather_from_group(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' blocks ``x`` concatenated along ``dim`` (:func:`all_gather`);
    backward, :func:`reduce_scatter` of the cotangent: this rank's block of
    the ranks' summed cotangents. Outside grad mode, the gather alone."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return all_gather(x, dim, group)
    return _GatherFromGroup.apply(x, dim, group)


class _SumScatterFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.group), None, None


def sum_scatter_from_group(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block along ``dim`` of the ranks' partial sums ``x``
    (:func:`reduce_scatter`); backward, :func:`all_gather` of the blocks'
    cotangents: every rank's partial sum feeds every block. Outside grad
    mode, the reduce-scatter alone."""
    dim = dim % x.dim()
    if not (torch.is_grad_enabled() and x.requires_grad):
        return reduce_scatter(x, dim, group)
    return _SumScatterFromGroup.apply(x, dim, group)


class _SumPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, "sum", ctx.group), None


def sum_partials(x: torch.Tensor, group) -> torch.Tensor:
    """``psum`` of the ranks' partial sums ``x`` whose result each rank
    uses for its own block alone; backward sums the ranks' cotangents
    (``sum_from_group(copy_to_group(x))``, one call each way). Outside
    grad mode, the all-reduce alone."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return all_reduce(x, "sum", group)
    return _SumPartials.apply(x, group)


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pairs, group):
        ctx.pairs, ctx.group = pairs, group
        return permute(x, pairs, group)

    @staticmethod
    def backward(ctx, g):
        back = tuple((dst, src) for src, dst in ctx.pairs)
        return permute(g, back, ctx.group), None, None


def permute_grad(x: torch.Tensor, pairs: Sequence[Tuple[int, int]],
                 group=None) -> torch.Tensor:
    """:func:`permute` whose backward is the reverse permute (the
    transpose of ``ppermute``): a rank that received nothing forward sends
    nothing back, and a rank that sent nothing receives zeros."""
    return _Permute.apply(x, tuple(pairs), group)

