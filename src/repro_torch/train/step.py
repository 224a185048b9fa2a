"""The train step — the port of ``repro/train/step.py``: the loss's
gradients by autograd, then AdamW.

:func:`make_train_step` returns ``train_step(params, opt_state, batch) ->
(params, opt_state, metrics)``. The parameters are a plain tree of tensors
that need not require grad: the step differentiates detached aliases of
them (``torch.autograd.grad``) and then updates them, and the moments, in
place (``optim/adamw.py``). With ``microbatches > 1`` the batch is split as
the reference splits it (microbatch m takes rows m, m + mb, ...), the
gradients are summed in ``accum_dtype`` and divided by the count, and the
loss is averaged.

On a mesh (``ctx``, a ``DistContext``: the reference's second argument, a
keyword here so that the one-device calls keep their form) the step is what
each rank runs: ``batch`` is the rank's rows of the global batch
(``sharding_rules.local_batch``); with more than one model rank, or with
FSDP over more than one data rank, the parameters, gradients and moments
are the rank's blocks (``api.rank_shardings``: the dense layers and the
recurrent mixers tensor-parallel, the MoE layers expert-parallel, every
decoder leaf's data block under FSDP) and the clip's norm sums each leaf's
squares over the axes its blocks are spread over (``adamw.global_norm``).
The loss and the gradients are averaged over the batch axes before AdamW,
so the loss is the global batch's mean: a leaf whole over the data axis
is all-reduced over the batch group (which shares a model coordinate, so
it averages one block), so the ranks of one model coordinate take the
same update; a
data block comes out of the layer gather's backward already summed over
the data group (a reduce-scatter), is divided by the batch group's size
and, on a mesh with a pod axis, summed over the pod group first. The
microbatches accumulate the blocks.
:func:`make_serve_steps` is the reference's ``(prefill, decode)`` pair.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import collectives
from repro_torch.models import api
from repro_torch.models.context import DistContext, has_mesh, holds_blocks
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves, tree_map


def make_grad_step(
    cfg: ArchConfig,
    microbatches: int = 1,
    remat: bool = True,
    accum_dtype=torch.float32,
    tiles=None,
    ctx: Optional[DistContext] = None,
):
    """``grad_step(params, batch) -> (metrics, grads)``: the train step
    before AdamW — the loss and its gradients over the microbatches, and on
    a mesh both averaged over the batch axes."""
    data_split = None
    if has_mesh(ctx):
        data_split = tree_map(lambda sh: "data" in sh.axes,
                              api.rank_shardings(cfg, ctx))

    def loss_and_grads(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, metrics = api.train_loss(live, cfg, batch, remat=remat,
                                       tiles=tiles, ctx=ctx)
        grads = iter(torch.autograd.grad(loss, tree_leaves(live)))
        return ({k: v.detach() for k, v in metrics.items()},
                tree_map(lambda _: next(grads), params))

    def grad_step(params, batch):
        if microbatches == 1:
            metrics, grads = loss_and_grads(params, batch)
        else:
            rows = len(batch["tokens"])
            assert rows % microbatches == 0, (rows, microbatches)
            grads = tree_map(
                lambda p: torch.zeros(p.shape, dtype=accum_dtype,
                                      device=p.device), params)
            loss = None
            for m in range(microbatches):
                # Strided split, the reference's: rows m, m + mb, ...
                mb = {k: v[m::microbatches] for k, v in batch.items()}
                mm, g = loss_and_grads(params, mb)
                grads = tree_map(lambda a, b: a + b.to(a.dtype), grads, g)
                loss = mm["loss"] if loss is None else loss + mm["loss"]
            count = torch.tensor(float(microbatches), dtype=torch.float32,
                                 device=loss.device)
            grads = tree_map(lambda g: g / count.to(g.dtype), grads)
            metrics = {"loss": loss / count}
        if has_mesh(ctx):
            metrics, grads = _batch_mean(metrics, grads, ctx, data_split)
        return metrics, grads

    return grad_step


def _batch_mean(metrics, grads, ctx: DistContext, data_split):
    """The metrics and the gradients averaged over the batch axes' group
    (each rank's are over its rows, equal in number). ``data_split`` (a
    bool a leaf, paired by key): the gradient is a data block, which the
    layer gather's backward summed over the data group already; it is
    summed over the other batch axes (a pod axis) only."""
    n = ctx.axis_size("batch")
    if n == 1:
        return metrics, grads
    group = ctx.group("batch")
    rest = tuple(a for a in ctx.batch_axes if a != "data")

    def mean(x, data_block=False):
        count = torch.tensor(float(n), dtype=x.dtype, device=x.device)
        if not data_block:
            return collectives.all_reduce(x, "sum", group) / count
        if rest:
            x = collectives.all_reduce(x, "sum", ctx.mesh.group(rest))
        return x / count

    return ({k: mean(v) for k, v in metrics.items()},
            tree_map(mean, grads, data_split))


def make_train_step(
    cfg: ArchConfig,
    opt_cfg: adamw.AdamWConfig,
    lr_fn: Optional[Callable] = None,
    microbatches: int = 1,
    remat: bool = True,
    accum_dtype=torch.float32,
    tiles=None,
    ctx: Optional[DistContext] = None,
):
    """``train_step(params, opt_state, batch)``; ``train_step.grad_step``
    is its :func:`make_grad_step`, and ``train_step.split`` /
    ``train_step.group`` the clip's mesh axes a leaf and their groups
    (``adamw.global_norm``; None where a rank holds the whole tree), for
    callers that split the step."""
    lr_fn = lr_fn or (lambda step: torch.tensor(3e-4, dtype=torch.float32))
    grad_step = make_grad_step(cfg, microbatches, remat, accum_dtype, tiles,
                               ctx)
    split = group = None
    if holds_blocks(ctx):
        split = tree_map(lambda sh: sh.axes, api.rank_shardings(cfg, ctx))
        group = ctx.mesh.group

    def train_step(params, opt_state, batch):
        metrics, grads = grad_step(params, batch)
        lr = lr_fn(opt_state["step"])
        params, opt_state, om = adamw.apply_updates(
            params, grads, opt_state, opt_cfg, lr, split=split, group=group)
        metrics = dict(metrics)
        metrics.update(om)
        metrics["lr"] = lr
        return params, opt_state, metrics

    train_step.grad_step = grad_step
    train_step.split, train_step.group = split, group
    return train_step


def make_serve_steps(cfg: ArchConfig, ctx: Optional[DistContext],
                     max_len: int, dtype=torch.float32, tiles=None):
    """(prefill_fn, decode_fn) pair for serving, the reference's: window
    (local) attention layers keep ring caches, their KV being the window
    whatever the context length. On a mesh each rank serves its rows with
    its blocks of the parameters."""

    def prefill_step(params, batch):
        return api.prefill(params, cfg, batch, max_len=max_len, dtype=dtype,
                           ctx=ctx, ring_local=bool(cfg.attn_window),
                           tiles=tiles)

    def decode_step(params, token, state):
        return api.decode_step(params, cfg, token, state, ctx=ctx,
                               tiles=tiles)

    return prefill_step, decode_step
