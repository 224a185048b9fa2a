"""The train step — the port of ``repro/train/step.py``: the loss's
gradients by autograd, then AdamW.

:func:`make_train_step` returns ``train_step(params, opt_state, batch) ->
(params, opt_state, metrics)``. The parameters are a plain tree of tensors
that need not require grad: the step differentiates detached aliases of
them (``torch.autograd.grad``) and then updates them, and the moments, in
place (``optim/adamw.py``). With ``microbatches > 1`` the batch is split as
the reference splits it (microbatch m takes rows m, m + mb, ...), the
gradients are summed in ``accum_dtype`` and divided by the count, and the
loss is averaged. The reference's ``make_serve_steps`` (serving programs
for the dry run) waits for the distributed layers.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import api
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves, tree_map


def make_train_step(
    cfg: ArchConfig,
    opt_cfg: adamw.AdamWConfig,
    lr_fn: Optional[Callable] = None,
    microbatches: int = 1,
    remat: bool = True,
    accum_dtype=torch.float32,
    tiles=None,
):
    lr_fn = lr_fn or (lambda step: torch.tensor(3e-4, dtype=torch.float32))

    def loss_and_grads(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, metrics = api.train_loss(live, cfg, batch, remat=remat,
                                       tiles=tiles)
        grads = iter(torch.autograd.grad(loss, tree_leaves(live)))
        return ({k: v.detach() for k, v in metrics.items()},
                tree_map(lambda _: next(grads), params))

    def train_step(params, opt_state, batch):
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
        lr = lr_fn(opt_state["step"])
        params, opt_state, om = adamw.apply_updates(
            params, grads, opt_state, opt_cfg, lr)
        metrics = dict(metrics)
        metrics.update(om)
        metrics["lr"] = lr
        return params, opt_state, metrics

    return train_step
