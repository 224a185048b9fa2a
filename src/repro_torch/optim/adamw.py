"""AdamW with dtype policies, decoupled weight decay and global-norm clip —
the port of ``repro/optim/adamw.py`` (not a Pallas kernel there: plain
tensor ops here).

A parameter tree is nested dicts, lists and tuples of tensors. The moments
may be kept in bfloat16 (``moment_dtype``); the update math is float32, and
so are the bias corrections (``b1 ** step`` on a float32 step), the clip
scale and the learning rate, as the reference computes them: Python floats
would drift from it at about 1e-8. Every division is a tensor by a tensor
(PyTorch takes ``scalar / t`` as ``t.reciprocal() * scalar``).

Unlike the reference, which returns new arrays, :func:`apply_updates`
writes the new parameters and moments into the given tensors (no second
copy of a 1.5 B-parameter model on the card) and returns them with a new
step counter.

On a mesh a rank holds blocks of some leaves (over the model axis, and
with FSDP over the data axis) and the whole of the others;
:func:`global_norm` (``split=``, ``group=``) then sums each leaf's squares
over the group of exactly the mesh axes its blocks are spread over and
counts the whole leaves once, so every rank clips by the one-device norm
and their blocks stay one model. The update itself is elementwise, so it
runs on a rank's blocks unchanged, its moments blocks like their
parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import torch

from repro_torch.distributed import collectives


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"   # "bfloat16" halves optimizer memory


def tree_leaves(tree) -> List[Any]:
    """The leaves of a nested dict / list / tuple, dicts in key order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure), in ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def moment_dtype(cfg: AdamWConfig) -> torch.dtype:
    return {"float32": torch.float32,
            "bfloat16": torch.bfloat16}[cfg.moment_dtype]


def init_state(params, cfg: AdamWConfig) -> Dict[str, Any]:
    dt = moment_dtype(cfg)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    device = tree_leaves(params)[0].device
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree, split=None, group=None) -> torch.Tensor:
    """The L2 norm of every leaf of ``tree``. ``split``: a tree of the
    same structure whose leaves are the mesh axes each leaf's blocks are
    spread over (``NamedSharding.axes`` of ``api.rank_shardings``), paired
    by key; ``group(axes)`` is the process group of those axes (a mesh's
    ``group``). A leaf's squares are summed over the group of its axes;
    a leaf with none is whole on every rank and counts once."""
    if split is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                              for x in tree_leaves(tree)))
    parts: Dict[Tuple[str, ...], List[torch.Tensor]] = {}
    tree_map(lambda x, axes: parts.setdefault(tuple(axes), []).append(
        torch.sum(torch.square(x.float()))), tree, split)
    zero = torch.zeros((), dtype=torch.float32,
                       device=tree_leaves(tree)[0].device)
    total = sum(parts.pop((), []), zero)
    for axes in sorted(parts):          # one order on every rank
        total = total + collectives.all_reduce(sum(parts[axes], zero),
                                               "sum", group(axes))
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params, grads, state, cfg: AdamWConfig, lr, split=None,
                  group=None
                  ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step, in place. Returns (params, new_state, metrics).
    ``split`` and ``group``: the clip's norm over a rank's blocks
    (:func:`global_norm`)."""
    gnorm = global_norm(grads, split, group)
    dev = gnorm.device
    f32 = torch.float32
    scale = torch.clamp(
        torch.tensor(cfg.clip_norm, dtype=f32, device=dev)
        / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state["step"] + 1
    stepf = step.to(f32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=f32, device=dev), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=f32, device=dev), stepf)
    if not isinstance(lr, torch.Tensor):
        lr = torch.tensor(lr, dtype=f32)
    lr = lr.to(device=dev, dtype=f32)

    def upd(p, g, m, v):
        g = g.float() * scale
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        mhat = m32 / b1c
        vhat = v32 / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m32)
        v.copy_(v32)

    tree_map(upd, params, grads, state["m"], state["v"])
    return (params, {"m": state["m"], "v": state["v"], "step": step},
            {"grad_norm": gnorm, "clip_scale": scale})
