"""Error-feedback int8 gradient compression for the data-parallel all-reduce
— the port's ``repro/optim/compression.py``.

Gradients are quantized to int8 with a per-tensor scale before the
all-reduce and dequantized after; the quantization residual is carried in
an error-feedback buffer so the compression is unbiased over time
(1-bit-Adam-style EF). The int8 payload is summed as int32 (no overflow)
and the scales are averaged, in the reference's order of operations. The
reference runs inside a ``shard_map`` over the batch axes; the port over the
process group of those axes (``DistContext.group("batch")``), a 4x smaller
payload than the float32 gradients' at the cost of one buffer of the
parameters' size. Trees are the parameters' (dicts and lists of tensors).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed import collectives
from repro_torch.optim.adamw import tree_leaves, tree_map


def init_error(params) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q int8, scale float32 0-d)``: ``scale = max|x| / 127 + 1e-12`` and
    ``q = clip(round(x / scale), -127, 127)`` (round half to even, as
    ``jnp.round``)."""
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_psum(grads, error, group=None) -> Tuple[Any, Any]:
    """Quantize (grad + error), sum the int8 over ``group``, dequantize.

    Returns (mean-reduced grads, new error buffers). Every rank of
    ``group`` calls it with trees of one structure."""
    n_dev = dist.get_world_size(group)

    def one(g, e):
        x = g.to(torch.float32) + e
        q, scale = _quantize(x)
        deq_local = q.to(torch.float32) * scale
        new_e = x - deq_local                       # residual kept locally
        # int8 payload summed in int32 to avoid overflow; scales averaged.
        summed = collectives.all_reduce(q.to(torch.int32), "sum", group)
        scale_sum = collectives.all_reduce(scale, "sum", group)
        deq = summed.to(torch.float32) * (scale_sum / n_dev)
        return (deq / n_dev).to(g.dtype), new_e

    out = [one(g, e) for g, e in zip(tree_leaves(grads), tree_leaves(error))]
    it_g = iter(o[0] for o in out)
    it_e = iter(o[1] for o in out)
    return (tree_map(lambda _: next(it_g), grads),
            tree_map(lambda _: next(it_e), grads))
