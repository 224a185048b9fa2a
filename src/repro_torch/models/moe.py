"""Mixture-of-Experts block — the port's ``repro/models/moe.py``: one
device, and expert-parallel over a mesh's model axis.

Routing is the reference's exactly: a float32 softmax router, top-k, the
optional renormalisation of the k gates (floor 1e-9) and the Switch
load-balance aux loss. Dispatch is its capacity-based gather: a **stable**
sort of the pairs' expert ids makes each expert's pairs a contiguous group
in token order, the first ``C = max(8, int(T*k*cf/E) + 1)`` of a group
fill its ``[E, C]`` slots and the rest drop, so the same pairs drop as in
the reference. The routed experts run as one batched product over the
static ``[E, C, D]`` gather (``torch.bmm``; the reference's ``einsum`` runs
outside any Pallas kernel too), the shared experts through the port's
matmul kernel (``kernels/matmul/ops.py:mm``) on CUDA tensors.

The combine differs in form from the reference's scatter-add, not in what
it sums: each (token, k) pair finds its slot by inverting the sort, reads
its expert's output row back, and the k contributions of a token are summed
in a fixed order, so the result does not depend on the order of atomic
adds. Nothing reads back to the host (group sizes come from a
``scatter_add_``, not ``bincount``; no boolean indexing), so a decode step
through this block can be captured in a CUDA graph.

On a mesh with more than one model rank (``moe_forward(ctx=)``, the
reference's ``_moe_forward_sharded``) the experts split over the model
axis: model rank ``i`` holds its block of ``n_experts / n`` experts from
``i * n_local`` (``api.rank_shardings``) and runs
:func:`moe_apply_local` on it over its batch rows; the shared experts split
over ``ff`` inside the body (the rank's columns of ``shared_w1`` /
``shared_w3``, its rows of ``shared_w2``), as the reference's do; the
ranks sum ``y`` over the model group and average ``aux``. Under grad the
body's replicated inputs (the tokens and the router) enter through
``collectives.copy_to_group``, whose backward sums the ranks' partial
cotangents, and ``y`` leaves through ``sum_from_group``, whose backward
passes the (replicated) cotangent through; a rank's expert blocks take
their own gradients, so every rank ends with the one-device gradient of
every weight it holds. Under FSDP the expert leaves arrive gathered over
the data group with the rest of their layer (``transformer.forward``),
the counterpart of the reference body's all-gather over ``data``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import collectives
from repro_torch.kernels.matmul.ops import mm
from repro_torch.kernels.matmul.ref import matmul_ref
from repro_torch.models.context import (
    DistContext, local_range, tensor_parallel,
)
from repro_torch.models.layers import ParamDef, act_fn


def moe_defs(cfg: ArchConfig) -> Dict[str, ParamDef]:
    m = cfg.moe
    d = cfg.d_model
    defs = {
        "router": ParamDef((d, m.n_experts), ("d_model", None), scale=0.1),
        "w1": ParamDef((m.n_experts, d, m.d_expert), ("experts", "d_model", None)),
        "w3": ParamDef((m.n_experts, d, m.d_expert), ("experts", "d_model", None)),
        "w2": ParamDef((m.n_experts, m.d_expert, d), ("experts", None, "d_model")),
    }
    if m.n_shared_experts:
        ds = m.d_shared or m.n_shared_experts * m.d_expert
        defs["shared_w1"] = ParamDef((d, ds), ("d_model", "ff"))
        defs["shared_w3"] = ParamDef((d, ds), ("d_model", "ff"))
        defs["shared_w2"] = ParamDef((ds, d), ("ff", "d_model"))
    return defs


def _capacity(n_tokens: int, cfg: ArchConfig) -> int:
    m = cfg.moe
    c = int(n_tokens * m.top_k * m.capacity_factor / m.n_experts) + 1
    return max(8, c)


def _route(p, cfg: ArchConfig, x2d):
    """``(probs [T, E], gates [T, k], eidx [T, k])`` in float32."""
    m = cfg.moe
    logits = torch.matmul(x2d.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, m.top_k, dim=-1)
    if m.renorm_gates:
        gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    return probs, gates, eidx


def _counts(ids, length: int) -> torch.Tensor:
    """How many of ``ids`` fall on each of ``length`` values, on the device
    (``bincount`` would read its size back to the host)."""
    return torch.zeros(length, dtype=torch.long, device=ids.device) \
        .scatter_add_(0, ids, torch.ones_like(ids))


def dispatch(eidx, n_local: int, local_offset: int, cap: int):
    """The reference's slot layout for the flattened (token, k) pairs.

    Returns ``(pair [E_loc, C], valid [E_loc, C], expert [T*k],
    slot [T*k], kept [T*k])``: the pair filling each expert slot (valid
    while the slot lies within its group), and for each pair its local
    expert, its slot in that expert's group and whether it was kept (local,
    and within capacity)."""
    flat_e = eidx.reshape(-1)
    n_pairs = flat_e.shape[0]
    local_id = flat_e - local_offset
    is_local = (local_id >= 0) & (local_id < n_local)
    key = torch.where(is_local, local_id, torch.full_like(local_id, n_local))
    order = torch.argsort(key, stable=True)
    sizes = _counts(key, n_local + 1)[:n_local]
    starts = torch.cumsum(sizes, 0) - sizes
    c = torch.arange(cap, device=eidx.device)
    pair = order[torch.clamp(starts[:, None] + c[None, :], 0, n_pairs - 1)]
    valid = c[None, :] < sizes[:, None]
    # Each pair's rank in the sort, then its slot within its group.
    rank = torch.empty_like(order).scatter_(
        0, order, torch.arange(n_pairs, device=eidx.device))
    expert = torch.clamp(key, max=n_local - 1)
    slot = rank - starts[expert]
    kept = is_local & (slot < cap)
    return pair, valid, expert, slot, kept


def moe_apply_local(
    p: Dict[str, Any], cfg: ArchConfig, x2d: torch.Tensor,
    n_local: int, local_offset: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Local experts' contribution for the tokens ``x2d`` [T, D].

    ``p``'s ``w1``/``w3``/``w2`` hold the ``n_local`` experts from
    ``local_offset`` on. Returns (partial_out [T, D], aux_loss scalar
    float32); a pair routed to an expert outside the shard contributes
    nothing here."""
    m = cfg.moe
    t, d = x2d.shape
    k = m.top_k
    cap = _capacity(t, cfg)
    probs, gates, eidx = _route(p, cfg, x2d)

    # Load-balance aux (Switch): E * sum_e f_e * P_e over the full expert set.
    f = _counts(eidx[:, 0], m.n_experts).float() / t
    pbar = probs.mean(dim=0)
    aux = m.n_experts * torch.sum(f * pbar) * m.router_aux_weight

    pair, valid, expert, slot, kept = dispatch(eidx, n_local, local_offset,
                                               cap)
    tok = pair // k
    xg = x2d[tok] * valid[..., None].to(x2d.dtype)          # [E_loc, C, D]
    act = act_fn(cfg.act)
    h = act(torch.bmm(xg, p["w1"].to(x2d.dtype)))
    h = h * torch.bmm(xg, p["w3"].to(x2d.dtype))
    out_e = torch.bmm(h, p["w2"].to(x2d.dtype))             # [E_loc, C, D]

    # Combine: each pair reads its slot's row back; a token sums its k.
    row = expert * cap + torch.clamp(slot, 0, cap - 1)
    g = gates.reshape(-1) * kept
    contrib = out_e.reshape(-1, d)[row] * g[:, None].to(out_e.dtype)
    y = contrib.reshape(t, k, d).sum(dim=1)
    return y, aux.float()


def _shared_ff(p, cfg: ArchConfig, x2d, impl: str = "auto"):
    """The always-on shared experts, one SwiGLU FF: through the matmul
    kernel on CUDA tensors (its default tile), :func:`matmul_ref` on CPU
    tensors or with ``impl="reference"`` (the reference's ``@``)."""
    gemm = matmul_ref if impl == "reference" else mm
    act = act_fn(cfg.act)
    h = act(gemm(x2d, p["shared_w1"].to(x2d.dtype)))
    h = h * gemm(x2d, p["shared_w3"].to(x2d.dtype))
    return gemm(h, p["shared_w2"].to(x2d.dtype))


def moe_forward(p: Dict[str, Any], cfg: ArchConfig, x: torch.Tensor,
                impl: str = "auto", ctx: Optional[DistContext] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (y [B, S, D], aux scalar). The B*S tokens share one
    capacity, as in the reference. With more than one model rank, the
    rank's rows through its experts (:func:`_moe_forward_sharded`)."""
    b, s, d = x.shape
    m = cfg.moe
    x2d = x.reshape(-1, d)
    if tensor_parallel(ctx):
        y, aux = _moe_forward_sharded(p, cfg, x2d, ctx, impl)
    else:
        y, aux = moe_apply_local(p, cfg, x2d, m.n_experts, 0)
        if m.n_shared_experts:
            y = y + _shared_ff(p, cfg, x2d, impl)
    return y.reshape(b, s, d), aux


def _moe_forward_sharded(p, cfg: ArchConfig, x2d, ctx: DistContext,
                         impl: str = "auto"):
    """The expert-parallel body over the model group: this rank's experts'
    contribution (its block of ``w1`` / ``w3`` / ``w2``) and its columns of
    the shared experts, summed over the ranks, and the mean of their aux.
    Shared experts whose width the ranks do not divide are held whole and
    run after the sum."""
    m = cfg.moe
    n = ctx.model_size
    block = local_range(ctx, "experts", m.n_experts)
    if block is None:
        raise ValueError(
            f"{cfg.name}: {m.n_experts} experts not divisible by "
            f"model axis {n}")
    off, stop = block
    group = ctx.model_group
    xin = collectives.copy_to_group(x2d, group)
    local = {"router": collectives.copy_to_group(p["router"], group),
             "w1": p["w1"], "w3": p["w3"], "w2": p["w2"]}
    y, aux = moe_apply_local(local, cfg, xin, stop - off, off)
    shared_inside = False
    if m.n_shared_experts:
        width = m.d_shared or m.n_shared_experts * m.d_expert
        shared_inside = local_range(ctx, "ff", width) is not None
        if shared_inside:
            y = y + _shared_ff(p, cfg, xin, impl)
    y = collectives.sum_from_group(y, group)
    if m.n_shared_experts and not shared_inside:
        y = y + _shared_ff(p, cfg, x2d, impl)
    return y, collectives.mean_from_group(aux, group)
