"""GPipe-style pipeline parallelism over the ``pod`` mesh axis — the port's
``repro/distributed/pipeline.py``.

Layers split into one stage per pod rank, microbatches stream through the
stages, and activations hop to the next stage by a permute whose backward
is the reverse permute (``collectives.permute_grad``, an
``autograd.Function`` over ``batch_isend_irecv``; the first stage receives
zeros), so autograd drives the backward pipeline as ``jax.grad`` does
through ``ppermute``.

Every rank runs every tick of the schedule (``n_microbatches + n_stages -
1``) whole, masked by tensors (the embedding swap of the first stage, the
loss of the last stage's active ticks), as the reference's ``scan`` does,
with no Python branch on the stage: all ranks call the same permutes in
the same order and build autograd graphs of one shape, so the backward's
permutes and sums line up rank by rank (a rank that skipped a masked
computation would skip its collective in the backward, and its peers
would wait). The last stage's cross-entropy of each active tick is
summed, the sum is summed over the pod group
(``collectives.sum_from_group``) and divided by the number of microbatches,
so every rank returns the mean loss. The embedding and the final norm are
replicated: they enter through ``collectives.copy_to_group``, whose
backward sums the stages' cotangents, so every rank holds their whole
gradient; a stage's layer gradients live on its rank.

Scope: homogeneous decoder stacks (one LayerSpec repeated). Stage-stacked
layer parameters ``[n_stages, layers_per_stage, ...]`` shard ``P("pod")``
on their leading axis (:func:`pipeline_shardings`): a rank holds its
stage, ``[1, per, ...]``, or the whole stack (the loss takes its stage).
:func:`init_pipeline_params` draws them as the reference does, its
``fan_in`` the leading dim of the stacked shape, the stage count;
:func:`stage_params` stacks a model's own layers instead.
"""
from __future__ import annotations

from typing import Any, Dict, Union

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding_rules import NamedSharding, P
from repro_torch.models import transformer as T
from repro_torch.models.layers import ParamDef, init_tree
from repro_torch.optim.adamw import tree_map


def _stack_defs(defs, n: int):
    """ParamDefs with a leading axis of ``n`` (logical axis None)."""
    if isinstance(defs, ParamDef):
        return ParamDef((n,) + defs.shape, (None,) + defs.axes, defs.init,
                        defs.scale)
    return {k: _stack_defs(v, n) for k, v in defs.items()}


def stage_param_defs(cfg: ArchConfig, n_stages: int) -> Dict[str, Any]:
    """Layer params stacked [n_stages, layers_per_stage, ...]."""
    if cfg.n_layers % n_stages:
        raise ValueError(f"{cfg.n_layers} layers do not split into "
                         f"{n_stages} stages")
    per = cfg.n_layers // n_stages
    spec = cfg.layers()[0]
    model = T.model_defs(cfg)
    return {
        "embed": model["embed"],
        "final_norm_w": model["final_norm_w"],
        "stages": _stack_defs(_stack_defs(T.layer_defs(cfg, spec), per),
                              n_stages),
    }


def init_pipeline_params(cfg: ArchConfig, seed: Union[int, torch.Generator],
                         n_stages: int, dtype=torch.float32, device=None):
    dev = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator(device=dev).manual_seed(int(seed))
    return init_tree(stage_param_defs(cfg, n_stages), gen, dtype, dev)


def pipeline_shardings(params, mesh):
    """Stage axis -> pod; embed / final norm replicated."""
    def spec(name, node):
        if isinstance(node, dict):
            return {k: spec(name, v) for k, v in node.items()}
        return NamedSharding(mesh, P("pod") if name == "stages" else P())
    return {k: spec(k, v) for k, v in params.items()}


def _layer(stage_p, j: int):
    return tree_map(lambda a: a[j], stage_p)


def _embed(cfg: ArchConfig, embed, tokens):
    x = embed[tokens]
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _run_layers(cfg: ArchConfig, layers, x, positions):
    spec = cfg.layers()[0]
    for lp in layers:
        x, _, _ = T.layer_forward(lp, cfg, spec, x, positions, None)
    return x


def make_pipeline_loss(cfg: ArchConfig, mesh, n_stages: int,
                       n_microbatches: int):
    """Returns ``loss_fn(params, tokens, targets)`` running the GPipe
    schedule on this rank's stage (its coordinate on the mesh's ``pod``
    axis). tokens / targets: [B, S], the same on every rank, B divisible by
    ``n_microbatches``."""
    per = cfg.n_layers // n_stages
    group = mesh.group(("pod",))
    stage = mesh.coords["pod"]
    if mesh.shape["pod"] != n_stages:
        raise ValueError(f"{n_stages} stages on a pod axis of "
                         f"{mesh.shape['pod']}")
    perm = [(i, i + 1) for i in range(n_stages - 1)]

    def loss_fn(params, tokens, targets):
        b, s = tokens.shape
        if b % n_microbatches:
            raise ValueError(f"batch {b} does not split into "
                             f"{n_microbatches} microbatches")
        mb = b // n_microbatches
        stages = params["stages"]
        lead = next(iter(_leaves(stages))).shape[0]
        stage_p = tree_map(lambda a: a[0 if lead == 1 else stage], stages)
        layers = [_layer(stage_p, j) for j in range(per)]
        embed = collectives.copy_to_group(params["embed"], group)
        norm_w = collectives.copy_to_group(params["final_norm_w"], group)
        dev = embed.device
        tok_mbs = tokens.to(dev).reshape(n_microbatches, mb, s)
        tgt_mbs = targets.to(dev).reshape(n_microbatches, mb, s)
        positions = torch.arange(s, device=dev)[None].expand(mb, s)

        first = torch.tensor(stage == 0, device=dev)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        x = torch.zeros((mb, s, cfg.d_model), dtype=embed.dtype, device=dev)
        total = zero
        for t in range(n_microbatches + n_stages - 1):
            mb_idx = min(max(t - stage, 0), n_microbatches - 1)
            use = torch.tensor(0 <= t - stage < n_microbatches
                               and stage == n_stages - 1, device=dev)
            # First stage: swap in the embedded tokens (x arrives as zeros).
            x = torch.where(first, _embed(cfg, embed, tok_mbs[mb_idx]), x)
            out = _run_layers(cfg, layers, x, positions)
            # Last stage: the loss of its active microbatch.
            h = T._apply_norm({"final_norm_w": norm_w}, cfg, out,
                              "final_norm")
            ce = T.fused_lm_loss(embed.t(), h, tgt_mbs[mb_idx], cfg, chunk=s)
            total = total + torch.where(use, ce, zero)
            # Ship activations to the next stage.
            x = collectives.permute_grad(out, perm, group)
        loss_sum = collectives.sum_from_group(total, group)
        return loss_sum / torch.tensor(float(n_microbatches),
                                       dtype=torch.float32, device=dev)

    return loss_fn


def stage_params(params, n_stages: int):
    """A model's parameters (``transformer.init_params``' layout, one dict a
    layer) as the pipeline's: the embedding, the final norm and the layers
    stacked [n_stages, layers_per_stage, ...]. Each weight keeps its own
    scale, where :func:`init_pipeline_params` draws with the reference's
    fan-in of the stacked shape."""
    layers = params["layers"]
    if len(layers) % n_stages:
        raise ValueError(f"{len(layers)} layers do not split into "
                         f"{n_stages} stages")
    per = len(layers) // n_stages

    def stack(*leaves):
        return torch.stack(leaves).reshape((n_stages, per) + leaves[0].shape)

    return {"embed": params["embed"], "final_norm_w": params["final_norm_w"],
            "stages": tree_map(stack, *layers)}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def sequential_reference_loss(cfg: ArchConfig, params, tokens, targets):
    """Same math without the pipeline (for correctness checks)."""
    stages = params["stages"]
    n_stages, per = stages["norm1_w"].shape[:2]
    flat = tree_map(lambda a: a.reshape((n_stages * per,) + a.shape[2:]),
                    stages)
    dev = params["embed"].device
    tokens, targets = tokens.to(dev), targets.to(dev)
    b, s = tokens.shape
    x = _embed(cfg, params["embed"], tokens)
    positions = torch.arange(s, device=dev)[None].expand(b, s)
    x = _run_layers(cfg, [_layer(flat, j) for j in range(n_stages * per)],
                    x, positions)
    h = T._apply_norm({"final_norm_w": params["final_norm_w"]}, cfg, x,
                      "final_norm")
    return T.fused_lm_loss(params["embed"].t(), h, targets, cfg, chunk=s)
