"""Convert a JAX parameter tree (as numpy arrays) into the port's parameters,
and the reference's AdamW state into the port's (:func:`opt_state_from_jax`).

The reference stacks the layers of each ``("scan", unit, reps)`` segment on
a leading axis (``transformer.decompose``), and an encoder-decoder's
``enc_layers`` and ``dec_layers`` each on axis 0; the port keeps one dict
per layer in layer order. Every other entry (an MoE layer's ``moe`` dict, a
vision model's ``vit_proj``, the norms) is carried across as it is. Imports
no JAX: the caller hands in the tree with its leaves already converted,
e.g. ``jax.tree.map(np.asarray, params)``.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import api
from repro_torch.models.transformer import decompose


def params_from_jax(cfg: ArchConfig, tree: Dict[str, Any],
                    dtype=torch.float32, device=None,
                    ctx=None) -> Dict[str, Any]:
    """The reference's parameters as the port's; with a tensor-parallel
    ``ctx`` (``models/context.py``), this rank's blocks of them
    (``api.shard_params``)."""
    return api.shard_params(
        _convert(cfg, tree, dtype, resolve_device(device)), cfg, ctx)


def opt_state_from_jax(cfg: ArchConfig, tree: Dict[str, Any],
                       device=None) -> Dict[str, Any]:
    """The reference's AdamW state ``{"m", "v", "step"}`` as the port's:
    ``m`` and ``v`` unstacked as :func:`params_from_jax` unstacks the
    parameters, each leaf keeping its dtype (float32, or bfloat16 moments,
    carried exactly through float32), and ``step`` a 0-d int32 tensor. Both
    packages then take the same step from the same state."""
    dev = resolve_device(device)
    return {"m": _convert(cfg, tree["m"], None, dev),
            "v": _convert(cfg, tree["v"], None, dev),
            "step": torch.tensor(int(np.asarray(tree["step"])),
                                 dtype=torch.int32, device=dev)}


def _convert(cfg: ArchConfig, tree: Dict[str, Any], dtype,
             dev: torch.device) -> Dict[str, Any]:
    """A parameter-shaped tree, unstacked, as tensors of ``dtype`` (None:
    each leaf's own, bfloat16 or float32) on ``dev``."""
    def tensor(a) -> torch.Tensor:
        a = np.asarray(a)
        dt = dtype or (torch.bfloat16 if a.dtype.name == "bfloat16"
                       else torch.float32)
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=dev, dtype=dt)

    def walk(node, index=None):
        if isinstance(node, dict):
            return {k: walk(v, index) for k, v in node.items()}
        return tensor(node if index is None else np.asarray(node)[index])

    def unstack(stacked) -> List[Dict[str, Any]]:
        n = len(np.asarray(stacked["ln1_w"]))
        return [walk(stacked, r) for r in range(n)]

    if "dec_layers" in tree:           # encoder-decoder
        out = {k: walk(v) for k, v in tree.items()
               if k not in ("enc_layers", "dec_layers")}
        out["enc_layers"] = unstack(tree["enc_layers"])
        out["dec_layers"] = unstack(tree["dec_layers"])
        return out

    layers: List[Dict[str, Any]] = []
    for seg, group in zip(decompose(cfg), tree["segments"]):
        if seg[0] == "seq":
            layers += [walk(lp) for lp in group]
        else:
            _, unit, reps = seg
            for r in range(reps):
                layers += [walk(group[u], r) for u in range(len(unit))]
    out = {k: walk(v) for k, v in tree.items() if k != "segments"}
    out["layers"] = layers
    return out
