"""Convert a JAX parameter tree (as numpy arrays) into the port's parameters.

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
from repro_torch.models.transformer import decompose


def params_from_jax(cfg: ArchConfig, tree: Dict[str, Any],
                    dtype=torch.float32, device=None) -> Dict[str, Any]:
    dev = resolve_device(device)

    def tensor(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=dev, dtype=dtype)

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
