"""Kernel tiling problems per model geometry, and the Hopper tile resolver.

``kernel_problems`` is the reference's (``repro/launch/specs.py:30``): pure
config arithmetic mapping one (config, batch, seq_len, kind) cell onto the
tunable-kernel problem dicts. ``resolve_model_tiles`` gives every kernel of
that cell its Hopper ``default_tile`` — what the reference's resolver falls
back to when a plan has no cell. Loading TilePlan artifacts comes with the
Hopper plan compiler.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.configs.base import ArchConfig
from repro_torch.core import registry
from repro_torch.core.tiling import TileShape

# Cap the token dim fed to the matmul tuning problem.
MAX_PLAN_TOKENS = 65536


def kernel_problems(cfg: ArchConfig, batch: int, seq_len: int,
                    kind: str) -> Dict[str, Dict[str, int]]:
    """Per-kernel tile-tuning problems for one (config, geometry) cell.

    ``kind``: "train" | "prefill" (full-sequence), "decode" (one token per
    sequence against a KV cache of ``seq_len``), "chunked_prefill" or
    "packed_prefill" (the attention cell is that serving kernel's).
    """
    decode = kind == "decode"
    chunked = kind == "chunked_prefill"
    packed = kind == "packed_prefill"
    tokens = batch if decode else min(batch * seq_len, MAX_PLAN_TOKENS)
    problems: Dict[str, Dict[str, int]] = {
        "matmul": dict(m=tokens, k=cfg.d_model, n=cfg.d_ff or cfg.d_model),
    }
    mixers = {spec.mixer for spec in cfg.layers()}
    if mixers & {"attn", "local_attn"}:
        window = cfg.attn_window if "attn" not in mixers else 0
        if decode:
            problems["flash_decode"] = dict(
                b=batch, skv=seq_len, d=cfg.head_dim_,
                hq=max(cfg.n_heads, 1), hkv=max(cfg.n_kv_heads, 1),
                window=window,
            )
            problems["kv_page"] = dict(
                skv=seq_len, d=cfg.head_dim_, hkv=max(cfg.n_kv_heads, 1),
            )
        else:
            attn_kernel = ("packed_prefill" if packed
                           else "chunked_prefill" if chunked
                           else "flash_attention")
            problems[attn_kernel] = dict(
                sq=seq_len, skv=seq_len, d=cfg.head_dim_,
                hq=max(cfg.n_heads, 1), hkv=max(cfg.n_kv_heads, 1),
                window=window,
            )
    if "rglru" in mixers and cfg.recurrent is not None:
        problems["rglru"] = dict(
            s=1 if decode else seq_len,
            f=cfg.recurrent.lru_width or cfg.d_model,
        )
    if "ssd" in mixers and cfg.ssm is not None:
        problems["ssd"] = dict(
            s=1 if decode else seq_len,
            h=cfg.ssm.n_heads(cfg.d_model),
            p=cfg.ssm.head_dim,
            n=cfg.ssm.d_state,
        )
    return problems


def resolve_model_tiles(cfg: ArchConfig, batch: int, seq_len: int, kind: str,
                        dtype: str) -> Tuple[Dict[str, TileShape], Dict]:
    """Hopper default tiles for every ported kernel of one geometry.

    Returns ``(tiles, resolutions)`` like the reference; ``resolutions`` is
    empty until plans load. Kernels the port has no spec for yet (kv_page,
    the recurrent scans) are left out.
    """
    from repro_torch import kernels

    kernels.register_all()
    tiles = {}
    for kernel, problem in kernel_problems(cfg, batch, seq_len, kind).items():
        if kernel in registry.names():
            tiles[kernel] = registry.get(kernel).default_tile(problem, dtype)
    return tiles, {}
