"""Kernel tiling problems per model geometry, and the Hopper tile resolver.

``kernel_problems`` is the reference's (``repro/launch/specs.py:30``): pure
config arithmetic mapping one (config, batch, seq_len, kind) cell onto the
tunable-kernel problem dicts; ``cell_problems`` the same for one of the
assigned (arch x shape) cells, which the plan compiler sweeps.
``resolve_model_tiles`` is the reference's resolver: every ported kernel
of a cell takes its tile from a :class:`~repro_torch.core.plans.TilePlan`
(exact hit, nearest shape, cross-hardware transfer) or else its Hopper
``default_tile``. ``launchable_tiles`` then holds each resolved tile
against the calls the model makes of its kernel (the wrappers'
``launch_tile`` rules) and replaces a tile that would not launch by the
kernel's default, so no plan tile can raise in the middle of a serve.

The dry run's abstract inputs (the reference's ``input_specs``,
``decode_token_spec``, ``abstract_params``, ``abstract_opt_state`` and
``abstract_serve_state``) are ``meta`` tensors: shapes and dtypes with no
memory, the counterpart of ``jax.ShapeDtypeStruct`` and ``eval_shape``.
The port's layout applies: one parameter dict (and one cache) a layer,
where the reference stacks the layers.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, Mapping, Sequence

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeSpec
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


def cell_problems(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, Dict[str, int]]:
    """``kernel_problems`` for one of the assigned (arch x shape) cells."""
    return kernel_problems(cfg, shape.global_batch, shape.seq_len, shape.kind)


def resolve_model_tiles(plans, cfg: ArchConfig, batch: int, seq_len: int,
                        kind: str, dtype: str, hardware):
    """Resolve every kernel tile of one model geometry from an AOT plan.

    The reference's resolver: never sweeps; a cell the plan cannot resolve
    (or any cell with ``plans=None``) takes the kernel's Hopper default.
    ``dtype`` is the name (``"float32"``, ``"bfloat16"``), as plan keys
    hold it. Returns ``(tiles, resolutions)``: kernel name -> TileShape, and
    kernel name -> PlanResolution for the cells the plan satisfied. A
    ``chunked_prefill`` or ``packed_prefill`` cell (``kind`` of that name)
    resolves like any other, and so does a decode cell's ``kv_page``.
    """
    from repro_torch import kernels

    log = logging.getLogger("repro_torch.plans")
    kernels.register_all()
    tiles, resolutions = {}, {}
    for kernel, problem in kernel_problems(cfg, batch, seq_len, kind).items():
        res = (plans.resolve(kernel, problem, dtype, hardware)
               if plans is not None else None)
        if res is None:
            tiles[kernel] = registry.get(kernel).default_tile(problem, dtype)
            if plans is not None:
                log.warning("no tile plan for %s on %s; using heuristic "
                            "default %s", kernel, hardware.name,
                            tiles[kernel])
        else:
            tiles[kernel] = res.tile
            resolutions[kernel] = res
            log.info("tile plan %s on %s: %s (%s)", kernel, hardware.name,
                     res.tile, res.source)
    return tiles, resolutions


def tile_launches(kernel: str, tile, cfg: ArchConfig, dtype: str,
                  tokens: int, cache_lens: Sequence[int] = ()) -> bool:
    """Whether ``kernel``'s wrapper launches ``tile`` at every call the
    model makes of it: the FF's ``(tokens, d_model, d_ff)`` and ``(tokens,
    d_ff, d_model)`` GEMMs (one tile for the three), the prefill attention
    at the head dim, the decode attention over each KV cache length in
    ``cache_lens`` (``bkv`` clamped to it, as ``attn_decode`` clamps it),
    and the SSD and RG-LRU scans over a sequence of ``tokens`` steps (the
    prompt, or 1 at decode; each wrapper clamps its tile to it). Pure
    Python: it runs without a card."""
    from repro_torch.kernels.flash_attention import decode as fa_decode
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.matmul import ops as mm_ops
    from repro_torch.kernels.rglru import ops as rglru_ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    try:
        if kernel == "matmul":
            d, f = cfg.d_model, cfg.d_ff or cfg.d_model
            for k, n in ((d, f), (f, d)):
                mm_ops.launch_tile(tile, tokens, n, k, dtype)
        elif kernel == "flash_attention":
            fa.launch_tile(tile, cfg.head_dim_, dtype)
        elif kernel == "flash_decode":
            for s in cache_lens:
                fa_decode.launch_bkv(tile[-1], s, cfg.head_dim_,
                                     cfg.gqa_ratio)
        elif kernel == "ssd":
            ssm = cfg.ssm
            ssd_ops.launch_chunk(tile[0], dict(
                s=tokens, h=ssm.n_heads(cfg.d_model), p=ssm.head_dim,
                n=ssm.d_state), dtype)
        elif kernel == "rglru":
            rglru_ops.launch_tile(tile, dict(
                s=tokens, f=cfg.recurrent.lru_width or cfg.d_model))
    except ValueError:
        return False
    return True


def cell_launches(kernel: str, problem: Mapping[str, int], dtype: str,
                  tile) -> bool:
    """Whether ``kernel``'s wrapper launches ``tile`` as given on one plan
    cell's own problem, the call ``launch.measure.make_cell_timer`` times:
    :func:`tile_launches`'s per-kernel rule at the cell's shapes (the
    matmul's one ``(m, k, n)`` GEMM, the attention's head dim, the decode
    attention over ``skv`` keys, a scan over ``s`` steps), and no clamping
    of the tile to the problem, after which the wrapper would run another
    tile than the one named. A serving cell (``chunked_prefill``,
    ``packed_prefill``, ``kv_page``) is no single launch: True. Pure
    Python."""
    from repro_torch.kernels.bilinear import ops as bilinear_ops
    from repro_torch.kernels.flash_attention import decode as fa_decode
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.matmul import ops as mm_ops
    from repro_torch.kernels.rglru import ops as rglru_ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    t = tuple(int(x) for x in tile)
    try:
        if kernel == "matmul":
            mm_ops.launch_tile(t, problem["m"], problem["n"], problem["k"],
                               dtype)
        elif kernel == "flash_attention":
            fa.launch_tile(t, problem["d"], dtype)
        elif kernel == "flash_decode":
            rep = max(problem["hq"], 1) // max(problem["hkv"], 1)
            return fa_decode.launch_bkv(t[-1], problem["skv"], problem["d"],
                                        rep) == t[-1]
        elif kernel == "ssd":
            return ssd_ops.launch_chunk(t[0], problem, dtype) == t[0]
        elif kernel == "rglru":
            return rglru_ops.launch_tile(t, problem) == t
        elif kernel in ("bilinear", "bilinear_cuda"):
            bilinear_ops.launch_tile(t, problem, dtype)
    except ValueError:
        return False
    return True


def launchable_tiles(tiles: Dict[str, TileShape], cfg: ArchConfig,
                     batch: int, seq_len: int, kind: str, dtype: str,
                     tokens: int, cache_lens: Sequence[int] = ()):
    """``tiles`` with each one that :func:`tile_launches` refuses replaced
    by the kernel's default for the cell (for the matmul, at the call's
    ``tokens`` rows, which pick its regime). Returns ``(tiles, replaced)``,
    ``replaced`` the kernels whose tile was replaced."""
    problems = kernel_problems(cfg, batch, seq_len, kind)
    problems["matmul"] = dict(problems["matmul"], m=tokens)
    out, replaced = dict(tiles), []
    for kernel, tile in tiles.items():
        if not tile_launches(kernel, tile, cfg, dtype, tokens, cache_lens):
            out[kernel] = registry.get(kernel).default_tile(problems[kernel],
                                                            dtype)
            replaced.append(kernel)
            logging.getLogger("repro_torch.plans").warning(
                "tile %s of %s does not launch at this call; using the "
                "default %s", tile, kernel, out[kernel])
    return out, replaced


# ---------------------------------------------------------------------------
# The dry run's abstract inputs (meta tensors)
# ---------------------------------------------------------------------------

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Abstract train/prefill batch for one cell."""
    from repro_torch.models import api

    b, s = shape.global_batch, shape.seq_len
    if api.is_encdec(cfg):
        return {
            "frames": _meta((b, cfg.encoder.seq_len, cfg.d_model),
                            torch.bfloat16),
            "tokens": _meta((b, s), torch.int32),
            "targets": _meta((b, s), torch.int32),
        }
    if api.is_vlm(cfg):
        p = cfg.encoder.seq_len
        # Total sequence = p patch positions + text tail; loss on text only.
        return {
            "patch_embeds": _meta((b, p, 1024), torch.bfloat16),
            "tokens": _meta((b, s - p), torch.int32),
            "targets": _meta((b, s - p), torch.int32),
        }
    return {
        "tokens": _meta((b, s), torch.int32),
        "targets": _meta((b, s), torch.int32),
    }


def decode_token_spec(cfg: ArchConfig, shape: ShapeSpec) -> torch.Tensor:
    return _meta((shape.global_batch, 1), torch.int32)


def abstract_params(cfg: ArchConfig, dtype=torch.bfloat16, ctx=None):
    """The parameters as ``meta`` tensors (``api.init_params`` on meta:
    nothing drawn); with a ``ctx`` whose ranks hold blocks (tensor
    parallelism, FSDP), the blocks of its rank (rank 0 in a dry run)."""
    from repro_torch.models import api

    return api.init_params(cfg, 0, dtype=dtype, device=META, ctx=ctx)


def abstract_opt_state(params, opt_cfg):
    """AdamW's state (``optim.adamw.init_state``) of ``meta`` parameters."""
    from repro_torch.optim import adamw

    return adamw.init_state(params, opt_cfg)


def abstract_serve_state(cfg: ArchConfig, shape: ShapeSpec,
                         dtype=torch.bfloat16, params=None, batch=None,
                         ctx=None):
    """Abstract KV/recurrent state for a decode cell (cache len = seq_len):
    ``api.make_serve_state`` on ``meta`` (an encoder-decoder's from a meta
    encoder output at the rank's rows and ``params``). ``batch`` (default:
    the shape's global batch) is the rows of one rank's state; ``ctx``, its
    KV heads, RG-LRU features and SSD heads (an encoder-decoder's self and
    cross heads)."""
    from repro_torch.models import api

    b = shape.global_batch if batch is None else batch
    s = shape.seq_len
    if api.is_encdec(cfg):
        enc = _meta((b, cfg.encoder.seq_len, cfg.d_model), dtype)
        return api.make_serve_state(cfg, b, s, dtype, device=META,
                                    enc_out=enc, params=params, ctx=ctx)
    return api.make_serve_state(cfg, b, s, dtype, device=META,
                                ring_local=bool(cfg.attn_window), ctx=ctx)
