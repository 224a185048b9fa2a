"""Encoder-decoder stack (whisper-large-v3's backbone) — the port's
``repro/models/encdec.py``.

The audio conv frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings ``[B, S_enc, D]``. Pre-LN transformer,
sinusoidal positions, a GELU MLP (tanh form, as ``jax.nn.gelu``), MHA with
the heads padded to ``cfg.padded_heads`` and the padded heads' outputs
masked to zero, a decoder with causal self-attention and cross-attention,
and the embedding as the tied head. :func:`decode_train` is the
teacher-forced decoder pass the training loss takes (the reference's
``decode_train``).

The parameters keep one dict a layer (``enc_layers``, ``dec_layers``) where
the reference stacks them for ``jax.lax.scan`` (``models/convert.py``
unstacks a JAX tree). The serve state is the reference's dict with a list
where it stacks: ``self_k`` / ``self_v`` one ``[B, H, max_len, hd]`` tensor a
decoder layer, ``cross`` one ``(k, v)`` pair ``[B, H, S_enc, hd]`` a layer,
and ``pos``, a 0-d int32 tensor on the device. :func:`decode_step` writes
the new row and adds one to ``pos`` in place and reads nothing back to the
host, so a CUDA graph can capture it.

Attention runs where the tensors live (``impl="auto"``). On CUDA tensors
it launches the port's kernels: the encoder's self-attention and the
cross-attention through ``flash_attention`` with ``causal=False`` (the
cross-attention's queries are the decoder's, Sq != Skv), the decoder's
causal prefill through ``flash_attention``, and at decode the
self-attention through ``flash_decode`` over the self cache at ``pos`` and
the cross-attention through ``flash_decode`` over all S_enc keys. On CPU
tensors, or with ``impl="reference"``, it runs the plain versions the
reference runs: ``flash_attention_ref`` with ``chunk = min(512, Skv)``, and
at decode the masked softmax over the self cache.

On a mesh (``ctx``, ``models/context.py``) every function computes on the
rank's blocks, as ``models/transformer.py`` does for a decoder LM. With
more than one model rank: ``wq`` / ``wk`` / ``wv`` are the rank's padded
heads (column-parallel) and ``wo`` its rows (row-parallel, one sum over the
model group); the padded heads are masked by their global index, so a rank
that holds padded heads only still launches its kernels and adds zeros to
the sum; the FF's ``w1`` / ``b1`` are its columns and ``w2`` its rows, with
``b2`` added once after the sum; the tied embedding is vocab-parallel (the
lookup and the head, ``transformer.vocab_lookup`` / ``head_logits``, and
the cross-entropy, ``transformer._nll``). Every input of a column-parallel
product (a norm's output, the encoder output for the cross K/V, the final
hidden state for the head) enters through ``collectives.copy_to_group``,
so that its gradient sums the ranks' partial ones. The serve state holds
the rank's heads: ``self_k`` / ``self_v`` ``[B, H/m, max_len, hd]`` and
each ``cross`` pair ``[B, H/m, S_enc, hd]``, each a tensor of its own.
Under FSDP every leaf is also the rank's data block (``context.data_dim``):
each encoder and decoder layer is gathered over the data group inside the
function it checkpoints (so the recompute gathers it again), and
``embed`` and the final norms where they are used (the tied ``embed``
twice a pass, for the lookup and for the head); the gather's backward
reduce-scatters the gradients.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import collectives
from repro_torch.kernels.flash_attention.decode import flash_decode
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention,
)
from repro_torch.kernels.flash_attention.ref import NEG_INF, flash_attention_ref
from repro_torch.models import flags
from repro_torch.models import transformer as T
from repro_torch.models.context import DistContext, data_sharded, local_range
from repro_torch.models.layers import (
    ParamDef, act_fn, axes_tree, init_tree, layer_norm, maybe_checkpoint,
    runs_kernels,
)


def _sinusoid(seq: int, d: int, device=None) -> torch.Tensor:
    pos = torch.arange(seq, device=device, dtype=torch.float32)[:, None]
    i = torch.arange(d // 2, device=device, dtype=torch.float32)[None, :]
    ang = pos / torch.pow(torch.tensor(10000.0, device=device), 2 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _mha_defs(cfg: ArchConfig) -> Dict[str, ParamDef]:
    d, hd, h = cfg.d_model, cfg.head_dim_, cfg.padded_heads
    return {
        "wq": ParamDef((d, h, hd), ("d_model", "heads", None)),
        "wk": ParamDef((d, h, hd), ("d_model", "heads", None)),
        "wv": ParamDef((d, h, hd), ("d_model", "heads", None)),
        "wo": ParamDef((h, hd, d), ("heads", None, "d_model")),
    }


def _ln_defs(cfg: ArchConfig, name: str) -> Dict[str, ParamDef]:
    return {
        f"{name}_w": ParamDef((cfg.d_model,), (None,), init="ones"),
        f"{name}_b": ParamDef((cfg.d_model,), (None,), init="zeros"),
    }


def _ff_defs(cfg: ArchConfig) -> Dict[str, ParamDef]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w1": ParamDef((d, f), ("d_model", "ff")),
        "b1": ParamDef((f,), ("ff",), init="zeros"),
        "w2": ParamDef((f, d), ("ff", "d_model")),
        "b2": ParamDef((d,), (None,), init="zeros"),
    }


def _enc_layer_defs(cfg):
    return {**_ln_defs(cfg, "ln1"), "attn": _mha_defs(cfg),
            **_ln_defs(cfg, "ln2"), "ff": _ff_defs(cfg)}


def _dec_layer_defs(cfg):
    return {**_ln_defs(cfg, "ln1"), "self_attn": _mha_defs(cfg),
            **_ln_defs(cfg, "lnx"), "cross_attn": _mha_defs(cfg),
            **_ln_defs(cfg, "ln2"), "ff": _ff_defs(cfg)}


def model_defs(cfg: ArchConfig) -> Dict[str, Any]:
    return {
        "embed": ParamDef((cfg.padded_vocab, cfg.d_model),
                          ("vocab", "d_model"), init="normal", scale=0.02),
        "enc_layers": [_enc_layer_defs(cfg)
                       for _ in range(cfg.encoder.n_layers)],
        "dec_layers": [_dec_layer_defs(cfg) for _ in range(cfg.n_layers)],
        **_ln_defs(cfg, "enc_final"),
        **_ln_defs(cfg, "dec_final"),
    }


def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype=torch.float32, device=None, cut=None):
    """``cut``: what a rank keeps of each leaf (``layers.init_tree``)."""
    return init_tree(model_defs(cfg), generator, dtype, device, cut)


def param_logical_axes(cfg: ArchConfig):
    return axes_tree(model_defs(cfg))


# -- the mesh -----------------------------------------------------------------

def local_heads(cfg: ArchConfig, ctx: Optional[DistContext]
                ) -> Tuple[int, int]:
    """``(h0, h1)``: the padded heads this rank computes, all of them
    where the model ranks do not split the heads."""
    return (local_range(ctx, "heads", cfg.padded_heads)
            or (0, cfg.padded_heads))


def _splits(ctx: Optional[DistContext], axis: str, n: int) -> bool:
    return local_range(ctx, axis, n) is not None


def _into(x, ctx: Optional[DistContext], split: bool):
    """``x`` entering a column-parallel product: its cotangent summed over
    the model group (``collectives.copy_to_group``)."""
    return collectives.copy_to_group(x, ctx.model_group) if split else x


def _blocks(p, defs, cfg: ArchConfig, ctx: Optional[DistContext]):
    """``p`` (its ``ParamDef`` tree ``defs(cfg)``) gathered whole over the
    data group under FSDP (``transformer._gather_blocks``), else ``p``
    itself: the one-device path builds no defs."""
    if not data_sharded(ctx):
        return p
    return T._gather_blocks(p, defs(cfg), ctx)


def _top(params, cfg: ArchConfig, names, ctx: Optional[DistContext]):
    """The top-level entries ``names`` of ``params``, gathered over the
    data group under FSDP."""
    def defs(c):
        whole = model_defs(c)
        return {k: whole[k] for k in names}

    return _blocks({k: params[k] for k in names}, defs, cfg, ctx)


_ENC_FINAL = ("enc_final_w", "enc_final_b")
_DEC_FINAL = ("dec_final_w", "dec_final_b")


def _embed(params, cfg: ArchConfig, tokens, ctx=None):
    return T.vocab_lookup(_top(params, cfg, ("embed",), ctx)["embed"],
                          tokens, cfg, ctx)


def head_weight(params, cfg: ArchConfig, ctx=None):
    """The tied head ``[D, V]``: the embedding transposed (the rank's
    vocabulary under tensor parallelism), gathered over the data group
    under FSDP."""
    return _top(params, cfg, ("embed",), ctx)["embed"].t()


def _logits(params, cfg: ArchConfig, x, ctx=None):
    return T.head_logits(x, head_weight(params, cfg, ctx), cfg, ctx)


# -- the blocks ---------------------------------------------------------------

def _ln(p, name, x, eps):
    return layer_norm(x, p[f"{name}_w"], p[f"{name}_b"], eps)


def _heads(p, x, w):  # [B,S,D] x [D,H,hd] -> [B,H,S,hd], contiguous
    return torch.einsum("bsd,dhk->bhsk", x, p[w].to(x.dtype)).contiguous()


def _head_mask(cfg: ArchConfig, out, ctx=None):
    """``out`` [B, H, ...] on the rank's heads with the padded ones zeroed,
    found by their global index."""
    if cfg.padded_heads == cfg.n_heads:
        return out
    h0, h1 = local_heads(cfg, ctx)
    mask = (torch.arange(h0, h1, device=out.device)
            < cfg.n_heads).to(out.dtype)
    return out * mask.view((1, h1 - h0) + (1,) * (out.dim() - 2))


def _use_kernel(x, impl: str) -> bool:
    if impl == "auto":
        return runs_kernels(x)
    if impl in ("kernel", "reference"):
        return impl == "kernel"
    raise ValueError(f"unknown attention impl {impl!r}")


def _ref_chunk() -> int:
    """The plain attention's KV chunk: the reference's 512, 2048 under
    ``flags.ANALYSIS_UNROLL``."""
    return 2048 if flags.ANALYSIS_UNROLL else 512


def _attend(cfg: ArchConfig, q, k, v, causal: bool, impl: str, ctx=None):
    """q [B,H,Sq,hd] over k, v [B,H,Skv,hd]; padded heads masked."""
    if _use_kernel(q, impl):
        out = flash_attention(q, k.contiguous(), v.contiguous(),
                              causal=causal)
    else:
        out = flash_attention_ref(q, k, v, causal=causal,
                                  chunk=min(_ref_chunk(), k.shape[2]))
    return _head_mask(cfg, out, ctx)


def _out(p, cfg: ArchConfig, o, dtype, ctx=None):
    # [B,H,S,hd] x [H,hd,D] -> [B,S,D], summed over the model group where
    # the ranks split the heads (row-parallel ``wo``).
    y = torch.einsum("bhsk,hkd->bsd", o, p["wo"].to(dtype))
    if _splits(ctx, "heads", cfg.padded_heads):
        y = collectives.sum_from_group(y, ctx.model_group)
    return y


def _mha(p, cfg: ArchConfig, xq, xkv, causal: bool, impl: str,
         cached_kv=None, ctx=None):
    """Returns the attention output [B,Sq,D] (on the rank's heads, summed
    over the model group); ``cached_kv`` stands in for the projection of
    ``xkv`` (``xkv`` is ``xq`` for self-attention)."""
    split = _splits(ctx, "heads", cfg.padded_heads)
    hq = _into(xq, ctx, split)
    q = _heads(p, hq, "wq")
    if cached_kv is None:
        hkv = hq if xkv is xq else _into(xkv, ctx, split)
        k, v = _heads(p, hkv, "wk"), _heads(p, hkv, "wv")
    else:
        k, v = cached_kv
    return _out(p, cfg, _attend(cfg, q, k, v, causal, impl, ctx), xq.dtype,
                ctx)


def _ff(p, cfg: ArchConfig, x, ctx=None):
    """The GELU MLP: column-parallel ``w1`` / ``b1``, row-parallel ``w2``
    and ``b2`` added once, after the sum, where the ranks split ``d_ff``.
    A plain product, as the reference's ``@``."""
    act = act_fn("gelu")
    split = _splits(ctx, "ff", cfg.d_ff)
    x = _into(x, ctx, split)
    h = act(torch.matmul(x, p["w1"].to(x.dtype)) + p["b1"].to(x.dtype))
    y = torch.matmul(h, p["w2"].to(x.dtype))
    if split:
        y = collectives.sum_from_group(y, ctx.model_group)
    return y + p["b2"].to(x.dtype)


def _enc_layer(lp, cfg: ArchConfig, x, impl: str, ctx=None):
    # Checkpointed whole: under FSDP the recompute gathers the layer again.
    lp = _blocks(lp, _enc_layer_defs, cfg, ctx)
    h = _ln(lp, "ln1", x, cfg.norm_eps)
    x = x + _mha(lp["attn"], cfg, h, h, causal=False, impl=impl, ctx=ctx)
    return x + _ff(lp["ff"], cfg, _ln(lp, "ln2", x, cfg.norm_eps), ctx)


def encode(params, cfg: ArchConfig, frames: torch.Tensor,
           impl: str = "auto", remat: bool = False,
           ctx: Optional[DistContext] = None) -> torch.Tensor:
    """frames [B, S_enc, D] (the conv frontend's embeddings) -> encoder
    output [B, S_enc, D]. ``remat`` checkpoints each layer under grad mode
    (the reference always does). ``ctx``: the rank's rows on its blocks
    (see the module's docstring)."""
    x = frames + _sinusoid(frames.shape[1], cfg.d_model,
                           frames.device)[None].to(frames.dtype)
    for lp in params["enc_layers"]:
        x = maybe_checkpoint(remat, _enc_layer, lp, cfg, x, impl, ctx)
        if ctx is not None:
            x = ctx.constrain(x, "batch", None, None)
    return _ln(_top(params, cfg, _ENC_FINAL, ctx), "enc_final", x,
               cfg.norm_eps)


def _dec_layer(lp, cfg: ArchConfig, x, enc_out, impl: str, ctx=None):
    lp = _blocks(lp, _dec_layer_defs, cfg, ctx)
    h = _ln(lp, "ln1", x, cfg.norm_eps)
    x = x + _mha(lp["self_attn"], cfg, h, h, causal=True, impl=impl,
                 ctx=ctx)
    x = x + _mha(lp["cross_attn"], cfg, _ln(lp, "lnx", x, cfg.norm_eps),
                 enc_out, causal=False, impl=impl, ctx=ctx)
    return x + _ff(lp["ff"], cfg, _ln(lp, "ln2", x, cfg.norm_eps), ctx)


def decode_train(params, cfg: ArchConfig, tokens: torch.Tensor, enc_out,
                 return_hidden: bool = False, impl: str = "auto",
                 remat: bool = False,
                 ctx: Optional[DistContext] = None) -> torch.Tensor:
    """The teacher-forced decoder pass over ``tokens`` [B, S] attending to
    ``enc_out`` -> logits [B, S, Vpad], or with ``return_hidden`` the final
    normed hidden [B, S, D]. No cache: the training path. Its attention
    launches the flash-attention kernel on CUDA tensors (differentiable
    through the wrapper's autograd Function); ``remat`` checkpoints each
    layer under grad mode. ``ctx``: the rank's rows on its blocks, the
    logits gathered whole over the vocabulary."""
    s = tokens.shape[1]
    x = _embed(params, cfg, tokens, ctx)
    x = x + _sinusoid(s, cfg.d_model, x.device)[None].to(x.dtype)
    for lp in params["dec_layers"]:
        x = maybe_checkpoint(remat, _dec_layer, lp, cfg, x, enc_out, impl,
                             ctx)
        if ctx is not None:
            x = ctx.constrain(x, "batch", None, None)
    x = _ln(_top(params, cfg, _DEC_FINAL, ctx), "dec_final", x, cfg.norm_eps)
    return x if return_hidden else _logits(params, cfg, x, ctx)


def make_decode_caches(params, cfg: ArchConfig, enc_out, batch: int,
                       max_len: int, dtype,
                       ctx: Optional[DistContext] = None) -> Dict[str, Any]:
    """The self-attention KV caches (zeros) and each decoder layer's
    cross-attention K/V of ``enc_out``, projected once; ``ctx``: on the
    rank's heads (each tensor made at its block's shape), the projections
    gathered over the data group under FSDP."""
    (h0, h1), hd, dev = local_heads(cfg, ctx), cfg.head_dim_, enc_out.device
    x = _into(enc_out, ctx, _splits(ctx, "heads", cfg.padded_heads))
    cross = []
    for lp in params["dec_layers"]:
        w = _blocks({n: lp["cross_attn"][n] for n in ("wk", "wv")},
                    lambda c: {n: _mha_defs(c)[n] for n in ("wk", "wv")},
                    cfg, ctx)
        cross.append((_heads(w, x, "wk").to(dtype),
                      _heads(w, x, "wv").to(dtype)))
    shape = (batch, h1 - h0, max_len, hd)
    return {
        "self_k": [torch.zeros(shape, dtype=dtype, device=dev)
                   for _ in params["dec_layers"]],
        "self_v": [torch.zeros(shape, dtype=dtype, device=dev)
                   for _ in params["dec_layers"]],
        "cross": cross,
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
    }


def prefill(params, cfg: ArchConfig, tokens: torch.Tensor, enc_out,
            max_len: int, dtype, impl: str = "auto",
            ctx: Optional[DistContext] = None):
    """The decoder's teacher-forced pass over the prompt, filling the
    self-attention caches. Returns (logits [B, 1, Vpad] of the last
    position, caches ready for :func:`decode_step` at ``pos = S``).
    ``ctx``: the rank's rows on its blocks, its heads of the caches."""
    s = tokens.shape[1]
    caches = make_decode_caches(params, cfg, enc_out, tokens.shape[0],
                                max_len, dtype, ctx)
    split = _splits(ctx, "heads", cfg.padded_heads)
    x = _embed(params, cfg, tokens, ctx)
    x = x + _sinusoid(s, cfg.d_model, x.device)[None].to(x.dtype)
    for lp, sk, sv, kv in zip(params["dec_layers"], caches["self_k"],
                              caches["self_v"], caches["cross"]):
        lp = _blocks(lp, _dec_layer_defs, cfg, ctx)
        h = _into(_ln(lp, "ln1", x, cfg.norm_eps), ctx, split)
        sa = lp["self_attn"]
        q, k1, v1 = (_heads(sa, h, w) for w in ("wq", "wk", "wv"))
        sk[:, :, :s] = k1.to(sk.dtype)
        sv[:, :, :s] = v1.to(sv.dtype)
        x = x + _out(sa, cfg, _attend(cfg, q, k1, v1, True, impl, ctx),
                     x.dtype, ctx)
        x = x + _mha(lp["cross_attn"], cfg, _ln(lp, "lnx", x, cfg.norm_eps),
                     None, causal=False, impl=impl, cached_kv=kv, ctx=ctx)
        x = x + _ff(lp["ff"], cfg, _ln(lp, "ln2", x, cfg.norm_eps), ctx)
    x = _ln(_top(params, cfg, _DEC_FINAL, ctx), "dec_final", x[:, -1:],
            cfg.norm_eps)
    caches["pos"].fill_(s)
    return _logits(params, cfg, x, ctx), caches


def _self_decode(cfg: ArchConfig, q, sk, sv, pos, impl: str):
    """One query [B,H,hd] over the self cache at ``pos``."""
    if _use_kernel(q, impl):
        return flash_decode(q, sk, sv, pos=pos)
    mask = torch.arange(sk.shape[2], device=q.device) <= pos
    s = torch.einsum("bhk,bhsk->bhs", q.float(), sk.float()) \
        * cfg.head_dim_ ** -0.5
    s = torch.where(mask[None, None], s, NEG_INF)
    a = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bhsk->bhk", a, sv.float()).to(q.dtype)


def _cross_decode(cfg: ArchConfig, q, ck, cv, impl: str):
    """One query [B,H,hd] over every encoder position."""
    if _use_kernel(q, impl):
        return flash_decode(q, ck, cv, pos=ck.shape[2] - 1)
    return flash_attention_ref(q[:, :, None], ck, cv, causal=False,
                               chunk=min(_ref_chunk(), ck.shape[2]))[:, :, 0]


def decode_step(params, cfg: ArchConfig, token: torch.Tensor, caches,
                impl: str = "auto", ctx: Optional[DistContext] = None):
    """token [B, 1] -> (logits [B, 1, Vpad], caches), the caches updated
    in place (the new self K/V row at ``pos``, then ``pos`` + 1). ``ctx``:
    the rank's rows on its blocks and its heads of the caches, the logits
    gathered whole over the vocabulary."""
    pos = caches["pos"]
    split = _splits(ctx, "heads", cfg.padded_heads)
    x = _embed(params, cfg, token, ctx)
    max_len = caches["self_k"][0].shape[2]
    posemb = _sinusoid(max_len, cfg.d_model, x.device)
    x = x + posemb.index_select(0, pos.view(1).long())[None].to(x.dtype)
    slot = pos.view(1).long()
    for lp, sk, sv, (ck, cv) in zip(params["dec_layers"], caches["self_k"],
                                    caches["self_v"], caches["cross"]):
        lp = _blocks(lp, _dec_layer_defs, cfg, ctx)
        h = _into(_ln(lp, "ln1", x, cfg.norm_eps), ctx, split)
        sa = lp["self_attn"]
        q, k1, v1 = (_heads(sa, h, w) for w in ("wq", "wk", "wv"))
        sk.index_copy_(2, slot, k1.to(sk.dtype))
        sv.index_copy_(2, slot, v1.to(sv.dtype))
        o = _head_mask(cfg, _self_decode(cfg, q[:, :, 0].contiguous(), sk, sv,
                                         pos, impl), ctx)
        x = x + _out(sa, cfg, o[:, :, None].to(x.dtype), x.dtype, ctx)
        ca = lp["cross_attn"]
        hx = _into(_ln(lp, "lnx", x, cfg.norm_eps), ctx, split)
        qx = _heads(ca, hx, "wq")[:, :, 0].contiguous()
        ox = _head_mask(cfg, _cross_decode(cfg, qx, ck, cv, impl), ctx)
        x = x + _out(ca, cfg, ox[:, :, None].to(x.dtype), x.dtype, ctx)
        x = x + _ff(lp["ff"], cfg, _ln(lp, "ln2", x, cfg.norm_eps), ctx)
    x = _ln(_top(params, cfg, _DEC_FINAL, ctx), "dec_final", x, cfg.norm_eps)
    pos.add_(1)
    return _logits(params, cfg, x, ctx), caches

