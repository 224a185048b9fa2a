"""Wrapper of the Hopper flash-attention kernel (``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention/
flash_attention.py:flash_attention``. CPU tensors take
:func:`~repro_torch.kernels.flash_attention.ref.flash_attention_ref`; CUDA
tensors launch the kernel of their :func:`regime` or raise.

The dtype picks the regime: ``wgmma`` (bfloat16: TMA, a producer warpgroup
and one or two wgmma consumer warpgroups) or ``mma`` (float32: 3xTF32
mma.sync, one warp per 16 query rows). Each compiles the (head dim, bkv)
pairs ``REPRO_FA_TILES`` in the source lists, the one place the rule lives;
bq is 64 or 128 wherever the tile's shared memory fits a block. The wgmma
regime computes at :func:`panel_dim`, the head dim zero-padded to whole
64-column panels (D = 80 at 128), with the true head dim's scale.
"""
from __future__ import annotations

import ctypes
import functools
import re
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.hardware import H100_SXM
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import NEG_INF, flash_attention_ref
from repro_torch.models import flags

HEAD_DIMS = (16, 32, 64, 80, 128, 256)   # head dims the .cu file compiles
BQS = (64, 128)     # query rows a block: 1 or 2 warpgroups, 4 or 8 warps
STAGES = 2          # K/V ring depth of both regimes


def _lib():
    fn = build.load("flash_attention").repro_flash_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_attention(
    q, k, v, *, causal: bool = True, window: Optional[int] = None,
    softcap: Optional[float] = None, scale: Optional[float] = None,
    q_offset: int = 0, tile=None,
):
    """q [B, Hq, Sq, D] x k,v [B, Hkv, Skv, D] -> [B, Hq, Sq, D].

    ``tile`` is ``(bq, bkv)``, default the spec's Hopper tile. On the card
    it must be a tile of the dtype's regime (:func:`regime_tiles`); the last
    q and KV blocks are masked, so neither dim has to divide. On the CPU
    ``bkv`` is the reference's KV chunk. Under grad mode, with an input that
    requires grad, a CUDA call goes through :class:`_FlashAttentionFn`.
    Under ``flags.ATTN_COMPUTE_BF16`` float32 CUDA (or ``meta``) tensors
    run the bf16 (wgmma) regime; CPU tensors the plain version with bf16
    products.
    """
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if k.shape != (b, hkv, skv, d) or v.shape != k.shape:
        raise ValueError(f"bad attention shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if hq % hkv:
        raise ValueError(f"GQA requires Hq % Hkv == 0, got {hq}, {hkv}")
    scale = scale if scale is not None else d ** -0.5
    opts = dict(causal=causal, window=window, softcap=softcap, scale=scale,
                q_offset=q_offset)
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return flash_attention_ref(
            q, k, v, chunk=int(tile[1]) if tile is not None else 512, **opts)
    if flags.ATTN_COMPUTE_BF16 and q.dtype == torch.float32:
        # The reference's switch: the products in bf16, here the kernel's
        # bf16 (wgmma) mode on bf16 copies, the output back in float32; a
        # tile of the float32 regime gives way to the bf16 default.
        bf = tuple(t.to(torch.bfloat16) for t in (q, k, v))
        if tile is not None and tuple(int(x) for x in tile) not in \
                regime_tiles(torch.bfloat16, d):
            tile = None
        return flash_attention(*bf, tile=tile, **opts).to(q.dtype)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttentionFn.apply(q, k, v, tile, opts)
    return _flash_cuda(q, k, v, tile, opts)


class _FlashAttentionFn(torch.autograd.Function):
    """Forward: the kernel. Backward: the gradient of the plain
    :func:`flash_attention_ref` at the saved q, k and v (recomputed under
    ``torch.enable_grad``), every time. The reference has no backward
    kernel: it differentiates its Pallas call through JAX, so the plain
    version's gradient is the declared derivative here, counted apart in
    ``build.LAUNCHES["flash_attention_bwd_plain"]``. It keeps each KV
    chunk's [B, Hq, Sq, chunk] logits while it runs (transient, one layer at
    a time under remat)."""

    @staticmethod
    def forward(ctx, q, k, v, tile, opts):
        ctx.save_for_backward(q, k, v)
        ctx.opts = opts
        return _flash_cuda(q, k, v, tile, opts)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need) for t, need in
                      zip((q, k, v), ctx.needs_input_grad[:3])]
            out = flash_attention_ref(*leaves, **ctx.opts)
            wanted = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, dout))
        build.launched("flash_attention_bwd_plain", q.is_meta)
        return (*(next(grads) if t.requires_grad else None for t in leaves),
                None, None)


def _flash_cuda(q, k, v, tile, opts):
    """One launch of the kernel (no autograd history)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    build.check_cuda_operands("flash_attention", q, k, v)
    if tile is None:
        from repro_torch.kernels.flash_attention.ops import FLASH_SPEC

        tile = FLASH_SPEC.default_tile(
            dict(sq=sq, skv=skv, d=d, hq=hq, hkv=hkv,
                 window=opts["window"] or 0), str(q.dtype))
    bq, bkv = launch_tile(tile, d, q.dtype)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention's kernels need 16-byte aligned "
                         "operands")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    if skv == 0:
        return out.zero_()
    meta = build.is_meta(q, k, v)
    if meta:
        build.meta_work("flash_attention", flops(
            b, hq, sq, skv, d, (bq, bkv), causal=opts["causal"],
            window=opts["window"], q_offset=opts["q_offset"]),
            build.nbytes(q, k, v, out))
    else:
        rc = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    b, hq, hkv, sq, skv, d, build.dtype_code(q.dtype), bq,
                    bkv, float(opts["scale"]), int(bool(opts["causal"])),
                    int(opts["window"] or 0), float(opts["softcap"] or 0.0),
                    int(opts["q_offset"]), build.stream_ptr(q.device))
        build.check(rc, "flash_attention")
    build.launched("flash_attention", meta)
    return out


def visible_blocks(sq: int, skv: int, tile, causal: bool = True,
                   window: Optional[int] = None, q_offset: int = 0):
    """The (query rows, keys) of every block the kernel computes: for each
    block of ``bq`` query rows, the ``bkv``-key blocks from the window's
    first to the causal diagonal's last (``kv_blocks`` in the source; the
    rest are never loaded), cut at the sequences' ends."""
    bq, bkv = int(tile[0]), int(tile[1])
    out = []
    for q0 in range(0, sq, bq):
        rows = min(bq, sq - q0)
        first, last = q_offset + q0, q_offset + q0 + rows - 1
        hi = min(skv, last + 1) if causal else skv
        lo = max(0, first - window + 1) if window else 0
        for ib in range(lo // bkv, max(lo // bkv, -(-hi // bkv))):
            out.append((rows, min(bkv, skv - ib * bkv)))
    return out


def flops(b: int, hq: int, sq: int, skv: int, d: int, tile,
          causal: bool = True, window: Optional[int] = None,
          q_offset: int = 0) -> float:
    """The kernel's operations: the two products (q k^T and p v, two
    operations a multiply-add) over every block it computes
    (:func:`visible_blocks`), masked entries of a block included."""
    pairs = sum(r * c for r, c in visible_blocks(sq, skv, tile, causal,
                                                 window, q_offset))
    return 4.0 * d * b * hq * pairs


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def regime(dtype, d: int) -> str:
    """The kernel a call runs on, from the dtype and head dim alone:
    ``wgmma`` for bfloat16, ``mma`` for float32. Raises ValueError for a
    head dim the source does not compile, TypeError for another dtype."""
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention head_dim {d} not in {HEAD_DIMS}")
    name = _dtype_name(dtype)
    if name not in ("float32", "bfloat16"):
        raise TypeError(f"flash_attention takes float32 or bfloat16, got {name}")
    return "wgmma" if name == "bfloat16" else "mma"


@functools.lru_cache(maxsize=None)
def _compiled() -> Dict[Tuple[str, int], Tuple[int, ...]]:
    """``{(regime, head dim): bkv values}`` as ``REPRO_FA_TILES`` in the
    kernel's source states them."""
    text = (build.CSRC / build.SOURCES["flash_attention"]).read_text()
    table = re.search(r"#define REPRO_FA_TILES((?:.*\\\n)*.*)", text)
    out: Dict[Tuple[str, int], Tuple[int, ...]] = {}
    for reg, d, bkv in re.findall(r"X\((MMA|WGMMA),\s*(\d+),\s*(\d+)\)",
                                  table.group(1)):
        key = (reg.lower(), int(d))
        out[key] = out.get(key, ()) + (int(bkv),)
    return out


def panel_dim(d: int) -> int:
    """The head dim the wgmma regime computes at (``panel_dim`` of the
    source): whole 64-column panels, the columns past ``d`` zero."""
    return -(-d // 64) * 64


def smem_bytes(bq: int, bkv: int, d: int, dtype) -> int:
    """Shared memory one block uses (``smem_bytes`` of the source): mma, the
    float32 q block and two K and V stages with rows padded by 4 floats;
    wgmma, the bf16 q block and two K and V stages in 64-column panels, 1024
    bytes of alignment and the mbarriers."""
    if regime(dtype, d) == "mma":
        return 4 * (d + 4) * (bq + 2 * STAGES * bkv)
    return (2 * panel_dim(d) * (bq + 2 * STAGES * bkv) + 1024
            + 8 * (1 + 3 * STAGES))


def threads(bq: int, dtype) -> int:
    """Threads of one block: 2 per query row (mma); 128 a consumer
    warpgroup of 64 rows plus the producer warpgroup (wgmma)."""
    return 2 * bq if _dtype_name(dtype) == "float32" else 2 * bq + 128


def regime_tiles(dtype, d: int) -> Tuple[Tuple[int, int], ...]:
    """Every (bq, bkv) the dtype's regime launches at head dim ``d``."""
    bkvs = _compiled().get((regime(dtype, d), d), ())
    return tuple((bq, bkv) for bq in BQS for bkv in bkvs
                 if smem_bytes(bq, bkv, d, dtype) <= H100_SXM.vmem_bytes)


def launch_tile(tile, d: int, dtype) -> Tuple[int, int]:
    """``tile`` as ints, or ValueError if the regime has no such tile at head
    dim ``d``. A tile larger than the problem is masked at the ragged edge."""
    t = (int(tile[0]), int(tile[1]))
    legal = regime_tiles(dtype, d)
    if t not in legal:
        raise ValueError(f"flash_attention tile {t} is not a {regime(dtype, d)}"
                         f" tile at head_dim {d}; tiles: {legal}")
    return t


__all__ = ["HEAD_DIMS", "NEG_INF", "flash_attention", "flops", "launch_tile",
           "panel_dim", "regime", "regime_tiles", "smem_bytes", "threads",
           "visible_blocks"]
