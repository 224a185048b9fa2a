"""Wrapper of the Hopper flash-attention kernel (``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention/
flash_attention.py:flash_attention``. CPU tensors take
:func:`~repro_torch.kernels.flash_attention.ref.flash_attention_ref`; CUDA
tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.hardware import H100_SXM
from repro_torch.core.tiling import round_up
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import NEG_INF, flash_attention_ref

HEAD_DIMS = (16, 32, 64, 128)   # head dims flash_attention.cu instantiates
BQ_MAX = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    fn = build.load("flash_attention").repro_flash_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def check_cuda_operands(name: str, *tensors) -> None:
    """Raise unless every tensor is a contiguous float32/bfloat16 CUDA
    tensor of one device and dtype."""
    first = tensors[0]
    for t in tensors:
        if t.device.type != "cuda" or t.device != first.device:
            raise ValueError(f"{name} needs its operands on one CUDA device, "
                             f"got {[str(x.device) for x in tensors]}")
        if t.dtype not in _DTYPES or t.dtype != first.dtype:
            raise TypeError(f"{name} takes float32 or bfloat16 operands of "
                            f"one dtype, got {[x.dtype for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous operands")


def flash_attention(
    q, k, v, *, causal: bool = True, window: Optional[int] = None,
    softcap: Optional[float] = None, scale: Optional[float] = None,
    q_offset: int = 0, tile=None,
):
    """q [B, Hq, Sq, D] x k,v [B, Hkv, Skv, D] -> [B, Hq, Sq, D].

    ``tile`` is ``(bq, bkv)``, default the spec's Hopper tile. On the card
    it is clamped to the problem (rounded up to a multiple of 4) as the
    reference clamps it; the last q and KV blocks are masked, so neither
    dim has to divide. On the CPU ``bkv`` is the reference's KV chunk.
    """
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if k.shape != (b, hkv, skv, d) or v.shape != k.shape:
        raise ValueError(f"bad attention shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if hq % hkv:
        raise ValueError(f"GQA requires Hq % Hkv == 0, got {hq}, {hkv}")
    scale = scale if scale is not None else d ** -0.5
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return flash_attention_ref(
            q, k, v, causal=causal, window=window, softcap=softcap,
            scale=scale, q_offset=q_offset,
            chunk=int(tile[1]) if tile is not None else 512)
    check_cuda_operands("flash_attention", q, k, v)
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention head_dim {d} not in {HEAD_DIMS}")
    if tile is None:
        from repro_torch.kernels.flash_attention.ops import FLASH_SPEC

        tile = FLASH_SPEC.default_tile(
            dict(sq=sq, skv=skv, d=d, hq=hq, hkv=hkv, window=window or 0),
            str(q.dtype))
    bq = min(int(tile[0]), round_up(sq, 4))
    bkv = min(int(tile[1]), round_up(skv, 4))
    if bq % 4 or bkv % 4 or bq > BQ_MAX:
        raise ValueError(f"flash_attention tile ({bq}, {bkv}) needs multiples "
                         f"of 4 and bq <= {BQ_MAX}")
    if smem_bytes(bq, bkv, d) > H100_SXM.vmem_bytes:
        raise ValueError(f"flash_attention tile ({bq}, {bkv}) needs "
                         f"{smem_bytes(bq, bkv, d)} B of shared memory; a "
                         f"block may use {H100_SXM.vmem_bytes}")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    rc = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, hq, hkv, sq, skv, d, _DTYPES[q.dtype], bq, bkv,
                float(scale), int(bool(causal)), int(window or 0),
                float(softcap or 0.0), int(q_offset),
                build.stream_ptr(q.device))
    build.check(rc, "flash_attention")
    build.LAUNCHES["flash_attention"] += 1
    return out


def smem_bytes(bq: int, bkv: int, d: int) -> int:
    """Shared memory one block of the kernel uses: float32 q, padded K, V,
    the [bq, bkv] logits and three per-row statistics."""
    return 4 * (bq * d + bkv * (d + 1) + bkv * d + bq * bkv + 3 * bq)


__all__ = ["NEG_INF", "flash_attention", "smem_bytes"]
