"""Wrapper of the Hopper flash-attention kernel (``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention/
flash_attention.py:flash_attention``. CPU tensors take
:func:`~repro_torch.kernels.flash_attention.ref.flash_attention_ref`; CUDA
tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import functools
import re
from typing import Dict, Optional

import torch

from repro_torch.core.hardware import H100_SXM
from repro_torch.core.tiling import round_up
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import NEG_INF, flash_attention_ref

HEAD_DIMS = (16, 32, 64, 128, 256)   # head dims the .cu files instantiate


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
    build.check_cuda_operands("flash_attention", q, k, v)
    if tile is None:
        from repro_torch.kernels.flash_attention.ops import FLASH_SPEC

        tile = FLASH_SPEC.default_tile(
            dict(sq=sq, skv=skv, d=d, hq=hq, hkv=hkv, window=window or 0),
            str(q.dtype))
    bq, bkv = launch_tile(tile, sq, skv, d)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    rc = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, hq, hkv, sq, skv, d, build.dtype_code(q.dtype), bq, bkv,
                float(scale), int(bool(causal)), int(window or 0),
                float(softcap or 0.0), int(q_offset),
                build.stream_ptr(q.device))
    build.check(rc, "flash_attention")
    build.LAUNCHES["flash_attention"] += 1
    return out


@functools.lru_cache(maxsize=None)
def _bq_limits() -> Dict[int, int]:
    """``{head dim: largest bq}`` as ``REPRO_FA_BQ_LIMITS`` in the kernel's
    source states it, the one place that rule lives."""
    text = (build.CSRC / build.SOURCES["flash_attention"]).read_text()
    table = re.search(r"#define REPRO_FA_BQ_LIMITS((?:.*\\\n)*.*)", text)
    return {int(d): int(bq)
            for d, bq in re.findall(r"X\((\d+),\s*(\d+)\)", table.group(1))}


def bq_max(d: int) -> int:
    """Largest bq the kernel takes at head dim ``d`` (64 at D = 256, where a
    thread's accumulator would otherwise double); 0 where it takes none."""
    return _bq_limits().get(d, 0)


def launch_tile(tile, sq: int, skv: int, d: int):
    """The ``(bq, bkv)`` the kernel runs for ``tile``: clamped to the problem
    (rounded up to a multiple of 4). Raises ValueError for a tile or head
    dim the kernel cannot launch."""
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention head_dim {d} not in {HEAD_DIMS}")
    bq = min(int(tile[0]), round_up(sq, 4))
    bkv = min(int(tile[1]), round_up(skv, 4))
    if bq <= 0 or bkv <= 0 or bq % 4 or bkv % 4 or bq > bq_max(d):
        raise ValueError(f"flash_attention tile ({bq}, {bkv}) needs multiples "
                         f"of 4 and bq <= {bq_max(d)} at head_dim {d}")
    if smem_bytes(bq, bkv, d) > H100_SXM.vmem_bytes:
        raise ValueError(f"flash_attention tile ({bq}, {bkv}) needs "
                         f"{smem_bytes(bq, bkv, d)} B of shared memory; a "
                         f"block may use {H100_SXM.vmem_bytes}")
    return bq, bkv


def smem_bytes(bq: int, bkv: int, d: int) -> int:
    """Shared memory one block of the kernel uses: float32 q, padded K, V,
    the [bq, bkv] logits and three per-row statistics."""
    return 4 * (bq * d + bkv * (d + 1) + bkv * d + bq * bkv + 3 * bq)


__all__ = ["NEG_INF", "bq_max", "flash_attention", "launch_tile", "smem_bytes"]
