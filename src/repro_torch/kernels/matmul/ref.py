"""Plain PyTorch version of the tiled matmul kernel."""
from __future__ import annotations

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """a [M, K] @ b [K, N] with float32 accumulation, cast to ``out_dtype``."""
    out_dtype = out_dtype or a.dtype
    return torch.matmul(a.float(), b.float()).to(out_dtype)
