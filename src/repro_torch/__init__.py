"""PyTorch/CUDA port of the ``repro`` package for NVIDIA Hopper (H100).

Module names mirror ``repro``'s so each counterpart is easy to find. The
port imports ``torch`` and ``numpy`` only — never ``jax`` and nothing of
the ``repro`` package. Its entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; on CUDA tensors every kernel of the serving path
is a hand-written CUDA C++ kernel (``kernels/csrc``), on CPU tensors its
plain PyTorch version runs.
"""
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default.

    Raises when no card is present and the caller did not ask for the CPU —
    an entry point never drops to the CPU on its own.
    """
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev
