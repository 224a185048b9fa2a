"""Hand-written Hopper kernels of the port, one CUDA C++ source each under
``csrc/``, with a plain PyTorch version beside every wrapper.

Nothing is compiled at import: ``build.py`` runs ``nvcc`` at first use on a
machine with the CUDA toolkit.
"""


def register_all() -> None:
    """Import every kernel's ops module so its KernelSpec is registered."""
    import repro_torch.kernels.bilinear.ops  # noqa: F401
    import repro_torch.kernels.flash_attention.ops  # noqa: F401
    import repro_torch.kernels.matmul.ops  # noqa: F401
    import repro_torch.kernels.rglru.ops  # noqa: F401
    import repro_torch.kernels.ssd.ops  # noqa: F401
