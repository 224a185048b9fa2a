"""Core of the port: hardware descriptors, tile shapes, the kernel registry."""
from repro_torch.core.cost_model import TileWorkload
from repro_torch.core.hardware import (
    H100_SXM,
    PRODUCTION_TARGET,
    REGISTRY as HARDWARE_REGISTRY,
    HardwareModel,
)
from repro_torch.core.tiling import TileConstraints, TileShape, cdiv, round_up

__all__ = [
    "TileWorkload", "HardwareModel", "HARDWARE_REGISTRY", "PRODUCTION_TARGET",
    "H100_SXM", "TileConstraints", "TileShape", "cdiv", "round_up",
]
