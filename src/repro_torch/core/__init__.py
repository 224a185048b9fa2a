"""Core of the port: hardware descriptors, tiling constraints, the cost
model, the autotuner, tiling policies, the kernel registry and AOT tile
plans (the port's copies of ``repro/core``)."""
from repro_torch.core.autotuner import Autotuner, NoLegalTileError, SweepResult
from repro_torch.core.cost_model import CostBreakdown, TileWorkload, estimate
from repro_torch.core.hardware import (
    GEFORCE_8800GTS,
    GTX260,
    H100_SXM,
    MODELLED,
    PRODUCTION_TARGET,
    REGISTRY as HARDWARE_REGISTRY,
    HardwareModel,
)
from repro_torch.core.plans import (
    PLAN_SCHEMA_VERSION,
    PlanEntry,
    PlanError,
    PlanResolution,
    PlanSchemaError,
    PlanTransferWarning,
    PlanVersionWarning,
    TilePlan,
    compile_plan,
)
from repro_torch.core.policy import TilingPolicy, default_policy, set_default_policy
from repro_torch.core.tiling import TileConstraints, TileShape, cdiv, round_up

__all__ = [
    "Autotuner", "NoLegalTileError", "SweepResult", "CostBreakdown",
    "TileWorkload", "estimate", "HardwareModel", "HARDWARE_REGISTRY",
    "PRODUCTION_TARGET", "H100_SXM", "GTX260", "GEFORCE_8800GTS", "MODELLED",
    "TilingPolicy", "default_policy", "set_default_policy", "TileConstraints", "TileShape", "cdiv", "round_up",
    "PLAN_SCHEMA_VERSION", "PlanEntry", "PlanError", "PlanResolution",
    "PlanSchemaError", "PlanTransferWarning", "PlanVersionWarning",
    "TilePlan", "compile_plan",
]
