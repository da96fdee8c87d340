"""Model configurations (port of ``repro.configs``)."""

from repro_torch.configs.base import (
    ARCH_IDS,
    SHAPES,
    ModelConfig,
    ShapeConfig,
    all_cells,
    applicable_shapes,
    get_config,
)

__all__ = [
    "ARCH_IDS",
    "SHAPES",
    "ModelConfig",
    "ShapeConfig",
    "all_cells",
    "applicable_shapes",
    "get_config",
]
