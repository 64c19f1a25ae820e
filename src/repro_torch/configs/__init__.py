from repro_torch.configs.base import (
    ARCH_IDS,
    SHAPES,
    LayerKind,
    ModelConfig,
    ShapeConfig,
    get_config,
    reduced,
    runnable_cells,
)

__all__ = [
    "ARCH_IDS",
    "SHAPES",
    "LayerKind",
    "ModelConfig",
    "ShapeConfig",
    "get_config",
    "reduced",
    "runnable_cells",
]
