"""Architecture configs of the port. Only the GPT-2 family is registered:
the other families of ``repro.configs`` come with their model code."""
from repro_torch.configs.base import (
    SHAPE_CELLS,
    SHAPES,
    ArchConfig,
    ShapeCell,
    get_config,
    list_configs,
    register,
)

# Import per-arch modules for registry side effects.
from repro_torch.configs import gpt2  # noqa: F401

__all__ = [
    "ArchConfig",
    "ShapeCell",
    "SHAPES",
    "SHAPE_CELLS",
    "get_config",
    "list_configs",
    "register",
]
