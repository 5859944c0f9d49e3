"""Architecture configs of the port: the families it trains — GPT-2
(dense), RWKV-6 (ssm) and Zamba2 (hybrid). The other configs of
``repro.configs`` come with their model code."""
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
from repro_torch.configs import gpt2, rwkv6_1_6b, zamba2_1_2b  # noqa: F401

__all__ = [
    "ArchConfig",
    "ShapeCell",
    "SHAPES",
    "SHAPE_CELLS",
    "get_config",
    "list_configs",
    "register",
]
