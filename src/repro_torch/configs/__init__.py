"""Architecture configs of the port: the families it trains — the dense
family (GPT-2, TinyLlama, granite-34b, llama3-405b, gemma2-27b), RWKV-6
(ssm), Zamba2 (hybrid), PaliGemma (vlm) and Snowflake Arctic (moe). The
other configs of ``repro.configs`` (whisper, kimi-k2-1t-a32b) come with
their model code."""
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
from repro_torch.configs import (  # noqa: F401
    arctic_480b,
    gemma2_27b,
    gpt2,
    granite_34b,
    llama3_405b,
    paligemma_3b,
    rwkv6_1_6b,
    tinyllama_1_1b,
    zamba2_1_2b,
)

__all__ = [
    "ArchConfig",
    "ShapeCell",
    "SHAPES",
    "SHAPE_CELLS",
    "get_config",
    "list_configs",
    "register",
]
