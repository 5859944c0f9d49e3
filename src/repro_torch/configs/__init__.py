"""Architecture configs of the port, every config of ``repro.configs``:
the dense family (GPT-2, TinyLlama, granite-34b, llama3-405b, gemma2-27b),
RWKV-6 (ssm), Zamba2 (hybrid), PaliGemma (vlm), Snowflake Arctic and
Kimi-K2 (moe) and Whisper-small (encdec). ``ASSIGNED`` is the JAX
package's tuple of assigned archs."""
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
    kimi_k2_1t,
    llama3_405b,
    paligemma_3b,
    rwkv6_1_6b,
    tinyllama_1_1b,
    whisper_small,
    zamba2_1_2b,
)

ASSIGNED = (
    "paligemma-3b",
    "whisper-small",
    "gemma2-27b",
    "tinyllama-1.1b",
    "granite-34b",
    "llama3-405b",
    "kimi-k2-1t-a32b",
    "arctic-480b",
    "rwkv6-1.6b",
    "zamba2-1.2b",
)

__all__ = [
    "ArchConfig",
    "ShapeCell",
    "SHAPES",
    "SHAPE_CELLS",
    "ASSIGNED",
    "get_config",
    "list_configs",
    "register",
]
