from repro_torch.optim.adamw import (
    adamw,
    adamw8bit,
    clip_by_global_norm,
    global_norm,
    make_optimizer,
    sgdm,
)
from repro_torch.optim.compression import (
    int8_dequantize,
    int8_quantize,
    topk_compress_ef,
)
from repro_torch.optim.lora import lora_apply_delta, lora_init, lora_merge

__all__ = [
    "adamw",
    "adamw8bit",
    "sgdm",
    "make_optimizer",
    "clip_by_global_norm",
    "global_norm",
    "topk_compress_ef",
    "int8_quantize",
    "int8_dequantize",
    "lora_init",
    "lora_apply_delta",
    "lora_merge",
]
