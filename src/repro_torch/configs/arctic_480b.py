"""Snowflake Arctic 480B — 128 experts top-2 + dense residual FFN
[hf:Snowflake/snowflake-arctic-base].

A copy of ``repro/configs/arctic_480b.py``.
"""
from repro_torch.configs.base import ArchConfig, register

ARCTIC_480B = register(
    ArchConfig(
        name="arctic-480b",
        family="moe",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=4864,
        vocab=32000,
        mlp="swiglu",
        positions="rope",
        n_experts=128,
        top_k=2,
        moe_d_ff=4864,
        dense_residual=True,
        optimizer="adamw8bit",
    )
)
