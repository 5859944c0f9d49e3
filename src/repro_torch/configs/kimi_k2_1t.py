"""Kimi-K2 1T-A32B — trillion-param MoE, 384 experts top-8 + 1 shared expert
[arXiv:2501.kimi2 paper table].

A copy of ``repro/configs/kimi_k2_1t.py``.
"""
from repro_torch.configs.base import ArchConfig, register

KIMI_K2_1T = register(
    ArchConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        head_dim=112,
        d_ff=2048,  # expert hidden dim (paper table)
        vocab=163840,
        mlp="swiglu",
        positions="rope",
        n_experts=384,
        top_k=8,
        moe_d_ff=2048,
        n_shared_experts=1,
        optimizer="adamw8bit",
    )
)
