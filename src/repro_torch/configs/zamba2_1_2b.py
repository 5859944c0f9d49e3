"""Zamba2-1.2B — Mamba2 backbone + shared attention block every 6 layers
[arXiv:2411.15242].

A copy of ``repro/configs/zamba2_1_2b.py``: the port trains ``zamba2-1.2b``.
"""
from repro_torch.configs.base import ArchConfig, register

ZAMBA2_1_2B = register(
    ArchConfig(
        name="zamba2-1.2b",
        family="hybrid",
        n_layers=38,  # mamba2 blocks
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        vocab=32000,
        mlp="gelu2",
        positions="rope",
        tie_embeddings=True,
        ssm_state=64,
        ssm_expand=2,
        ssm_heads=64,  # d_inner=4096, head size 64
        shared_attn_every=6,
    )
)
