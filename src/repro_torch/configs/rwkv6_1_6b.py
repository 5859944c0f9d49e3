"""RWKV-6 "Finch" 1.6B — attention-free, data-dependent decay [arXiv:2404.05892].

A copy of ``repro/configs/rwkv6_1_6b.py``: the port trains ``rwkv6-1.6b``.
"""
from repro_torch.configs.base import ArchConfig, register

RWKV6_1_6B = register(
    ArchConfig(
        name="rwkv6-1.6b",
        family="ssm",
        n_layers=24,
        d_model=2048,
        n_heads=32,  # wkv heads (head_dim = 64)
        n_kv_heads=32,
        head_dim=64,
        d_ff=7168,
        vocab=65536,
        norm="layernorm",
        mlp="gelu2",  # rwkv channel-mix is 2-matrix (squared-relu) + receptance
        positions="rope",  # unused (attention-free); kept for config uniformity
    )
)
