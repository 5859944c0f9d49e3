"""Llama-3 405B — dense GQA, 128k vocab [arXiv:2407.21783].

A copy of ``repro/configs/llama3_405b.py``.
"""
from repro_torch.configs.base import ArchConfig, register

LLAMA3_405B = register(
    ArchConfig(
        name="llama3-405b",
        family="dense",
        n_layers=126,
        d_model=16384,
        n_heads=128,
        n_kv_heads=8,
        d_ff=53248,
        vocab=128256,
        mlp="swiglu",
        positions="rope",
        rope_theta=500_000.0,
        optimizer="adamw8bit",  # fp32 moments do not fit 16 GiB/chip at 256 chips
    )
)
