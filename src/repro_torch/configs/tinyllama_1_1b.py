"""TinyLlama-1.1B — llama2-arch small [arXiv:2401.02385].

A copy of ``repro/configs/tinyllama_1_1b.py``.
"""
from repro_torch.configs.base import ArchConfig, register

TINYLLAMA_1_1B = register(
    ArchConfig(
        name="tinyllama-1.1b",
        family="dense",
        n_layers=22,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        d_ff=5632,
        vocab=32000,
        mlp="swiglu",
        positions="rope",
        rope_theta=10_000.0,
    )
)
