"""Granite-34B-Code — GPTBigCode arch: MQA, 2-matrix GELU MLP, learned positions
[arXiv:2405.04324].

A copy of ``repro/configs/granite_34b.py``.
"""
from repro_torch.configs.base import ArchConfig, register

GRANITE_34B = register(
    ArchConfig(
        name="granite-34b",
        family="dense",
        n_layers=88,
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,
        d_ff=24576,
        vocab=49152,
        norm="layernorm",
        mlp="gelu2",
        positions="learned",
        tie_embeddings=True,
    )
)
