"""GPT-2 S/M/L — the paper's own text-pretraining models (§VI, Figs 8/13/14).

A copy of ``repro/configs/gpt2.py``: the port's main path trains ``gpt2``.
"""
from repro_torch.configs.base import ArchConfig, register


def _gpt2(name, n_layers, d_model, n_heads):
    return register(
        ArchConfig(
            name=name,
            family="dense",
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_heads,
            d_ff=4 * d_model,
            vocab=50257,
            norm="layernorm",
            mlp="gelu2",
            positions="learned",
            tie_embeddings=True,
        )
    )


GPT2_SMALL = _gpt2("gpt2", 12, 768, 12)
GPT2_MEDIUM = _gpt2("gpt2-medium", 24, 1024, 16)
GPT2_LARGE = _gpt2("gpt2-large", 36, 1280, 20)
