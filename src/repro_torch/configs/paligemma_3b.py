"""PaliGemma-3B — Gemma-2B text backbone + SigLIP patch-embedding stub
[arXiv:2407.07726].

A copy of ``repro/configs/paligemma_3b.py``. The vision tower is a stub:
the model takes precomputed patch embeddings of shape (batch, n_patches,
d_model) as a prefix before the token embeddings (prefix-LM attention:
bidirectional over the image prefix, causal over the text).
"""
from repro_torch.configs.base import ArchConfig, register

PALIGEMMA_3B = register(
    ArchConfig(
        name="paligemma-3b",
        family="vlm",
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab=257216,
        mlp="geglu",
        positions="rope",
        tie_embeddings=True,
        n_patches=256,
        embed_scale=True,
    )
)
