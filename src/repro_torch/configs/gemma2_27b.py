"""Gemma-2 27B — alternating local/global attention + logit softcaps
[arXiv:2408.00118].

A copy of ``repro/configs/gemma2_27b.py``.
"""
from repro_torch.configs.base import ArchConfig, register

GEMMA2_27B = register(
    ArchConfig(
        name="gemma2-27b",
        family="dense",
        n_layers=46,
        d_model=4608,
        n_heads=32,
        n_kv_heads=16,
        head_dim=128,
        d_ff=36864,
        vocab=256000,
        mlp="geglu",
        positions="rope",
        tie_embeddings=True,
        attn_softcap=50.0,
        final_softcap=30.0,
        sliding_window=4096,
        alt_local_global=True,
        query_scale=0.0625,
        post_norm=True,
        embed_scale=True,  # gemma2-27b scales queries by 1/sqrt(d_model/n_heads)=1/12 -> uses 1/sqrt(256)
        optimizer="adamw8bit",
    )
)
