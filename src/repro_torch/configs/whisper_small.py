"""Whisper-small — encoder-decoder backbone; conv frontend STUBBED
[arXiv:2212.04356].

``input_specs()`` supplies precomputed frame embeddings (batch, enc_len, d_model)
in place of the log-mel + conv1d frontend. 12 encoder + 12 decoder layers.

A copy of ``repro/configs/whisper_small.py``.
"""
from repro_torch.configs.base import ArchConfig, register

WHISPER_SMALL = register(
    ArchConfig(
        name="whisper-small",
        family="encdec",
        n_layers=12,  # decoder layers
        enc_layers=12,
        enc_len=1500,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        d_ff=3072,
        vocab=51865,
        norm="layernorm",
        mlp="gelu2",
        positions="learned",
        tie_embeddings=True,
    )
)
