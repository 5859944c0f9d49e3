"""Zamba2 hybrid, training path, from ``repro/models/zamba2.py``
[arXiv:2411.15242].

A stack of Mamba2 blocks with a single weight-shared attention+MLP block
applied every ``shared_attn_every`` layers on concat([h, h₀]) (h₀ = the
embedding output). The 38 Mamba2 blocks are grouped into segments of
``shared_attn_every``; each segment starts with one application of the
shared block (RoPE causal attention through the flash-attention kernel),
then runs its Mamba2 blocks. With ``cfg.remat`` each Mamba2 block is
checkpointed (non-reentrant); the shared block is applied outside the
checkpoint, as in JAX.

Not ported yet (serving): the ``state`` branch of ``forward`` (KV caches,
Mamba2 states), ``make_state`` and ``state_specs``.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as T
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models.layers import MaskSpec


def _segments(cfg):
    """Split n_layers mamba blocks into segments, each preceded by the shared
    block. E.g. 38 layers, every 6 → apps at block 0,6,12,18,24,30,36."""
    every = cfg.shared_attn_every
    bounds = list(range(0, cfg.n_layers, every)) + [cfg.n_layers]
    return [(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)]


def n_shared_apps(cfg):
    return len(_segments(cfg))


def init_shared_block(gen, cfg, device):
    d = cfg.d_model
    return {
        "in_proj": L._normal(gen, (2 * d, d), device) / math.sqrt(2 * d),
        "ln1": L.init_norm(d, cfg.norm, device),
        "attn": L.init_attention(gen, cfg, device),
        "ln2": L.init_norm(d, cfg.norm, device),
        "mlp": L.init_mlp(gen, d, cfg.d_ff, cfg.mlp, device),
    }


def init_zamba2(cfg, gen: torch.Generator, device):
    per_layer = [M2.init_block(gen, cfg, device) for _ in range(cfg.n_layers)]
    return {
        "embed": L.init_embed(gen, cfg, device),
        "mamba": T.tree_map(lambda *ls: torch.stack(ls), *per_layer),
        "shared": init_shared_block(gen, cfg, device),
        "final_norm": L.init_norm(cfg.d_model, cfg.norm, device),
    }


def _shared_apply(sp, x, x0, cfg, positions):
    dt = x.dtype
    z = torch.cat([x, x0], dim=-1) @ sp["in_proj"].to(dt)
    h = L.apply_norm(sp["ln1"], z, cfg.norm)
    z = z + L.attention_sublayer(sp["attn"], h, cfg, MaskSpec("causal"),
                                 positions=positions)
    h = L.apply_norm(sp["ln2"], z, cfg.norm)
    z = z + L.mlp_sublayer(sp["mlp"], h, cfg.mlp)
    return x + z


def _mamba_body(cfg, x, lp):
    return x + M2.block_apply(lp, x, cfg)


def forward(cfg, params, tokens, *, return_hidden: bool = False,
            dtype=torch.bfloat16):
    """Train/eval forward with no cache: tokens (B, S) int64 →
    (logits, aux_loss), or (final hidden states, aux_loss) with
    ``return_hidden``."""
    B, S = tokens.shape
    x = L.embed_tokens(params["embed"], tokens, cfg, dtype=dtype)
    x0 = x
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    blocks = T.unstack(params["mamba"], cfg.n_layers)
    for lo, hi in _segments(cfg):
        # Shared attention block (weight-tied across applications).
        x = _shared_apply(params["shared"], x, x0, cfg, positions)
        for lp in blocks[lo:hi]:
            if cfg.remat:
                x = checkpoint(_mamba_body, cfg, x, lp, use_reentrant=False)
            else:
                x = _mamba_body(cfg, x, lp)
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_hidden:
        return x, aux
    return L.unembed(params["embed"], x, cfg), aux
