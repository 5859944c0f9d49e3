"""Decoder-only transformer, dense family with no cache, from
``repro/models/transformer.py`` (``init_layer``, ``init_transformer``,
``forward``).

Layer params are stacked on a leading axis exactly as in JAX, so state
paths and shapes match the JAX pytree. ``lax.scan`` over the stack becomes
a Python loop over its unbound slices; ``jax.checkpoint`` becomes
``torch.utils.checkpoint`` (non-reentrant) when ``cfg.remat`` is set.
Activations run in bf16.

Not ported yet: MoE layers, gemma2's local/global alternation, the prefix-LM
wrapper and KV caches.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as T
from repro_torch.models import layers as L
from repro_torch.models.layers import MaskSpec


def init_layer(gen, cfg, device):
    if cfg.is_moe:
        raise NotImplementedError("MoE layers are not ported yet")
    p = {
        "ln1": L.init_norm(cfg.d_model, cfg.norm, device),
        "attn": L.init_attention(gen, cfg, device),
        "ln2": L.init_norm(cfg.d_model, cfg.norm, device),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp, device),
    }
    if cfg.post_norm:
        p["post_ln1"] = L.init_norm(cfg.d_model, cfg.norm, device)
        p["post_ln2"] = L.init_norm(cfg.d_model, cfg.norm, device)
    return p


def init_transformer(cfg, gen: torch.Generator, device):
    per_layer = [init_layer(gen, cfg, device) for _ in range(cfg.n_layers)]
    stacked = T.tree_map(lambda *ls: torch.stack(ls), *per_layer)
    return {
        "embed": L.init_embed(gen, cfg, device),
        "layers": stacked,
        "final_norm": L.init_norm(cfg.d_model, cfg.norm, device),
    }


def _layer_body(cfg, x, lp, spec, is_local, positions):
    h = L.apply_norm(lp["ln1"], x, cfg.norm, cfg.norm_eps)
    attn_out = L.attention_sublayer(lp["attn"], h, cfg, spec,
                                    positions=positions, is_local=is_local)
    if cfg.post_norm:
        attn_out = L.apply_norm(lp["post_ln1"], attn_out, cfg.norm, cfg.norm_eps)
    x = x + attn_out
    h = L.apply_norm(lp["ln2"], x, cfg.norm, cfg.norm_eps)
    ff = L.mlp_sublayer(lp["mlp"], h, cfg.mlp)
    if cfg.post_norm:
        ff = L.apply_norm(lp["post_ln2"], ff, cfg.norm, cfg.norm_eps)
    return x + ff


def forward(cfg, params, tokens, *, return_hidden: bool = False,
            dtype=torch.bfloat16):
    """Train/eval forward: tokens (B, S) int64 → (logits, aux_loss), or
    (final hidden states, aux_loss) with ``return_hidden``."""
    if cfg.alt_local_global:
        raise NotImplementedError("local/global alternation is not ported yet")
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)
    x = L.embed_tokens(params["embed"], tokens, cfg, positions=positions,
                       dtype=dtype)
    spec = MaskSpec(kind="causal", window=cfg.sliding_window, prefix_len=0)
    # A uniform window applies to every layer; none leaves is_local unset.
    is_local = True if cfg.sliding_window > 0 else None
    for lp in T.unstack(params["layers"], cfg.n_layers):
        if cfg.remat:
            x = checkpoint(_layer_body, cfg, x, lp, spec, is_local, positions,
                           use_reentrant=False)
        else:
            x = _layer_body(cfg, x, lp, spec, is_local, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = L.apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    if return_hidden:
        return x, aux
    return L.unembed(params["embed"], x, cfg), aux
