"""Decoder-only transformer, the dense, vlm and moe families, from
``repro/models/transformer.py`` (``init_layer``, ``init_transformer``,
``forward`` with its KV-cache path, ``make_cache``, ``cache_specs``).

Layer params are stacked on a leading axis exactly as in JAX, so state
paths and shapes match the JAX pytree. ``lax.scan`` over the stack becomes
a Python loop over its unbound slices; ``jax.checkpoint`` becomes
``torch.utils.checkpoint`` (non-reentrant) when ``cfg.remat`` is set.
Activations run in bf16. The serving path writes the KV cache in place,
one layer's slice at a time, and never remats.

Gemma2's local/global alternation is a per-layer Python ``bool``
(``_is_local_flags``): even layers local (the window applies), odd layers
global. Where the JAX package scans a traced flag, which keeps gemma2 off
its Pallas path, every layer here reaches the attention kernel.

The prefix-LM wrapper (PaliGemma, the vlm family): ``patch_embeds`` (B, P,
d) go in front of the token embeddings, the mask is ``prefix`` (the P
patch rows attend to each other both ways, the text causally to all), and
RoPE positions and the KV cache's rows count the prefix (``make_cache``'s
``prefix``). The prefill writes rows ``0 … P + S - 1``; a decode step's
position is the absolute cache row.

An MoE config (Arctic, the moe family) has ``moe`` (``models/moe.py``) in
each layer in place of ``mlp``. Each layer returns its load-balance aux
loss beside its output (None without MoE), also out of the checkpointed
layer under remat, and ``forward`` sums it over the layers in fp32 in
layer order, as JAX's scan carries it. Every layer's tokens form one group
(``n_groups=1``), as the JAX trainer runs them.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as T
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models.layers import MaskSpec


def init_layer(gen, cfg, device):
    p = {
        "ln1": L.init_norm(cfg.d_model, cfg.norm, device),
        "attn": L.init_attention(gen, cfg, device),
        "ln2": L.init_norm(cfg.d_model, cfg.norm, device),
    }
    if cfg.is_moe:
        p["moe"] = MOE.init_moe(gen, cfg, device)
    else:
        p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp, device)
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


def _is_local_flags(cfg):
    """Each layer's ``is_local`` for ``attention_sublayer``: None without a
    window; True for a uniform window; with ``alt_local_global``, True on
    even layers (local) and False on odd ones (global), gemma2's order."""
    if cfg.sliding_window == 0:
        return [None] * cfg.n_layers
    if cfg.alt_local_global:
        return [i % 2 == 0 for i in range(cfg.n_layers)]
    return [True] * cfg.n_layers


def _layer_body(cfg, x, lp, spec, is_local, positions, cache_kv=None,
                cache_pos=None):
    """One layer → (output, its MoE aux loss: an fp32 scalar; None without
    MoE)."""
    h = L.apply_norm(lp["ln1"], x, cfg.norm, cfg.norm_eps)
    attn_out, _ = L.attention_sublayer(lp["attn"], h, cfg, spec,
                                       positions=positions, cache_kv=cache_kv,
                                       cache_pos=cache_pos, is_local=is_local)
    if cfg.post_norm:
        attn_out = L.apply_norm(lp["post_ln1"], attn_out, cfg.norm, cfg.norm_eps)
    x = x + attn_out
    h = L.apply_norm(lp["ln2"], x, cfg.norm, cfg.norm_eps)
    if cfg.is_moe:
        ff, aux = MOE.moe_sublayer(lp["moe"], h, cfg)
    else:
        ff, aux = L.mlp_sublayer(lp["mlp"], h, cfg.mlp), None
    if cfg.post_norm:
        ff = L.apply_norm(lp["post_ln2"], ff, cfg.norm, cfg.norm_eps)
    return x + ff, aux


def forward(cfg, params, tokens, *, patch_embeds=None, cache=None,
            cache_pos=None, last_only: bool = False,
            return_hidden: bool = False, dtype=torch.bfloat16):
    """Run the transformer on tokens (B, S) int64.

    Train/eval: ``cache is None`` → (logits, aux_loss), or (final hidden
    states, aux_loss) with ``return_hidden``.
    Prefill: ``cache`` holds zeroed k, v of shape (L, B, Smax, K, hd) and
      ``cache_pos`` is 0 → (logits, cache, aux).
    Decode: tokens (B, 1), ``cache_pos`` the write position → the same.
    The cache is written in place and returned as the same dict.
    ``patch_embeds`` (B, P, d): a prefix in front of the tokens (vlm),
    bidirectional among itself; the outputs cover the tokens only.
    ``last_only`` keeps the last position's logits only."""
    if cache is not None and cache_pos is None:
        raise ValueError("cache requires cache_pos")
    B, S = tokens.shape
    prefix = 0 if patch_embeds is None else patch_embeds.shape[1]
    offset = 0 if cache is None else int(cache_pos)
    positions = offset + torch.arange(S + prefix, device=tokens.device)
    x = L.embed_tokens(params["embed"], tokens, cfg,
                       positions=positions[prefix:], dtype=dtype)
    if patch_embeds is not None:
        x = torch.cat([patch_embeds.to(device=x.device, dtype=dtype), x], dim=1)
    spec = MaskSpec(kind="prefix" if prefix > 0 else "causal",
                    window=cfg.sliding_window, prefix_len=prefix)
    layers = T.unstack(params["layers"], cfg.n_layers)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (lp, is_local) in enumerate(zip(layers, _is_local_flags(cfg))):
        if cache is not None:
            x, layer_aux = _layer_body(cfg, x, lp, spec, is_local, positions,
                                       (cache["k"][i], cache["v"][i]), offset)
        elif cfg.remat:
            x, layer_aux = checkpoint(_layer_body, cfg, x, lp, spec, is_local,
                                      positions, use_reentrant=False)
        else:
            x, layer_aux = _layer_body(cfg, x, lp, spec, is_local, positions)
        if layer_aux is not None:
            aux = aux + layer_aux
    x = L.apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    if prefix > 0:
        x = x[:, prefix:]
    if last_only:
        x = x[:, -1:]
    if return_hidden and cache is None:
        return x, aux
    logits = L.unembed(params["embed"], x, cfg)
    if cache is not None:
        return logits, cache, aux
    return logits, aux


def make_cache(cfg, batch, max_len, dtype=torch.bfloat16, device=None,
               prefix=0):
    """Zeroed KV cache {"k", "v"} of shape (L, batch, max_len + prefix, K,
    hd): ``prefix`` rows more for a vlm's patches, as in JAX."""
    shape = (cfg.n_layers, batch, max_len + prefix, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_specs(cfg, batch, max_len, dtype=torch.bfloat16, prefix=0):
    """The cache's shapes and dtypes as meta-device tensors (no memory)."""
    return make_cache(cfg, batch, max_len, dtype, device="meta", prefix=prefix)
