"""Whisper-small encoder–decoder backbone (the encdec family), from
``repro/models/whisper.py``. The log-mel + conv1d frontend is a stub, as
there: the inputs are precomputed frame embeddings (B, enc_len, d_model).
Pre-LN blocks, learned positions, GELU MLPs.

The encoder runs full attention over the ``enc_len`` frames; each decoder
layer runs causal self-attention, then cross-attention from the text to
the encoder's output, then its MLP. Layer params are stacked on a leading
axis as in JAX (``encoder``, ``decoder``), so state paths and shapes match
the JAX pytree. ``lax.scan`` becomes a Python loop, ``jax.checkpoint``
``torch.utils.checkpoint`` (non-reentrant) where ``cfg.remat`` asks; the
serving path never remats.

The cache (``make_cache``) holds each decoder layer's self K/V (``k``,
``v``: (L, B, max_len, K, hd)), written in place at each step's position,
and its cross K/V (``xk``, ``xv``: (L, B, enc_len, K, hd)), which a prefill
given ``frames`` fills once from the encoder's output
(``precompute_cross_kv``) and every later step reads as it is
(``static_kv``). Every attention runs the flash-attention kernel: the
encoder's over 1,500 frames, which no tile size divides, and the
cross-attention with Sq != Skv.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as T
from repro_torch.models import layers as L
from repro_torch.models.layers import MaskSpec


def init_enc_layer(gen, cfg, device):
    return {
        "ln1": L.init_norm(cfg.d_model, cfg.norm, device),
        "attn": L.init_attention(gen, cfg, device),
        "ln2": L.init_norm(cfg.d_model, cfg.norm, device),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp, device),
    }


def init_dec_layer(gen, cfg, device):
    return {
        "ln1": L.init_norm(cfg.d_model, cfg.norm, device),
        "attn": L.init_attention(gen, cfg, device),
        "ln_x": L.init_norm(cfg.d_model, cfg.norm, device),
        "xattn": L.init_attention(gen, cfg, device),
        "ln2": L.init_norm(cfg.d_model, cfg.norm, device),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp, device),
    }


def _stack(layers):
    return T.tree_map(lambda *ls: torch.stack(ls), *layers)


def init_whisper(cfg, gen: torch.Generator, device):
    return {
        "embed": L.init_embed(gen, cfg, device),
        "enc_pos": L._normal(gen, (cfg.enc_len, cfg.d_model), device) * 0.02,
        "encoder": _stack([init_enc_layer(gen, cfg, device)
                           for _ in range(cfg.enc_layers)]),
        "enc_norm": L.init_norm(cfg.d_model, cfg.norm, device),
        "decoder": _stack([init_dec_layer(gen, cfg, device)
                           for _ in range(cfg.n_layers)]),
        "final_norm": L.init_norm(cfg.d_model, cfg.norm, device),
    }


def _enc_body(cfg, x, lp):
    h = L.apply_norm(lp["ln1"], x, cfg.norm)
    a, _ = L.attention_sublayer(lp["attn"], h, cfg, MaskSpec("full"))
    x = x + a
    h = L.apply_norm(lp["ln2"], x, cfg.norm)
    return x + L.mlp_sublayer(lp["mlp"], h, cfg.mlp)


def encode(cfg, params, frames):
    """frames: (B, enc_len, d) stubbed frontend output, in the activations'
    dtype → the encoder's output (B, enc_len, d)."""
    x = frames + params["enc_pos"].to(frames.dtype)[None]
    for lp in T.unstack(params["encoder"], cfg.enc_layers):
        if cfg.remat:
            x = checkpoint(_enc_body, cfg, x, lp, use_reentrant=False)
        else:
            x = _enc_body(cfg, x, lp)
    return L.apply_norm(params["enc_norm"], x, cfg.norm)


def _dec_body(cfg, x, lp, positions, self_kv, cross, cache_pos):
    """One decoder layer. ``cross``: the encoder's output (teacher forcing)
    or the layer's (xk, xv) cross cache (cached decode)."""
    h = L.apply_norm(lp["ln1"], x, cfg.norm)
    a, _ = L.attention_sublayer(lp["attn"], h, cfg, MaskSpec("causal"),
                                positions=positions, cache_kv=self_kv,
                                cache_pos=cache_pos)
    x = x + a
    h = L.apply_norm(lp["ln_x"], x, cfg.norm)
    is_cached = isinstance(cross, tuple)
    a, _ = L.attention_sublayer(lp["xattn"], h, cfg, MaskSpec("full"),
                                positions=positions,
                                kv_x=None if is_cached else cross,
                                cache_kv=cross if is_cached else None,
                                static_kv=is_cached, cache_pos=cache_pos)
    x = x + a
    h = L.apply_norm(lp["ln2"], x, cfg.norm)
    return x + L.mlp_sublayer(lp["mlp"], h, cfg.mlp)


def decode_stack(cfg, params, tokens, enc_out=None, cache=None, cache_pos=None,
                 last_only: bool = False, return_hidden: bool = False,
                 dtype=torch.bfloat16):
    """Teacher forcing (``enc_out`` given, ``cache`` None) → (logits, None),
    or (final hidden states, None) with ``return_hidden``; or a cached
    decode from ``cache_pos`` → (logits, cache), the self caches written
    in place and the same dict returned."""
    B, S = tokens.shape
    offset = 0 if cache_pos is None else int(cache_pos)
    positions = offset + torch.arange(S, device=tokens.device)
    x = L.embed_tokens(params["embed"], tokens, cfg, positions=positions, dtype=dtype)
    for i, lp in enumerate(T.unstack(params["decoder"], cfg.n_layers)):
        if cache is not None:
            x = _dec_body(cfg, x, lp, positions, (cache["k"][i], cache["v"][i]),
                          (cache["xk"][i], cache["xv"][i]), offset)
        elif cfg.remat:
            x = checkpoint(_dec_body, cfg, x, lp, positions, None, enc_out, None,
                           use_reentrant=False)
        else:
            x = _dec_body(cfg, x, lp, positions, None, enc_out, None)
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    if last_only:
        x = x[:, -1:]
    if return_hidden and cache is None:
        return x, None
    return L.unembed(params["embed"], x, cfg), cache


def precompute_cross_kv(cfg, params, enc_out):
    """Project the encoder's output to every decoder layer's cross K/V once
    (the prefill) → (xk, xv), each (L, B, enc_len, K, hd)."""
    B, Tn, _ = enc_out.shape
    K, hd = cfg.n_kv_heads, cfg.head_dim
    dt = enc_out.dtype
    xattn = params["decoder"]["xattn"]
    ks = [(enc_out @ w.to(dt)).reshape(B, Tn, K, hd) for w in xattn["wk"].unbind(0)]
    vs = [(enc_out @ w.to(dt)).reshape(B, Tn, K, hd) for w in xattn["wv"].unbind(0)]
    return torch.stack(ks), torch.stack(vs)


def forward(cfg, params, tokens, *, frames=None, cache=None, cache_pos=None,
            last_only: bool = False, return_hidden: bool = False,
            dtype=torch.bfloat16):
    """Teacher forcing (``cache`` None): ``frames`` (B, enc_len, d) through
    the encoder, ``tokens`` (B, S) through the decoder → (logits, aux), or
    (final hidden states, aux) with ``return_hidden``; ``last_only`` is
    ignored there, as in JAX. Cached: a prefill passes ``frames``, which
    fill the cache's cross K/V in place; a decode step does not → (logits,
    cache, aux). ``aux`` is a zero fp32 scalar (no MoE)."""
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    if cache is None:
        enc_out = encode(cfg, params, frames.to(device=tokens.device, dtype=dtype))
        out, _ = decode_stack(cfg, params, tokens, enc_out=enc_out, dtype=dtype,
                              return_hidden=return_hidden)
        return out, aux
    if cache_pos is None:
        raise ValueError("cache requires cache_pos")
    if frames is not None:
        enc_out = encode(cfg, params, frames.to(device=tokens.device, dtype=dtype))
        xk, xv = precompute_cross_kv(cfg, params, enc_out)
        cache["xk"].copy_(xk)
        cache["xv"].copy_(xv)
    logits, cache = decode_stack(cfg, params, tokens, cache=cache,
                                 cache_pos=cache_pos, last_only=last_only,
                                 dtype=dtype)
    return logits, cache, aux


def make_cache(cfg, batch, max_len, dtype=torch.bfloat16, device=None):
    """Zeroed cache: the self K/V ``k``, ``v`` (L, batch, max_len, K, hd)
    and the cross K/V ``xk``, ``xv`` (L, batch, enc_len, K, hd)."""
    K, hd, n = cfg.n_kv_heads, cfg.head_dim, cfg.n_layers

    def zeros(rows):
        return torch.zeros((n, batch, rows, K, hd), dtype=dtype, device=device)

    return {"k": zeros(max_len), "v": zeros(max_len),
            "xk": zeros(cfg.enc_len), "xv": zeros(cfg.enc_len)}


def cache_specs(cfg, batch, max_len, dtype=torch.bfloat16):
    """The cache's shapes and dtypes as meta-device tensors (no memory)."""
    return make_cache(cfg, batch, max_len, dtype, device="meta")
