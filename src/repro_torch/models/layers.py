"""Model layers of the trained families, from ``repro/models/layers.py``.

Plain functions over nested param dicts, in the JAX module's order: norms
(layernorm, Gemma-style rmsnorm), RoPE, the blockwise mask, attention
(which always runs the flash-attention kernel through ``kernels.ops``), the
gelu2 MLP, embeddings and the cross-entropy.
Params stay fp32 and are cast to the activation dtype at use, as in JAX.
Initialisers take an explicit ``torch.Generator`` and device; they cannot
reproduce ``jax.random`` draws, so tests convert JAX-initialised states
instead (``repro_torch.convert``).

Not ported yet: KV caches, cross-attention and the swiglu/geglu MLPs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NEG_INF = -2.0e38


def _normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Norms.
# ---------------------------------------------------------------------------


def rmsnorm(x, scale, eps=1e-6):
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    # Gemma-style (1 + scale); scale initialized at zero.
    return (x * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))).to(dt)


def layernorm(x, scale, bias, eps=1e-6):
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * (1.0 + scale) + bias).to(dt)


def apply_norm(params, x, kind, eps=1e-6):
    if kind == "rmsnorm":
        return rmsnorm(x, params["scale"], eps)
    return layernorm(x, params["scale"], params["bias"], eps)


def init_norm(d, kind, device):
    p = {"scale": torch.zeros((d,), dtype=torch.float32, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


# ---------------------------------------------------------------------------
# RoPE.
# ---------------------------------------------------------------------------


def rope(x, positions, theta):
    """x: (..., S, H, hd); positions: (..., S) integer. Half-split rotation
    with fp32 angles."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freq  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Mask spec — evaluated blockwise, never materialized at S×S by the kernel.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MaskSpec:
    kind: str = "causal"  # causal | full | prefix
    window: int = 0  # sliding window size (0 = unlimited)
    prefix_len: int = 0  # bidirectional prefix (vlm)


def _mask_block(spec: MaskSpec, q_pos, kv_pos, is_local=None):
    """Boolean mask (Sq, Bk) for given absolute positions. ``is_local`` is
    None (window applies), or a bool / 0-d bool tensor."""
    q = q_pos[:, None]
    k = kv_pos[None, :]
    if spec.kind == "full":
        return torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool,
                          device=q_pos.device)
    m = k <= q
    if spec.kind == "prefix" and spec.prefix_len > 0:
        m = m | ((q < spec.prefix_len) & (k < spec.prefix_len))
    if spec.window > 0:
        w_ok = (q - k) < spec.window
        if spec.kind == "prefix" and spec.prefix_len > 0:
            w_ok = w_ok | (k < spec.prefix_len)
        if is_local is None or bool(is_local):
            m = m & w_ok
    return m


# ---------------------------------------------------------------------------
# Attention.
# ---------------------------------------------------------------------------


def blocked_attention(q, k, v, spec: MaskSpec, *, scale: float,
                      softcap: float = 0.0, q_offset=0, is_local=None):
    """q: (B, Sq, H, hd); k, v: (B, Skv, K, hd) with H % K == 0 (GQA).
    Returns (B, Sq, H, hd) in q.dtype. Always the flash-attention kernel
    (its plain version for CPU tensors); the JAX ``use_pallas`` switch has
    no counterpart."""
    from repro_torch.kernels import ops as kernel_ops

    return kernel_ops.flash_attention(q, k, v, spec, scale=scale,
                                      softcap=softcap, q_offset=q_offset,
                                      is_local=is_local)


def init_attention(gen, cfg, device, d_in=None):
    d = d_in or cfg.d_model
    s = 1.0 / math.sqrt(d)
    return {
        "wq": _normal(gen, (d, cfg.q_dim), device) * s,
        "wk": _normal(gen, (d, cfg.kv_dim), device) * s,
        "wv": _normal(gen, (d, cfg.kv_dim), device) * s,
        "wo": _normal(gen, (cfg.q_dim, d), device) * s / math.sqrt(2 * max(cfg.n_layers, 1)),
    }


def attention_sublayer(params, x, cfg, spec: MaskSpec, *, positions=None,
                       is_local=None):
    """Self-attention sublayer with no cache. x: (B, S, d) normed input;
    ``positions`` (S,) or (B, S) feed RoPE when ``cfg.positions == "rope"``.
    Returns (B, S, d)."""
    B, S, _ = x.shape
    dt = x.dtype
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ params["wq"].to(dt)).reshape(B, S, H, hd)
    k = (x @ params["wk"].to(dt)).reshape(B, S, K, hd)
    v = (x @ params["wv"].to(dt)).reshape(B, S, K, hd)
    if cfg.positions == "rope":
        if positions is None:
            raise ValueError("RoPE attention needs positions")
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    scale = cfg.query_scale if cfg.query_scale else 1.0 / math.sqrt(hd)
    o = blocked_attention(q, k, v, spec, scale=scale, softcap=cfg.attn_softcap,
                          q_offset=0, is_local=is_local)
    return o.reshape(B, S, H * hd) @ params["wo"].to(dt)


# ---------------------------------------------------------------------------
# MLP.
# ---------------------------------------------------------------------------


def init_mlp(gen, d, ff, kind, device):
    if kind != "gelu2":
        raise NotImplementedError(f"mlp {kind!r} is not ported yet")
    s1, s2 = 1.0 / math.sqrt(d), 1.0 / math.sqrt(ff)
    return {"w1": _normal(gen, (d, ff), device) * s1,
            "w2": _normal(gen, (ff, d), device) * s2}


def mlp_sublayer(params, x, kind):
    if kind != "gelu2":
        raise NotImplementedError(f"mlp {kind!r} is not ported yet")
    dt = x.dtype
    h = F.gelu(x @ params["w1"].to(dt), approximate="tanh")
    return h @ params["w2"].to(dt)


# ---------------------------------------------------------------------------
# Embedding / unembedding.
# ---------------------------------------------------------------------------


def init_embed(gen, cfg, device):
    p = {"tok": _normal(gen, (cfg.vocab, cfg.d_model), device) * 0.02}
    if not cfg.tie_embeddings:
        p["unembed"] = _normal(gen, (cfg.d_model, cfg.vocab), device) / math.sqrt(cfg.d_model)
    if cfg.positions == "learned":
        n_pos = 32_768  # the JAX table's size, kept for manifest parity
        p["pos"] = _normal(gen, (n_pos, cfg.d_model), device) * 0.02
    return p


def embed_tokens(params, tokens, cfg, positions=None, dtype=torch.bfloat16):
    # Gather, then cast: the same values as JAX's cast-then-gather.
    x = F.embedding(tokens, params["tok"]).to(dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dtype)
    if cfg.positions == "learned" and positions is not None:
        x = x + F.embedding(positions, params["pos"]).to(dtype)
    return x


def unembed(params, x, cfg):
    dt = x.dtype
    if cfg.tie_embeddings:
        logits = x @ params["tok"].to(dt).T
    else:
        logits = x @ params["unembed"].to(dt)
    if cfg.final_softcap > 0.0:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def _chunk_nll_sum(embed_params, xc, lc, cfg):
    logits = unembed(embed_params, xc, cfg).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, lc[..., None])[..., 0]
    return torch.sum(lse - ll)


def chunked_cross_entropy(embed_params, x, labels, cfg, chunk: int = 1024):
    """Mean next-token CE computed in sequence chunks, each recomputed in
    the backward, so the full (B,S,V) logits never materialize.
    x: final hidden states (B,S,d); labels (B,S) int64."""
    B, S, d = x.shape
    if S % chunk or S <= chunk:
        return cross_entropy(unembed(embed_params, x, cfg), labels)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        total = total + checkpoint(_chunk_nll_sum, embed_params, x[:, sl],
                                   labels[:, sl], cfg, use_reentrant=False)
    return total / (B * S)


def cross_entropy(logits, labels, mask: Optional[torch.Tensor] = None):
    """Mean next-token CE in fp32. logits (B,S,V), labels (B,S) int64."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = lse - ll
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
