"""RWKV-6 "Finch", training path, from ``repro/models/rwkv6.py``
[arXiv:2404.05892].

Attention-free time mixing with data-dependent per-channel decay. The WKV
recurrence always runs the port's WKV6 kernel through ``kernels.ops.wkv6``
(its plain chunked version for CPU tensors); the JAX ``use_pallas`` switch
has no counterpart. Layer params are stacked on a leading axis as in JAX;
``lax.scan`` over the stack becomes a Python loop over its unbound slices
and ``jax.checkpoint`` a non-reentrant ``torch.utils.checkpoint`` per layer
when ``cfg.remat`` is set.

dtypes follow JAX's promotion rules, which PyTorch shares for tensors of
one or more dimensions: the fp32 mixing weights promote the bf16
activations of ``_ddlerp`` to fp32, so r, k, v, g and the decays are fp32
on this path. A matmul of an fp32 activation with a bf16-cast weight
computes in fp32, as ``jnp.matmul`` promotes (``_mm``).

Not ported yet (serving): ``wkv6_decode``, the ``state``/``x_last``
branches of ``time_mix``, ``channel_mix`` and ``forward``, ``make_state``
and ``state_specs``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as T
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import layers as L

LORA_MIX = 32
LORA_DECAY = 64


def _mm(a, w, dt):
    """``a @ w.astype(dt)`` with JAX's promotion: both operands in the wider
    of the two types."""
    w = w.to(dt)
    ct = torch.promote_types(a.dtype, w.dtype)
    return a.to(ct) @ w.to(ct)


# ---------------------------------------------------------------------------
# Layer.
# ---------------------------------------------------------------------------


def init_layer(gen, cfg, device):
    d, ff, H, hd = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.head_dim
    s = 1.0 / math.sqrt(d)
    f32 = torch.float32
    return {
        "ln1": L.init_norm(d, "layernorm", device),
        "ln2": L.init_norm(d, "layernorm", device),
        "tm": {
            "mu_base": torch.zeros((d,), dtype=f32, device=device),
            "mus": torch.zeros((5, d), dtype=f32, device=device),
            "lora_A": L._normal(gen, (d, 5 * LORA_MIX), device) * s,
            "lora_B": L._normal(gen, (5, LORA_MIX, d), device) * 0.01,
            "w0": torch.full((d,), -0.6, dtype=f32, device=device),
            "wA": L._normal(gen, (d, LORA_DECAY), device) * s,
            "wB": L._normal(gen, (LORA_DECAY, d), device) * 0.01,
            "u": L._normal(gen, (H, hd), device) * 0.1,
            "wr": L._normal(gen, (d, d), device) * s,
            "wk": L._normal(gen, (d, d), device) * s,
            "wv": L._normal(gen, (d, d), device) * s,
            "wg": L._normal(gen, (d, d), device) * s,
            "wo": L._normal(gen, (d, d), device) * s / math.sqrt(cfg.n_layers),
            "gn_scale": torch.ones((d,), dtype=f32, device=device),
            "gn_bias": torch.zeros((d,), dtype=f32, device=device),
        },
        "cm": {
            "mu_k": torch.zeros((d,), dtype=f32, device=device),
            "mu_r": torch.zeros((d,), dtype=f32, device=device),
            "wk": L._normal(gen, (d, ff), device) * s,
            "wv": L._normal(gen, (ff, d), device) / math.sqrt(ff),
            "wr": L._normal(gen, (d, d), device) * s,
        },
    }


def init_rwkv6(cfg, gen: torch.Generator, device):
    per_layer = [init_layer(gen, cfg, device) for _ in range(cfg.n_layers)]
    stacked = T.tree_map(lambda *ls: torch.stack(ls), *per_layer)
    return {
        "embed": L.init_embed(gen, cfg, device),
        "layers": stacked,
        "final_norm": L.init_norm(cfg.d_model, "layernorm", device),
    }


def _shift(x):
    """Token shift: x_prev[t] = x[t-1]; the first slot is 0."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _ddlerp(tm, x, prev):
    """Data-dependent interpolation producing the 5 mixed inputs (w,k,v,r,g)."""
    sx = prev - x
    base = x + sx * tm["mu_base"]
    lora = torch.tanh(_mm(base, tm["lora_A"], x.dtype))
    lora = lora.reshape(*x.shape[:-1], 5, LORA_MIX)
    lora_B = tm["lora_B"].to(x.dtype).to(lora.dtype)
    adj = torch.einsum("...fc,fcd->...fd", lora, lora_B)
    mixed = x[..., None, :] + sx[..., None, :] * (tm["mus"].to(x.dtype) + adj)
    return [mixed[..., i, :] for i in range(5)]  # w,k,v,r,g


def _decay(tm, xw):
    dw = torch.tanh(xw.to(torch.float32) @ tm["wA"]) @ tm["wB"]
    lw = -torch.exp(torch.clamp(tm["w0"] + dw, -8.0, 3.0))  # log-decay ≤ 0
    return torch.clamp(lw, -60.0, -1e-6)


def _group_norm(x, scale, bias, H, hd):
    B, S = x.shape[:2]
    xh = x.reshape(B, S, H, hd).to(torch.float32)
    mu = xh.mean(-1, keepdim=True)
    var = xh.var(-1, keepdim=True, correction=0)
    xh = (xh - mu) * torch.rsqrt(var + 1e-5)
    return (xh.reshape(B, S, H * hd) * scale + bias).to(x.dtype)


def time_mix(tm, x, cfg):
    """x: (B, S, d) normed input. Returns (B, S, d) in x's dtype."""
    B, S, d = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    prev = _shift(x)
    xw, xk, xv, xr, xg = _ddlerp(tm, x, prev)
    dt = x.dtype
    r = _mm(xr, tm["wr"], dt).reshape(B, S, H, hd)
    k = _mm(xk, tm["wk"], dt).reshape(B, S, H, hd)
    v = _mm(xv, tm["wv"], dt).reshape(B, S, H, hd)
    g = F.silu(_mm(xg, tm["wg"], dt))
    lw = _decay(tm, xw).reshape(B, S, H, hd)
    o, _ = kernel_ops.wkv6(r, k, v, lw, tm["u"])
    o = _group_norm(o.reshape(B, S, d), tm["gn_scale"], tm["gn_bias"], H, hd)
    return _mm(o.to(dt) * g, tm["wo"], dt).to(dt)


def channel_mix(cm, x):
    prev = _shift(x)
    dt = x.dtype
    xk = x + (prev - x) * cm["mu_k"].to(dt)
    xr = x + (prev - x) * cm["mu_r"].to(dt)
    kk = torch.square(F.relu(xk @ cm["wk"].to(dt)))
    return torch.sigmoid(xr @ cm["wr"].to(dt)) * (kk @ cm["wv"].to(dt))


def _layer_body(cfg, x, lp):
    h = L.apply_norm(lp["ln1"], x, "layernorm")
    x = x + time_mix(lp["tm"], h, cfg)
    h = L.apply_norm(lp["ln2"], x, "layernorm")
    return x + channel_mix(lp["cm"], h)


def forward(cfg, params, tokens, *, return_hidden: bool = False,
            dtype=torch.bfloat16):
    """Train/eval forward with no recurrent state: tokens (B, S) int64 →
    (logits, aux_loss), or (final hidden states, aux_loss) with
    ``return_hidden``."""
    x = L.embed_tokens(params["embed"], tokens, cfg, dtype=dtype)
    for lp in T.unstack(params["layers"], cfg.n_layers):
        if cfg.remat:
            x = checkpoint(_layer_body, cfg, x, lp, use_reentrant=False)
        else:
            x = _layer_body(cfg, x, lp)
    x = L.apply_norm(params["final_norm"], x, "layernorm")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_hidden:
        return x, aux
    return L.unembed(params["embed"], x, cfg), aux
