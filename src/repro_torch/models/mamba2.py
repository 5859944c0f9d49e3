"""Mamba2 (SSD — state-space duality) block, training path, from
``repro/models/mamba2.py``; used by the Zamba2 hybrid.

Recurrence (per head h, head-channel p, state-channel n):
    h_t = exp(A·dt_t) · h_{t-1} + dt_t · B_t[n] · x_t[p]
    y_t[p] = Σ_n C_t[n] · h_t[p,n] + D · x_t[p]
The scan always runs the port's SSD kernel through ``kernels.ops.ssd`` (its
plain chunked version for CPU tensors); the JAX ``use_pallas`` switch has
no counterpart. The softplus of dt runs in fp32 with ``dt_bias``, the ``D``
skip in fp32, and the gate is ``rmsnorm(y · silu(z))``.

Not ported yet (serving): the ``conv_state``/``state`` branches,
``block_state`` and ``block_state_specs``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import layers as L

CONV_K = 4  # causal conv kernel size


def _dims(cfg):
    """(d_in, H, P, N) of a block."""
    d_in = cfg.ssm_expand * cfg.d_model
    H = cfg.ssm_heads or (d_in // 64)
    return d_in, H, d_in // H, cfg.ssm_state


def init_block(gen, cfg, device):
    d = cfg.d_model
    d_in, H, _, N = _dims(cfg)
    conv_dim = d_in + 2 * N
    s = 1.0 / math.sqrt(d)
    f32 = torch.float32
    return {
        "norm": L.init_norm(d, "rmsnorm", device),
        "in_proj": L._normal(gen, (d, 2 * d_in + 2 * N + H), device) * s,
        "conv_w": L._normal(gen, (CONV_K, conv_dim), device) * 0.1,
        "conv_b": torch.zeros((conv_dim,), dtype=f32, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=f32,
                                          device=device)),
        "D": torch.ones((H,), dtype=f32, device=device),
        "dt_bias": torch.full((H,), -2.0, dtype=f32, device=device),
        "gate_norm": L.init_norm(d_in, "rmsnorm", device),
        "out_proj": L._normal(gen, (d_in, d), device) / math.sqrt(d_in),
    }


def causal_conv(x, w, b):
    """x: (B,S,D); w: (K,D) depthwise, zero left context. Returns (B,S,D)."""
    K = w.shape[0]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = sum(xp[:, i: i + S] * w[i].to(x.dtype) for i in range(K))
    return out + b.to(x.dtype)


def block_apply(p, x, cfg):
    """One Mamba2 block with no recurrent state. Returns (B,S,d)."""
    B, S, d = x.shape
    d_in, H, P, N = _dims(cfg)
    dt_ = x.dtype

    h = L.apply_norm(p["norm"], x, "rmsnorm")
    zxbcdt = h @ p["in_proj"].to(dt_)
    z, xbc, dt_raw = torch.split(zxbcdt, [d_in, d_in + 2 * N, H], dim=-1)
    xbc = F.silu(causal_conv(xbc, p["conv_w"], p["conv_b"]))
    xs, Bm, Cm = torch.split(xbc, [d_in, N, N], dim=-1)
    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])  # (B,S,H)
    xh = xs.reshape(B, S, H, P)
    y, _ = kernel_ops.ssd(xh, dt, p["A_log"], Bm, Cm)
    y = y + p["D"][None, None, :, None] * xh.to(torch.float32)
    y = y.reshape(B, S, d_in).to(dt_)
    y = L.apply_norm(p["gate_norm"], y * F.silu(z), "rmsnorm")
    return y @ p["out_proj"].to(dt_)
