"""Mamba2 (SSD — state-space duality) block, from
``repro/models/mamba2.py``; used by the Zamba2 hybrid.

Recurrence (per head h, head-channel p, state-channel n):
    h_t = exp(A·dt_t) · h_{t-1} + dt_t · B_t[n] · x_t[p]
    y_t[p] = Σ_n C_t[n] · h_t[p,n] + D · x_t[p]
The scan always runs the port's SSD kernel through ``kernels.ops.ssd`` (its
plain chunked version for CPU tensors); the JAX ``use_pallas`` switch has
no counterpart. The softplus of dt runs in fp32 with ``dt_bias``, the ``D``
skip in fp32, and the gate is ``rmsnorm(y · silu(z))``.

Serving: ``block_apply`` with ``state`` carries the SSM state ``h`` (fp32,
through the kernel's initial and final state; a decode step runs it at
S = 1) and the causal conv's left context ``conv``: the last ``CONV_K - 1``
rows of the conv's input (``in_proj``'s ``xbc`` slice, before the conv and
the silu). The JAX block casts the new context to bf16 whatever the
forward's dtype; the port keeps it in the activations' dtype, as it keeps
RWKV-6's ``tm_x``/``cm_x`` (a no-op at bf16; in an fp32 forward the cast
would round every decode step's context). ``block_state`` starts it in
bf16, as in JAX.
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


def causal_conv(x, w, b, conv_state=None):
    """x: (B,S,D); w: (K,D) depthwise; conv_state: (B,K-1,D) left context.
    Returns ((B,S,D), the new context: the last K-1 rows of the context
    followed by x, in x's dtype). Without a context the left context is
    zeros and none is returned (the training path)."""
    K = w.shape[0]
    S = x.shape[1]
    if conv_state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    out = sum(xp[:, i: i + S] * w[i].to(x.dtype) for i in range(K))
    new_state = None if conv_state is None else xp[:, S:].contiguous()
    return out + b.to(x.dtype), new_state


def block_apply(p, x, cfg, state=None):
    """One Mamba2 block. ``state``: {"h": (B,H,P,N) fp32, "conv":
    (B,K-1,conv_dim)} or None. Returns ((B,S,d), the new state or None)."""
    B, S, d = x.shape
    d_in, H, P, N = _dims(cfg)
    dt_ = x.dtype

    h = L.apply_norm(p["norm"], x, "rmsnorm")
    zxbcdt = h @ p["in_proj"].to(dt_)
    z, xbc, dt_raw = torch.split(zxbcdt, [d_in, d_in + 2 * N, H], dim=-1)
    xbc, new_conv = causal_conv(xbc, p["conv_w"], p["conv_b"],
                                None if state is None else state["conv"])
    xbc = F.silu(xbc)
    xs, Bm, Cm = torch.split(xbc, [d_in, N, N], dim=-1)
    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])  # (B,S,H)
    xh = xs.reshape(B, S, H, P)
    y, new_h = kernel_ops.ssd(xh, dt, p["A_log"], Bm, Cm,
                              state=None if state is None else state["h"])
    y = y + p["D"][None, None, :, None] * xh.to(torch.float32)
    y = y.reshape(B, S, d_in).to(dt_)
    y = L.apply_norm(p["gate_norm"], y * F.silu(z), "rmsnorm")
    out = y @ p["out_proj"].to(dt_)
    return out, None if state is None else {"h": new_h, "conv": new_conv}


def block_state(cfg, batch, device=None, dtype=torch.bfloat16):
    """Zeroed state of one block: ``h`` fp32, ``conv`` in ``dtype``."""
    d_in, H, P, N = _dims(cfg)
    return {
        "h": torch.zeros((batch, H, P, N), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, CONV_K - 1, d_in + 2 * N), dtype=dtype,
                            device=device),
    }


def block_state_specs(cfg, batch):
    """The block state's shapes and dtypes as meta-device tensors."""
    return block_state(cfg, batch, device="meta")
