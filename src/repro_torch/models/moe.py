"""Mixture-of-Experts layer with capacity dispatch, from
``repro/models/moe.py`` (``init_moe``, ``_capacity``,
``_dispatch_indices``, ``moe_sublayer``; ``_swiglu`` is the swiglu
``layers.mlp_sublayer``).

Tokens are grouped as (G, T, d); each group routes its tokens to the top-k
of E experts, and each expert takes at most C = ceil(T·k/E · capacity
factor) of them (rounded up to a multiple of 8), in token order; the
(token, choice) pairs past C are dropped. The dispatch ranks tokens with a
stable sort, scatters them into a (G, E, C, d) buffer, runs the experts as
three batched products and gathers the outputs back, weighted by the
renormalised gates. A Switch load-balance aux loss goes to the trainer.

Only the single-device path is ported (``moe_sublayer``'s fallback in
JAX); the expert-parallel ``shard_map`` path and ``constrain``, which does
nothing on one device, come with sharding. There is no kernel: the einsums,
scatter and gather are plain PyTorch, as they are plain XLA in JAX.

Two places need care to give JAX's function:

* **top-k.** The router logits are rounded to the activation dtype before
  the softmax, so in bf16 experts tie exactly. ``lax.top_k`` puts the
  lower index first among equal values; ``torch.topk`` promises no order
  and picks other experts on such rows. A stable descending sort, cut at
  k, gives ``lax.top_k``'s choice and order (``_top_k``).
* **the scatter.** Every kept (expert, slot) pair of a group receives
  exactly one token over all k choices, and a dropped pair adds ``0·x``
  into slot C-1, so an accumulating ``index_put_`` sums at most one
  nonzero value into a slot: no order of additions is involved, and the
  buffer equals JAX's bit for bit on any device (``_scatter``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L


def init_moe(gen, cfg, device):
    """``router`` (d, E); ``w1``, ``w3`` (E, d, ff); ``w2`` (E, ff, d);
    ``shared`` (n_shared_experts · ff wide) and ``dense`` (d_ff wide)
    swiglu sub-dicts where the config has them. Scales as in JAX."""
    d, ffe = cfg.d_model, cfg.moe_d_ff
    E = cfg.n_experts
    s1 = 1.0 / math.sqrt(d)
    s2 = 1.0 / math.sqrt(ffe)
    p = {
        "router": L._normal(gen, (d, E), device) * s1,
        "w1": L._normal(gen, (E, d, ffe), device) * s1,
        "w3": L._normal(gen, (E, d, ffe), device) * s1,
        "w2": L._normal(gen, (E, ffe, d), device) * s2,
    }

    def ffn(ff):
        return {"w1": L._normal(gen, (d, ff), device) * s1,
                "w3": L._normal(gen, (d, ff), device) * s1,
                "w2": L._normal(gen, (ff, d), device) / math.sqrt(ff)}

    if cfg.n_shared_experts > 0:
        p["shared"] = ffn(cfg.n_shared_experts * ffe)
    if cfg.dense_residual:
        p["dense"] = ffn(cfg.d_ff)
    return p


def _capacity(tokens_per_group: int, cfg) -> int:
    c = math.ceil(tokens_per_group * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def _top_k(probs, k):
    """``lax.top_k`` over the last dim: the k largest values, largest
    first, the lower index first among equal values; indices int32."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def _dispatch_indices(idx, E, C):
    """idx: (T, k) expert choices. Returns (e, p, keep) flattened (T*k,):
    each pair's expert, its slot (clipped to C-1) and whether it fits.

    A pair's slot is its rank among the pairs of its expert in token
    order, from a stable sort (vectors only, never T×E)."""
    T, k = idx.shape
    e = idx.reshape(-1).to(torch.int32)
    order = torch.argsort(e, stable=True)
    e_sorted = e[order]
    # Rank within equal-expert runs.
    start = torch.searchsorted(e_sorted, e_sorted, side="left")
    rank_sorted = (torch.arange(T * k, dtype=torch.int32, device=idx.device)
                   - start.to(torch.int32))
    p = torch.zeros((T * k,), dtype=torch.int32, device=idx.device)
    p[order] = rank_sorted
    keep = p < C
    return e, torch.clamp(p, 0, C - 1), keep


def _scatter(xg, ef, pf, kf, E, C):
    """The (G, E, C, d) dispatch buffer of tokens ``xg`` (G, T, d): each
    (token, choice) added at its expert ``ef`` and slot ``pf`` (G, T, k),
    times its keep ``kf``. Exact in any order: see the module's
    docstring."""
    G, Tg, d = xg.shape
    g_idx = torch.arange(G, device=xg.device)[:, None].expand(G, Tg)
    buf = torch.zeros((G, E, C, d), dtype=xg.dtype, device=xg.device)
    for j in range(ef.shape[-1]):
        buf.index_put_((g_idx, ef[:, :, j], pf[:, :, j]),
                       xg * kf[:, :, j, None].to(xg.dtype), accumulate=True)
    return buf


def moe_sublayer(params, x, cfg, n_groups: int = 1):
    """x: (B, S, d) → (B, S, d), aux load-balance loss (fp32 scalar). The
    B·S tokens form ``n_groups`` groups of consecutive tokens."""
    B, S, d = x.shape
    dt = x.dtype
    E, k = cfg.n_experts, cfg.top_k
    G = n_groups
    Tg = (B * S) // G
    C = _capacity(Tg, cfg)

    xg = x.reshape(G, Tg, d)
    logits = (xg @ params["router"].to(dt)).to(torch.float32)  # (G,T,E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = _top_k(probs, k)  # (G,T,k)
    gates = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    # Load-balance aux (Switch): E * sum_e f_e * P_e, averaged over groups;
    # f_e is the fraction of tokens whose top-1 is e.
    me = torch.mean(probs, dim=1)  # (G,E)
    top1 = idx[..., 0].long()
    f = torch.zeros((G, E), dtype=torch.float32, device=x.device).scatter_add_(
        1, top1, torch.ones(top1.shape, dtype=torch.float32, device=x.device)) / Tg
    aux = E * torch.mean(torch.sum(f * me, dim=-1))

    ep = [_dispatch_indices(idx[g], E, C) for g in range(G)]
    ef, pf, kf = (torch.stack([t[i] for t in ep]).reshape(G, Tg, k) for i in range(3))
    ef, pf = ef.long(), pf.long()

    buf = _scatter(xg, ef, pf, kf, E, C)
    h = torch.einsum("gecd,edf->gecf", buf, params["w1"].to(dt))
    h = F.silu(h) * torch.einsum("gecd,edf->gecf", buf, params["w3"].to(dt))
    out = torch.einsum("gecf,efd->gecd", h, params["w2"].to(dt))
    g_idx = torch.arange(G, device=x.device)[:, None].expand(G, Tg)
    y = torch.zeros((G, Tg, d), dtype=dt, device=x.device)
    for j in range(k):
        yj = out[g_idx, ef[:, :, j], pf[:, :, j]]  # (G,T,d) gather
        y = y + yj * (gates[:, :, j] * kf[:, :, j]).to(dt)[:, :, None]
    y = y.reshape(B, S, d)

    for name in ("shared", "dense"):
        if name in params:
            y = y + L.mlp_sublayer(params[name], x, "swiglu")
    return y, aux
