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

Two paths, chosen as in JAX. The single-device path runs whenever this
process is not one rank of a multi-rank mesh. The expert-parallel path
(``_moe_expert_parallel``, JAX's ``_moe_expert_parallel_shardmap``) runs
under an ``activation_sharding`` context with ``tp`` whose mesh the expert
count and d divide, with one token group per (pod, data) position, when the
process group is that mesh's: each rank scatters its group's tokens, on its
d/M columns, into an (E, C, d/M) buffer, an all-to-all over ``model`` turns
that into (E/M, C, d) for its own experts, the three expert products run,
and a second all-to-all brings the outputs back for the gated gather. Above
``sharding.FSDP_MIN_PARAMS`` the expert weights arrive d-sharded over
``data`` and are all-gathered there first. The weights are cast to the
activation dtype at that boundary, as in JAX. The collectives are the
autograd-aware functional ones, so gradients flow through them. There is
no kernel: the einsums, scatter and gather are plain PyTorch, as they are
plain XLA in JAX.

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
from repro_torch.models import sharding as SH
from repro_torch.models.shardctx import constrain, get_ctx, live_device_mesh


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


def _local_block(t, spec, dm):
    """The block of ``t`` this rank holds under ``spec`` over the
    ``DeviceMesh`` ``dm``, as a plain tensor. ``t`` is a ``DTensor``, or a
    plain tensor equal on every rank (replicated). The block's gradient is
    this rank's share: summed over the mesh dims that ``spec`` does not
    split, as JAX's ``shard_map`` transposes a replicated input."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, dm, [Replicate()] * dm.ndim, run_check=False)
    want = SH.placements(spec, dm.mesh_dim_names)
    grads = [p if isinstance(p, Shard) else Partial() for p in want]
    return t.redistribute(dm, want).to_local(grad_placements=grads)


def _moe_expert_parallel(params, xg, ef, pf, kf, gates, cfg, C, mesh, ba, dm):
    """Expert-parallel dispatch over the ``DeviceMesh`` ``dm`` of ``mesh``
    (the module's docstring): scatter (d/M local) → all-to-all (E ↔ d over
    "model") → expert FFN, its weights all-gathered over "data" above
    ``FSDP_MIN_PARAMS`` → all-to-all back → gather. Returns (G, T, d),
    plain when ``xg`` is plain, else a ``DTensor`` over (ba, None,
    "model")."""
    import torch.distributed._functional_collectives as fc
    from torch.distributed.tensor import DTensor

    dt = xg.dtype
    G, Tg, d = xg.shape
    E, k = cfg.n_experts, cfg.top_k
    M = mesh.shape["model"]
    D = mesh.shape.get("data", 1)
    fsdp_w = cfg.fsdp and d % D == 0 and cfg.param_count() >= SH.FSDP_MIN_PARAMS
    g = 0  # this rank's token group: its (pod, data) position, row-major
    for a in ba:
        g = g * mesh.shape[a] + dm.get_local_rank(a)
    model_group = dm.get_group("model")

    x_spec = SH.P(ba, None, "model")
    x_l = _local_block(xg, x_spec, dm)[0]  # (T, d/M)
    g_l = _local_block(gates.to(dt), SH.P(ba, None, None), dm)[0]  # (T, k)
    e1, p1, k1 = ef[g], pf[g], kf[g]
    w_spec = SH.P("model", "data" if fsdp_w else None, None)
    w1, w3, w2 = (_local_block(params[n].to(dt), w_spec, dm) for n in ("w1", "w3", "w2"))
    if fsdp_w:
        w1, w3, w2 = (fc.wait_tensor(fc.all_gather_single_autograd(
            w, 1, dm.get_group("data"))) for w in (w1, w3, w2))

    buf = _scatter(x_l[None], e1[None], p1[None], k1[None], E, C)[0]  # (E, C, d/M)
    # dispatch all-to-all: (E, C, d/M) -> (E/M, C, d)
    buf = fc.wait_tensor(fc.all_to_all_single_autograd(buf, None, None, model_group))
    buf = buf.reshape(M, E // M, C, d // M).permute(1, 2, 0, 3).reshape(E // M, C, d)
    h = torch.einsum("ecd,edf->ecf", buf, w1)
    h = F.silu(h) * torch.einsum("ecd,edf->ecf", buf, w3)
    out = torch.einsum("ecf,efd->ecd", h, w2)
    # combine all-to-all: (E/M, C, d) -> (E, C, d/M)
    out = out.reshape(E // M, C, M, d // M).permute(2, 0, 1, 3).contiguous()
    out = fc.wait_tensor(fc.all_to_all_single_autograd(out, None, None, model_group))
    out = out.reshape(E, C, d // M)
    y = torch.zeros_like(x_l)
    for j in range(k):
        y = y + out[e1[:, j], p1[:, j]] * (g_l[:, j] * k1[:, j]).to(dt)[:, None]
    y = DTensor.from_local(y[None], dm, SH.placements(x_spec, dm.mesh_dim_names),
                           run_check=False)
    return y if isinstance(xg, DTensor) else y.full_tensor()


def _expert_parallel_mesh(cfg, d, n_groups):
    """The ``DeviceMesh`` the expert-parallel path runs on, or None: JAX's
    condition on the installed context, and a process group of more than
    one rank that is the context's mesh."""
    ctx = get_ctx()
    if ctx is None or not ctx[2]:
        return None
    shape = ctx[0].shape
    if (cfg.n_experts % shape["model"] or d % shape["model"]
            or n_groups != math.prod(s for a, s in shape.items()
                                     if a in ("pod", "data"))):
        return None
    dm = live_device_mesh(ctx[0])
    return dm if dm is not None and dm.size() > 1 else None


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
    ef, pf, kf = (constrain(torch.stack([t[i] for t in ep]).reshape(G, Tg, k),
                            "batch", None, None) for i in range(3))
    ef, pf = ef.long(), pf.long()
    gates = constrain(gates, "batch", None, None)

    dm = _expert_parallel_mesh(cfg, d, G)
    if dm is not None:
        y = _moe_expert_parallel(params, xg, ef, pf, kf, gates, cfg, C,
                                 get_ctx()[0], get_ctx()[1], dm)
    else:
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
