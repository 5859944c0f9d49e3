"""Zamba2 hybrid, from ``repro/models/zamba2.py`` [arXiv:2411.15242].

A stack of Mamba2 blocks with a single weight-shared attention+MLP block
applied every ``shared_attn_every`` layers on concat([h, h₀]) (h₀ = the
embedding output). The 38 Mamba2 blocks are grouped into segments of
``shared_attn_every``; each segment starts with one application of the
shared block (RoPE causal attention through the flash-attention kernel),
then runs its Mamba2 blocks. With ``cfg.remat`` each Mamba2 block is
checkpointed (non-reentrant); the shared block is applied outside the
checkpoint, as in JAX.

Serving: ``forward`` with ``state`` (``make_state``) carries one KV cache
per application of the shared block, slices ``attn_k[i]``/``attn_v[i]`` of
one (apps, B, Smax, K, hd) tensor each written in place at the state's
position, and every Mamba2 block's state (``mamba2.block_apply``), returned
as new tensors. RoPE reads the absolute positions ``pos + arange(S)``.
``Model.prefill`` and ``decode_step`` pass ``pos`` as a host integer, so a
decode step never waits on the device for it.
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


def _shared_apply(sp, x, x0, cfg, positions, cache_kv=None, cache_pos=None):
    dt = x.dtype
    z = torch.cat([x, x0], dim=-1) @ sp["in_proj"].to(dt)
    h = L.apply_norm(sp["ln1"], z, cfg.norm)
    z = z + L.attention_sublayer(sp["attn"], h, cfg, MaskSpec("causal"),
                                 positions=positions, cache_kv=cache_kv,
                                 cache_pos=cache_pos)[0]
    h = L.apply_norm(sp["ln2"], z, cfg.norm)
    z = z + L.mlp_sublayer(sp["mlp"], h, cfg.mlp)
    return x + z


def _mamba_body(cfg, x, lp):
    return x + M2.block_apply(lp, x, cfg)[0]


def forward(cfg, params, tokens, *, state=None, last_only: bool = False,
            return_hidden: bool = False, dtype=torch.bfloat16):
    """tokens (B, S) int64. ``state``: {"mamba": {"h": (L,B,H,P,N) fp32,
    "conv": (L,B,K-1,conv_dim)}, "attn_k"/"attn_v": (apps,B,Smax,K,hd),
    "pos": the write position, an int or 0-d tensor} or None.

    Without a state → (logits, aux_loss), or (final hidden states,
    aux_loss) with ``return_hidden``. With one → (logits, new_state, aux):
    the KV caches are written in place at ``pos`` and returned as the same
    tensors, the Mamba2 states as new ones (the given ones are left as they
    were), and the new ``pos`` is ``pos + S``. ``last_only`` keeps the last
    position's logits only."""
    B, S = tokens.shape
    x = L.embed_tokens(params["embed"], tokens, cfg, dtype=dtype)
    x0 = x
    pos = 0 if state is None else int(state["pos"])
    positions = pos + torch.arange(S, dtype=torch.int32, device=tokens.device)
    blocks = T.unstack(params["mamba"], cfg.n_layers)
    carried = []
    for i, (lo, hi) in enumerate(_segments(cfg)):
        # Shared attention block (weight-tied across applications), each
        # application with its own KV cache.
        if state is None:
            x = _shared_apply(params["shared"], x, x0, cfg, positions)
        else:
            x = _shared_apply(params["shared"], x, x0, cfg, positions,
                              (state["attn_k"][i], state["attn_v"][i]), pos)
        for j in range(lo, hi):
            if state is not None:
                st = {k: v[j] for k, v in state["mamba"].items()}
                out, new_st = M2.block_apply(blocks[j], x, cfg, state=st)
                x = x + out
                carried.append(new_st)
            elif cfg.remat:
                x = checkpoint(_mamba_body, cfg, x, blocks[j], use_reentrant=False)
            else:
                x = _mamba_body(cfg, x, blocks[j])
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    if last_only:
        x = x[:, -1:]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_hidden and state is None:
        return x, aux
    logits = L.unembed(params["embed"], x, cfg)
    if state is not None:
        new_state = {
            "mamba": {k: torch.stack([st[k] for st in carried])
                      for k in ("h", "conv")},
            "attn_k": state["attn_k"], "attn_v": state["attn_v"],
            "pos": torch.full((), pos + S, dtype=torch.int32, device=x.device),
        }
        return logits, new_state, aux
    return logits, aux


def make_state(cfg, batch, max_len, dtype=torch.bfloat16, device=None):
    """Zeroed serving state: every Mamba2 block's (``mamba2.block_state``,
    stacked), one KV cache of ``max_len`` positions per application of the
    shared block, and ``pos`` 0. The KV caches and the conv contexts are in
    ``dtype`` (bf16 by default, as in JAX), the SSM states fp32."""
    m = M2.block_state(cfg, batch, "meta", dtype)
    kv_shape = (n_shared_apps(cfg), batch, max_len, cfg.n_kv_heads,
                cfg.head_dim)
    return {
        "mamba": {k: torch.zeros((cfg.n_layers,) + v.shape, dtype=v.dtype,
                                 device=device) for k, v in m.items()},
        "attn_k": torch.zeros(kv_shape, dtype=dtype, device=device),
        "attn_v": torch.zeros(kv_shape, dtype=dtype, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


def state_specs(cfg, batch, max_len, dtype=torch.bfloat16):
    """The state's shapes and dtypes as meta-device tensors (no memory)."""
    return make_state(cfg, batch, max_len, dtype, device="meta")
