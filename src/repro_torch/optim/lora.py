"""LoRA adapters, from ``repro/optim/lora.py``: the paper fine-tunes GPT-2
with LoRA (1.7 MiB state, §VI-A/E). Adapters target the 2-D projection
matrices of a model param tree; base weights stay frozen.

``lora_init`` draws from an explicit ``torch.Generator``; ``jax.random``
draws cannot be replayed, so parity tests carry the JAX adapters across
through ``repro_torch.convert``.
"""
from __future__ import annotations

import math
import re
from typing import Optional

import torch

TARGET_RE = re.compile(r"(wq|wk|wv|wo|w1|w2|w3|wr|wg)$")


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix, tree


def lora_targets(params):
    """Leaf paths eligible for LoRA (2-D mats whose name matches TARGET_RE),
    in the tree's own key order, as in JAX."""
    return [path for path, leaf in _paths(params)
            if leaf.ndim >= 2 and TARGET_RE.search(path[-1])]


def lora_init(params, rank: int = 8, generator: Optional[torch.Generator] = None,
              alpha: float = 16.0):
    """Returns (adapters, scaling): adapters ``{path_str: {"a": (*lead, in,
    r), "b": (*lead, r, out)}}`` with ``a`` normal / sqrt(in) and ``b``
    zero, on each leaf's device; scaling ``alpha / rank``."""
    adapters = {}
    for path in lora_targets(params):
        leaf = _get(params, path)
        *lead, d_in, d_out = leaf.shape
        gen = generator
        if gen is None:
            gen = torch.Generator(device=leaf.device).manual_seed(0)
        a = torch.randn((*lead, d_in, rank), generator=gen, dtype=torch.float32,
                        device=leaf.device) / math.sqrt(d_in)
        b = torch.zeros((*lead, rank, d_out), dtype=torch.float32, device=leaf.device)
        adapters["/".join(path)] = {"a": a, "b": b}
    return adapters, alpha / rank


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _set(tree, path, val):
    if len(path) == 1:
        return {**tree, path[0]: val}
    return {**tree, path[0]: _set(tree[path[0]], path[1:], val)}


def lora_apply_delta(params, adapters, scaling: float):
    """params + scaling * A@B for every adapted leaf (returns a new tree;
    ``params`` is not changed)."""
    out = params
    for path_str, ab in adapters.items():
        path = tuple(path_str.split("/"))
        base = _get(out, path)
        delta = torch.einsum("...ir,...ro->...io", ab["a"], ab["b"]) * scaling
        out = _set(out, path, base + delta.to(base.dtype))
    return out


def lora_merge(params, adapters, scaling: float):
    return lora_apply_delta(params, adapters, scaling)


def lora_param_bytes(adapters) -> int:
    return sum(leaf.numel() * leaf.element_size() for _, leaf in _paths(adapters))
