"""AdamW with fp32 moments, global-norm clipping and ``make_optimizer``,
from ``repro/optim/adamw.py``.

The API mirrors the JAX package's (and optax's): ``init(params) -> state``,
``update(grads, state, params) -> (updates, state)``; updates are
*subtracted* from params by the caller. One departure: ``update`` advances
the moments ``m`` and ``v`` and the ``step`` counter **in place** and
returns the same state dict, where JAX builds new arrays. That saves two
copies of the fp32 moments per step; callers that need the old moments
clone them first.

``adamw8bit`` and ``sgdm`` are not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import tree as T


class Optimizer(NamedTuple):
    init: callable
    update: callable


def adamw(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1):
    def init(params):
        zeros = T.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device), params)
        step = torch.zeros((), dtype=torch.int32,
                           device=T.leaves(params)[0].device)
        return {"m": zeros, "v": T.tree_map(torch.clone, zeros), "step": step}

    @torch.no_grad()
    def update(grads, state, params, lr_scale=1.0):
        state["step"].add_(1)
        stepf = state["step"].to(torch.float32)
        sf = torch.tensor(lr_scale, dtype=torch.float32, device=stepf.device)
        bc1 = 1.0 - torch.pow(b1, stepf)
        bc2 = 1.0 - torch.pow(b2, stepf)
        lr_t = lr * sf

        def upd(g, m, v, p):
            g = g.to(torch.float32)
            # m <- b1*m + (1-b1)*g and v <- b2*v + (1-b2)*g², in place.
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            mh = m / bc1
            vh = v / bc2
            u = mh / (torch.sqrt(vh) + eps) + weight_decay * p.to(torch.float32)
            return (lr_t * u).to(p.dtype)

        updates = T.tree_map(upd, grads, state["m"], state["v"], params)
        return updates, state

    return Optimizer(init, update)


def make_optimizer(cfg):
    if cfg.optimizer in ("adamw8bit", "sgdm"):
        raise NotImplementedError(
            f"optimizer {cfg.optimizer!r} is not ported yet; only adamw is")
    return adamw(lr=cfg.learning_rate, weight_decay=cfg.weight_decay)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(l.to(torch.float32)))
                          for l in T.leaves(tree)))


def clip_by_global_norm(tree, max_norm):
    n = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)
    return T.tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype), tree), n
