"""The optimisers of ``repro/optim/adamw.py``: AdamW with fp32 moments,
AdamW with int8 block-quantized moments (``adamw8bit``), SGD with momentum
(``sgdm``), global-norm clipping and ``make_optimizer``.

The API mirrors the JAX package's (and optax's): ``init(params) -> state``,
``update(grads, state, params) -> (updates, state)``; updates are
*subtracted* from params by the caller. One departure: ``update`` advances
the optimizer state (the moments ``m`` and ``v``, adamw8bit's codes and
scales, sgdm's ``mu``) and the ``step`` counter **in place** and returns
the same state dict, where JAX builds new arrays. That saves copies of the
moments per step; callers that need the old state clone it first.

``start(state, lr_scale)`` is ``update`` one leaf at a time: it advances
the step counter and returns ``update_leaf(path, p, g)``, the update of
the param ``p`` at ``path`` from its gradient ``g``, advancing that leaf's
moments in place. ``update`` is ``start`` applied to every leaf, so the
two give the same bits.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import tree as T


class Optimizer(NamedTuple):
    init: callable
    update: callable
    start: callable


def at(tree, path):
    """The node of ``tree`` at ``path`` (a tuple of keys)."""
    for key in path:
        tree = tree[key]
    return tree


def _optimizer(init, start):
    """The optimizer whose whole-tree ``update`` runs ``start``'s
    per-leaf update on every leaf."""

    @torch.no_grad()
    def update(grads, state, params, lr_scale=1.0):
        update_leaf = start(state, lr_scale)
        paths, leaves = zip(*T.flatten_with_paths(params))
        return T.unflatten(paths, [update_leaf(path, p, at(grads, path))
                                   for path, p in zip(paths, leaves)]), state

    return Optimizer(init, update, start)


def adamw(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1):
    def init(params):
        zeros = T.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device), params)
        step = torch.zeros((), dtype=torch.int32,
                           device=T.leaves(params)[0].device)
        return {"m": zeros, "v": T.tree_map(torch.clone, zeros), "step": step}

    @torch.no_grad()
    def start(state, lr_scale=1.0):
        state["step"].add_(1)
        stepf = state["step"].to(torch.float32)
        sf = torch.tensor(lr_scale, dtype=torch.float32, device=stepf.device)
        bc1 = 1.0 - torch.pow(b1, stepf)
        bc2 = 1.0 - torch.pow(b2, stepf)
        lr_t = lr * sf

        @torch.no_grad()
        def update_leaf(path, p, g):
            m, v = at(state["m"], path), at(state["v"], path)
            g = g.to(torch.float32)
            # m <- b1*m + (1-b1)*g and v <- b2*v + (1-b2)*g², in place.
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            mh = m / bc1
            vh = v / bc2
            u = mh / (torch.sqrt(vh) + eps) + weight_decay * p.to(torch.float32)
            return (lr_t * u).to(p.dtype)

        return update_leaf

    return _optimizer(init, start)


# ---------------------------------------------------------------------------
# AdamW with int8 block-quantized moments.
# ---------------------------------------------------------------------------

Q_BLOCK = 256  # elements per quantization block


def _block_of(last_dim: int) -> int:
    """Largest power-of-two divisor of last_dim, capped at Q_BLOCK."""
    b = 1
    while b < Q_BLOCK and last_dim % (b * 2) == 0:
        b *= 2
    return b


def _q8(x):
    """Block-quantize along the LAST dim: codes (*lead, last // b, b) int8
    keep the leading dims of the parameter, scales (*lead, last // b) fp32.
    ``scale = max(max|x| / 127, 1e-12)`` (a true division, where the
    replication codec multiplies by the fp32 constant 1/127) and ``codes =
    clip(round_half_even(x / scale), ±127)``, as in JAX."""
    shape = tuple(x.shape)
    last = shape[-1] if shape else 1
    b = _block_of(max(last, 1))
    xf = x.reshape(*shape[:-1], max(last, 1) // b, b) if shape else x.reshape(1, 1)
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    # A tensor divisor: PyTorch's CUDA kernels turn a division by a Python
    # scalar into a multiply by its reciprocal, an ulp off on some scales.
    scale = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-12)
    codes = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return codes, scale[..., 0]


def _dq8_static(codes, scale, shape):
    xf = codes.to(torch.float32) * scale[..., None]
    return xf.reshape(shape) if shape else xf.reshape(())


def adamw8bit(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1):
    """AdamW whose m/v live as int8 codes + per-block fp32 scales (≈ 2.03
    bytes/param of optimizer state vs 8 for fp32 AdamW). ``update``
    dequantizes each moment, advances it in fp32 and writes the new codes
    and scales into the state's tensors."""

    def init(params):
        def mk(p):
            codes, scale = _q8(torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device))
            return {"codes": codes, "scale": scale}

        step = torch.zeros((), dtype=torch.int32,
                           device=T.leaves(params)[0].device)
        return {"m": T.tree_map(mk, params), "v": T.tree_map(mk, params),
                "step": step}

    @torch.no_grad()
    def start(state, lr_scale=1.0):
        state["step"].add_(1)
        stepf = state["step"].to(torch.float32)
        sf = torch.tensor(lr_scale, dtype=torch.float32, device=stepf.device)
        bc1 = 1.0 - torch.pow(b1, stepf)
        bc2 = 1.0 - torch.pow(b2, stepf)
        lr_t = lr * sf

        # Each leaf meets its gradient and its two {"codes", "scale"} dicts.
        @torch.no_grad()
        def update_leaf(path, p, g):
            mq, vq = at(state["m"], path), at(state["v"], path)
            g = g.to(torch.float32)
            m = _dq8_static(mq["codes"], mq["scale"], p.shape)
            v = _dq8_static(vq["codes"], vq["scale"], p.shape)
            m2 = b1 * m + (1 - b1) * g
            v2 = b2 * v + (1 - b2) * torch.square(g)
            del m, v
            u = (m2 / bc1) / (torch.sqrt(torch.clamp(v2 / bc2, min=0.0)) + eps)
            u = u + weight_decay * p.to(torch.float32)
            for q, x in ((mq, m2), (vq, v2)):
                codes, scale = _q8(x)
                q["codes"].copy_(codes)
                q["scale"].copy_(scale)
            return (lr_t * u).to(p.dtype)

        return update_leaf

    return _optimizer(init, start)


# ---------------------------------------------------------------------------
# SGD + momentum.
# ---------------------------------------------------------------------------


def sgdm(lr=0.1, momentum=0.9, weight_decay=0.0):
    def init(params):
        mu = T.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)
        step = torch.zeros((), dtype=torch.int32,
                           device=T.leaves(params)[0].device)
        return {"mu": mu, "step": step}

    @torch.no_grad()
    def start(state, lr_scale=1.0):
        sf = torch.tensor(lr_scale, dtype=torch.float32,
                          device=state["step"].device)
        lr_t = lr * sf
        state["step"].add_(1)  # the step counter enters no update

        @torch.no_grad()
        def update_leaf(path, p, g):
            mu = at(state["mu"], path)
            g = g.to(torch.float32) + weight_decay * p.to(torch.float32)
            mu.mul_(momentum).add_(g)  # mu <- momentum*mu + g, in place
            return (lr_t * mu).to(p.dtype)

        return update_leaf

    return _optimizer(init, start)


def make_optimizer(cfg):
    if cfg.optimizer == "adamw8bit":
        return adamw8bit(lr=cfg.learning_rate, weight_decay=cfg.weight_decay)
    if cfg.optimizer == "sgdm":
        return sgdm(lr=cfg.learning_rate, weight_decay=cfg.weight_decay)
    return adamw(lr=cfg.learning_rate, weight_decay=cfg.weight_decay)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(l.to(torch.float32)))
                          for l in T.leaves(tree)))


def clip_scale(norm, max_norm):
    """The factor that clips gradients of global norm ``norm`` to ``max_norm``."""
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_leaf(g, scale):
    return (g.to(torch.float32) * scale).to(g.dtype)


def clip_by_global_norm(tree, max_norm):
    n = global_norm(tree)
    scale = clip_scale(n, max_norm)
    return T.tree_map(lambda g: clip_leaf(g, scale), tree), n
