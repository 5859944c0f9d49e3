"""Model API of the port, from ``repro/models/model_api.py``: the dense
(GPT-2), ssm (RWKV-6) and hybrid (Zamba2) families.

``build_model(cfg, device)`` returns a :class:`Model` exposing:
  * ``init(generator)`` → params
  * ``init_train_state(generator)`` → ``{"params", "opt"}``
  * ``loss_fn(params, batch)`` → (loss, metrics)
  * ``make_train_step()`` → ``train_step(state, batch) -> (state, metrics)``
    (AdamW + global-norm clipping)

Train batches are ``{"tokens": (B, S+1)}`` integer tokens. There is no
``use_pallas`` switch: attention, WKV6 and SSD always run the port's
kernels on CUDA. Serving (``prefill``/``decode_step``) and the moe, vlm and
encdec families are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import rwkv6, transformer, zamba2
from repro_torch.optim import clip_by_global_norm, make_optimizer

AUX_COEF = 0.01
#: family → (init, forward) of the ported families.
_FAMILIES = {
    "dense": (transformer.init_transformer, transformer.forward),
    "ssm": (rwkv6.init_rwkv6, rwkv6.forward),
    "hybrid": (zamba2.init_zamba2, zamba2.forward),
}


def _family_forward(cfg):
    return _FAMILIES[cfg.family][1]


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    device: torch.device

    def init(self, generator: Optional[torch.Generator] = None):
        """Params drawn from ``generator`` (default: seeded with 0)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        return _FAMILIES[self.cfg.family][0](self.cfg, generator, self.device)

    def init_train_state(self, generator: Optional[torch.Generator] = None):
        params = self.init(generator)
        opt = make_optimizer(self.cfg)
        return {"params": params, "opt": opt.init(params)}

    def loss_fn(self, params, batch):
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        hidden, aux = _family_forward(cfg)(cfg, params, inputs,
                                           return_hidden=True)
        loss = L.chunked_cross_entropy(params["embed"], hidden, labels, cfg)
        total = loss + AUX_COEF * aux
        return total, {"loss": loss, "aux_loss": aux}

    def make_train_step(self):
        """One synchronous step on the global batch. The state's params and
        optimizer moments are updated in place and the same dict returned;
        metrics are 0-d tensors."""
        cfg = self.cfg
        opt = make_optimizer(cfg)

        def train_step(state, batch):
            params = state["params"]
            paths, leaves = zip(*T.flatten_with_paths(params))
            live = [p.detach().requires_grad_(True) for p in leaves]
            tot, metrics = self.loss_fn(T.unflatten(paths, live), batch)
            grads = T.unflatten(paths, torch.autograd.grad(tot, live))
            grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
            updates, _ = opt.update(grads, state["opt"], params)
            with torch.no_grad():
                for p, u in zip(leaves, T.leaves(updates)):
                    p.sub_(u)
            metrics = dict({k: v.detach() for k, v in metrics.items()},
                           grad_norm=gnorm, total_loss=tot.detach())
            return state, metrics

        return train_step


def build_model(cfg: ArchConfig, device=None) -> Model:
    """``device``: CUDA unless given (``"cpu"`` runs the plain versions)."""
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    return Model(cfg, resolve_device(device))
