"""Model API of the port, from ``repro/models/model_api.py``: the dense
(GPT-2, TinyLlama, granite, llama3, gemma2), ssm (RWKV-6), hybrid
(Zamba2), vlm (PaliGemma), moe (Arctic, Kimi-K2) and encdec (Whisper)
families.

``build_model(cfg, device)`` returns a :class:`Model` exposing:
  * ``init(generator)`` → params
  * ``init_train_state(generator)`` → ``{"params", "opt"}``
  * ``param_specs()`` / ``train_state_specs()`` — the same trees on the
    meta device (shapes and dtypes, no memory), as ``jax.eval_shape``
    gives them in JAX
  * ``loss_fn(params, batch)`` → (loss, metrics)
  * ``make_train_step()`` → ``train_step(state, batch) -> (state, metrics)``
    (the config's optimizer + global-norm clipping, leaf by leaf)
  * ``prefill(params, batch)`` → (logits, cache)
  * ``decode_step(params, batch)`` → (logits, cache)
  * ``input_specs(cell)`` / ``cache_specs(batch, max_len)`` — meta-device
    stand-ins (no memory); ``make_batch(cell, generator)`` a random batch
    of those shapes.

Batch layouts (integer tokens):
  train:   {"tokens": (B, S+1)} (+ "patches" (B, n_patches, d) for vlm,
           "frames" (B, enc_len, d) for encdec)
  prefill: {"tokens": (B, S)} (+ "patches" or "frames")
  decode:  {"tokens": (B, 1), "pos": int or 0-d tensor, "cache": tree}

There is no ``use_pallas`` switch: attention, WKV6 and SSD always run the
port's kernels on CUDA. Serving runs for every family under
``torch.no_grad()``; the KV caches (dense, vlm and moe, hybrid's one per
application of its shared block, encdec's self caches) are written in
place, and an encdec prefill fills its cross-KV cache from the frames.
The vlm cache holds ``n_patches`` rows more than the text, the patches'; a
decode step's ``pos`` is the absolute cache row, ``n_patches + S + t`` for
the t-th step after a prompt of S tokens. The moe family's layers route
each call's tokens as one group (``n_groups=1``, as the JAX trainer
calls the loss), so a prefill, a decode step and a cache-free forward
each have their own expert capacity; its load-balance aux loss reaches
the train step's metrics as ``aux_loss`` and its total as ``AUX_COEF ·
aux``.

The train step updates the params leaf by leaf: the global norm of all
gradients first, then for each leaf its clipped gradient, the optimizer's
update (``Optimizer.start``) and the subtraction, after which the leaf's
gradient and update are dropped. Each element meets the same arithmetic as in the whole-tree ``clip_by_global_norm`` +
``update``, so params and optimizer state come out bit for bit the same,
but the clipped gradients and the updates are never held for every leaf
at once: that, with one leaf's optimizer transients, set Kimi-K2's peak.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import spans
from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import rwkv6, transformer, whisper, zamba2
from repro_torch.optim import global_norm, make_optimizer
from repro_torch.optim.adamw import clip_leaf, clip_scale

AUX_COEF = 0.01
#: families whose prefill and decode are ported.
SERVED = ("dense", "ssm", "hybrid", "vlm", "moe", "encdec")
#: family → (init, forward) of the ported families.
_FAMILIES = {
    "dense": (transformer.init_transformer, transformer.forward),
    "ssm": (rwkv6.init_rwkv6, rwkv6.forward),
    "hybrid": (zamba2.init_zamba2, zamba2.forward),
    "vlm": (transformer.init_transformer, transformer.forward),
    "moe": (transformer.init_transformer, transformer.forward),
    "encdec": (whisper.init_whisper, whisper.forward),
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

    def param_specs(self):
        """The params' shapes and dtypes as meta-device tensors, whatever
        the model's device: nothing is allocated, so full-size configs
        that fit no card can be checked."""
        return dataclasses.replace(self, device=torch.device("meta")).init(
            torch.Generator())

    def train_state_specs(self):
        """The training state's (params and optimizer state) shapes and
        dtypes as meta-device tensors; nothing is allocated."""
        return dataclasses.replace(self, device=torch.device("meta")).init_train_state(
            torch.Generator())

    def loss_fn(self, params, batch):
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        kwargs = {}
        if cfg.family == "vlm":
            kwargs["patch_embeds"] = torch.as_tensor(batch["patches"],
                                                     device=self.device)
        if cfg.family == "encdec":
            kwargs["frames"] = torch.as_tensor(batch["frames"], device=self.device)
        hidden, aux = _family_forward(cfg)(cfg, params, inputs,
                                           return_hidden=True, **kwargs)
        loss = L.chunked_cross_entropy(params["embed"], hidden, labels, cfg)
        total = loss + AUX_COEF * aux
        return total, {"loss": loss, "aux_loss": aux}

    def make_train_step(self):
        """One synchronous step on the global batch. The state's params and
        optimizer moments are updated in place, leaf by leaf (the module's
        docstring), and the same dict returned; metrics are 0-d tensors.
        The forward, the backward and the update each run in a span
        (``repro_torch.spans``), the update counting the leaves it updates."""
        cfg = self.cfg
        opt = make_optimizer(cfg)

        def train_step(state, batch):
            params = state["params"]
            paths, leaves = zip(*T.flatten_with_paths(params))
            live = [p.detach().requires_grad_(True) for p in leaves]
            with spans.span("repro_torch.step.forward"):
                tot, metrics = self.loss_fn(T.unflatten(paths, live), batch)
            with spans.span("repro_torch.step.backward"):
                grads = list(torch.autograd.grad(tot, live))
            del live
            with spans.span("repro_torch.step.update") as sp:
                gnorm = global_norm(T.unflatten(paths, grads))
                scale = clip_scale(gnorm, cfg.grad_clip)
                update = opt.start(state["opt"])
                with torch.no_grad():
                    for i, (path, p) in enumerate(zip(paths, leaves)):
                        g, grads[i] = grads[i], None
                        p.sub_(update(path, p, clip_leaf(g, scale)))
                        del g
                sp.count("leaves", len(paths))
            metrics = dict({k: v.detach() for k, v in metrics.items()},
                           grad_norm=gnorm, total_loss=tot.detach())
            return state, metrics

        return train_step

    # ------------------------------------------------------------ serving
    def _served(self):
        if self.cfg.family not in SERVED:
            raise NotImplementedError(
                f"serving the {self.cfg.family} family is not ported yet")

    @torch.no_grad()
    def prefill(self, params, batch, *, max_len: Optional[int] = None):
        """Run the prompt ``batch["tokens"]`` (B, S) from an empty cache →
        (last-position logits (B, 1, V), cache). The dense, hybrid and
        encdec KV caches hold ``max_len`` positions (default S, as in the
        JAX package, which leaves no room to decode); the vlm one prefills
        ``batch["patches"]`` (B, n_patches, d) in front of the prompt and
        holds ``max_len + n_patches`` rows (default S + n_patches, as in
        JAX); the encdec one runs ``batch["frames"]`` (B, enc_len, d)
        through the encoder into its cross-KV cache; the ssm state has no
        length."""
        self._served()
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        B, S = tokens.shape
        if cfg.family == "encdec":
            cache = whisper.make_cache(cfg, B, S if max_len is None else max_len,
                                       device=self.device)
            logits, cache, _ = whisper.forward(
                cfg, params, tokens, frames=torch.as_tensor(batch["frames"],
                                                            device=self.device),
                cache=cache, cache_pos=0, last_only=True)
            return logits, cache
        if cfg.family in ("dense", "vlm", "moe"):
            kwargs, prefix = {}, 0
            if cfg.family == "vlm":
                prefix = cfg.n_patches
                kwargs["patch_embeds"] = torch.as_tensor(batch["patches"],
                                                         device=self.device)
            cache = transformer.make_cache(cfg, B, S if max_len is None else max_len,
                                           device=self.device, prefix=prefix)
            logits, cache, _ = transformer.forward(cfg, params, tokens, cache=cache,
                                                   cache_pos=0, last_only=True,
                                                   **kwargs)
            return logits, cache
        if cfg.family == "hybrid":
            state = zamba2.make_state(cfg, B, S if max_len is None else max_len,
                                      device=self.device)
            logits, state, _ = zamba2.forward(cfg, params, tokens,
                                              state=dict(state, pos=0),
                                              last_only=True)
            return logits, state
        state = rwkv6.make_state(cfg, B, device=self.device)
        logits, state, _ = rwkv6.forward(cfg, params, tokens, state=state,
                                         last_only=True)
        return logits, state

    @torch.no_grad()
    def decode_step(self, params, batch):
        """batch: {"tokens": (B, 1), "pos": write position, "cache"} →
        (logits (B, 1, V), cache). A KV cache is written in place at
        ``pos`` and returned; writing past its end raises. The hybrid
        family, as in JAX, takes the position from ``pos``, not from the
        state. The vlm family's ``pos`` is the absolute cache row, patches
        included. ``pos`` is unused by the ssm family, whose state carries
        no position."""
        self._served()
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        if cfg.family in ("dense", "vlm", "moe"):
            logits, cache, _ = transformer.forward(
                cfg, params, tokens, cache=batch["cache"], cache_pos=batch["pos"])
            return logits, cache
        if cfg.family == "encdec":
            logits, cache, _ = whisper.forward(
                cfg, params, tokens, cache=batch["cache"], cache_pos=batch["pos"])
            return logits, cache
        if cfg.family == "hybrid":
            logits, state, _ = zamba2.forward(
                cfg, params, tokens, state=dict(batch["cache"], pos=batch["pos"]))
            return logits, state
        logits, state, _ = rwkv6.forward(cfg, params, tokens, state=batch["cache"])
        return logits, state

    # ------------------------------------------------------------ specs
    def input_specs(self, cell: ShapeCell):
        """Meta-device stand-ins for every model input of this cell."""
        cfg = self.cfg
        B, S = cell.global_batch, cell.seq_len
        i32 = torch.int32
        if cell.kind in ("train", "prefill"):
            n = S + 1 if cell.kind == "train" else S
            specs = {"tokens": torch.empty((B, n), dtype=i32, device="meta")}
            stub = {"vlm": ("patches", cfg.n_patches),
                    "encdec": ("frames", cfg.enc_len)}.get(cfg.family)
            if stub:
                specs[stub[0]] = torch.empty((B, stub[1], cfg.d_model),
                                             dtype=torch.bfloat16, device="meta")
            return specs
        return {"tokens": torch.empty((B, 1), dtype=i32, device="meta"),
                "pos": torch.empty((), dtype=i32, device="meta"),
                "cache": self.cache_specs(B, S)}

    def cache_specs(self, batch, max_len):
        self._served()
        if self.cfg.family in ("dense", "moe"):
            return transformer.cache_specs(self.cfg, batch, max_len)
        if self.cfg.family == "vlm":
            return transformer.cache_specs(self.cfg, batch, max_len,
                                           prefix=self.cfg.n_patches)
        if self.cfg.family == "encdec":
            return whisper.cache_specs(self.cfg, batch, max_len)
        if self.cfg.family == "hybrid":
            return zamba2.state_specs(self.cfg, batch, max_len)
        return rwkv6.state_specs(self.cfg, batch)

    def make_batch(self, cell: ShapeCell, generator: Optional[torch.Generator] = None):
        """A random batch of ``input_specs(cell)``'s shapes on the model's
        device, as JAX's ``make_batch`` makes one: integer arrays uniform in
        [0, vocab), the decode position ``max(0, seq_len - 1)``, every float
        array (a vlm's patches, an encdec's frames, a decode's cache)
        normals cast to its dtype, times 0.02. Drawn from ``generator``
        (default: seeded with 0) leaf by leaf in the specs' order;
        ``jax.random`` cannot be replayed, so the values are not JAX's."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        paths, specs = zip(*T.flatten_with_paths(self.input_specs(cell)))

        def make(s):
            if s.dtype == torch.int32 and s.dim():
                return torch.randint(0, self.cfg.vocab, s.shape, generator=generator,
                                     dtype=torch.int32, device=self.device)
            if s.dtype == torch.int32:
                return torch.tensor(max(0, cell.seq_len - 1), dtype=torch.int32,
                                    device=self.device)
            return torch.randn(s.shape, generator=generator, dtype=torch.float32,
                               device=self.device).to(s.dtype) * 0.02

        return T.unflatten(paths, [make(s) for s in specs])


def build_model(cfg: ArchConfig, device=None) -> Model:
    """``device``: CUDA unless given (``"cpu"`` runs the plain versions)."""
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    return Model(cfg, resolve_device(device))
