"""The port's train step updates the params leaf by leaf (the global norm
first, then per leaf its clipped gradient, the optimizer's update and the
subtraction), so that the clipped gradients and the updates are never all
held at once. It must give the same bits as the whole-tree step it
replaced. That step is kept here as the reference, copied from the port
before the change: ``clip_by_global_norm`` on every gradient, then each
optimizer's whole-tree ``update`` (``T.tree_map`` over the gradients,
moments and params, no ``Optimizer.start``), then every subtraction. Both
run from the same state on the same batches, for each optimizer (adamw,
adamw8bit, sgdm) on reduced dense, moe (Arctic's top-2 and Kimi's shared
expert) and encdec configs; params and optimizer state after 3 steps are
``torch.equal``. Neither the step nor an int8 scale-out leaves a tensor in
a reference cycle.
"""
import dataclasses
import gc

import numpy as np
import pytest
import torch

from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.data.synthetic import stub_inputs
from repro_torch.elastic import ElasticTrainer
from repro_torch.models import build_model
from repro_torch.optim.adamw import _dq8_static, _q8

STEPS = 3


def _clip_by_global_norm(tree, max_norm):
    n = torch.sqrt(sum(torch.sum(torch.square(l.to(torch.float32)))
                       for l in T.leaves(tree)))
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)
    return T.tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype), tree), n


def _tree_update(cfg, b1=0.9, b2=0.95, eps=1e-8):
    """The whole-tree ``update(grads, state, params)`` of ``cfg.optimizer``
    as the port had it: one ``T.tree_map`` over every leaf."""
    lr, wd = cfg.learning_rate, cfg.weight_decay

    @torch.no_grad()
    def adamw(grads, state, params):
        state["step"].add_(1)
        stepf = state["step"].to(torch.float32)
        bc1, bc2 = 1.0 - torch.pow(b1, stepf), 1.0 - torch.pow(b2, stepf)
        lr_t = lr * torch.tensor(1.0, dtype=torch.float32)

        def upd(g, m, v, p):
            g = g.to(torch.float32)
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps) + wd * p.to(torch.float32)
            return (lr_t * u).to(p.dtype)

        return T.tree_map(upd, grads, state["m"], state["v"], params)

    @torch.no_grad()
    def adamw8bit(grads, state, params):
        state["step"].add_(1)
        stepf = state["step"].to(torch.float32)
        bc1, bc2 = 1.0 - torch.pow(b1, stepf), 1.0 - torch.pow(b2, stepf)
        lr_t = lr * torch.tensor(1.0, dtype=torch.float32)

        def upd(p, g, mq, vq):
            g = g.to(torch.float32)
            m = _dq8_static(mq["codes"], mq["scale"], p.shape)
            v = _dq8_static(vq["codes"], vq["scale"], p.shape)
            m2 = b1 * m + (1 - b1) * g
            v2 = b2 * v + (1 - b2) * torch.square(g)
            u = (m2 / bc1) / (torch.sqrt(torch.clamp(v2 / bc2, min=0.0)) + eps)
            u = u + wd * p.to(torch.float32)
            for q, x in ((mq, m2), (vq, v2)):
                codes, scale = _q8(x)
                q["codes"].copy_(codes)
                q["scale"].copy_(scale)
            return (lr_t * u).to(p.dtype)

        return T.tree_map(upd, params, grads, state["m"], state["v"])

    @torch.no_grad()
    def sgdm(grads, state, params, momentum=0.9):
        lr_t = lr * torch.tensor(1.0, dtype=torch.float32)

        def upd(g, mu, p):
            g = g.to(torch.float32) + wd * p.to(torch.float32)
            mu.mul_(momentum).add_(g)
            return (lr_t * mu).to(p.dtype)

        updates = T.tree_map(upd, grads, state["mu"], params)
        state["step"].add_(1)
        return updates

    return {"adamw": adamw, "adamw8bit": adamw8bit, "sgdm": sgdm}[cfg.optimizer]


def _tree_step(model):
    """The whole-tree train step: every clipped gradient, then every
    update, then every subtraction."""
    update = _tree_update(model.cfg)

    def step(state, batch):
        params = state["params"]
        paths, leaves = zip(*T.flatten_with_paths(params))
        live = [p.detach().requires_grad_(True) for p in leaves]
        tot, _ = model.loss_fn(T.unflatten(paths, live), batch)
        grads = T.unflatten(paths, torch.autograd.grad(tot, live))
        grads, gnorm = _clip_by_global_norm(grads, model.cfg.grad_clip)
        updates = update(grads, state["opt"], params)
        with torch.no_grad():
            for p, u in zip(leaves, T.leaves(updates)):
                p.sub_(u)
        return state, gnorm

    return step


@pytest.mark.parametrize("optimizer", ["adamw", "adamw8bit", "sgdm"])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "arctic-480b", "kimi-k2-1t-a32b",
                                  "whisper-small"])
def test_leaf_by_leaf_step_equals_the_tree_step(arch, optimizer):
    cfg = dataclasses.replace(get_config(arch).reduced(), optimizer=optimizer)
    model = build_model(cfg, device="cpu")
    init = model.init_train_state(torch.Generator().manual_seed(4))
    states = [T.tree_map(torch.clone, init) for _ in range(2)]
    lean, tree = model.make_train_step(), _tree_step(model)
    rng = np.random.default_rng(3)
    for i in range(STEPS):
        batch = {"tokens": rng.integers(0, cfg.vocab, (2, 17)),
                 **stub_inputs(cfg, 2, seed=i)}
        states[0], metrics = lean(states[0], batch)
        states[1], gnorm = tree(states[1], batch)
        assert torch.equal(metrics["grad_norm"], gnorm)
    a, b = (T.flatten_with_paths(s) for s in states)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), path
    assert int(states[0]["opt"]["step"]) == STEPS
    moved = [not torch.equal(x, y) for x, y in zip(T.leaves(states[0]["params"]),
                                                   T.leaves(init["params"]))]
    assert sum(moved) >= len(moved) - 2  # every param moved, bar a zero-grad norm


@pytest.mark.parametrize("arch", ["gpt2", "rwkv6-1.6b", "zamba2-1.2b", "paligemma-3b",
                                  "kimi-k2-1t-a32b", "whisper-small"])
def test_step_and_scale_out_leave_no_tensor_in_a_cycle(arch):
    """The step frees each gradient once its leaf is updated, and a
    scale-out its codes and decoded copy, only if no reference cycle holds
    them: a cycle keeps them until the garbage collector next runs, which
    depends on what ran before in the process. (A cycle in
    ``tree.flatten_with_paths`` kept Kimi-K2's gradients and its
    scale-out's 9 GB of codes alive: its cut ran out of memory at the first
    step after a scale-out, but only behind other paths.) With the
    collector off, neither leaves a tensor unreachable."""
    cfg = get_config(arch).reduced()
    trainer = ElasticTrainer(build_model(cfg, device="cpu"), initial=2,
                             per_device_batch=1, codec="int8")
    trainer.init()
    rng = np.random.default_rng(3)

    def step():
        n = len(trainer.active)
        trainer.step({"tokens": rng.integers(0, cfg.vocab, (n, 17)),
                      **stub_inputs(cfg, n)})

    step()  # the first call's one-off imports leave cycles of their own
    gc.collect()
    gc.disable()
    try:
        step()
        trainer.scale_out()
        step()
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        cyclic = [tuple(o.shape) for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert not cyclic, cyclic[:8]
