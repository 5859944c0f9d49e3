"""The port's optimisers, top-k compression and LoRA against the JAX
package's, on the CPU.

``tests/test_substrate.py``'s seven optimiser, top-k and LoRA tests run on
the port; the JAX functions and the port's are held to each other on the
same inputs, drawn from ``np.random.default_rng``: ``_q8`` bit for bit
(against JAX run op by op: jitted, XLA rewrites ``_q8``'s ``/ 127.0`` into
a multiply by the fp32 reciprocal, which moves some scales by an ulp),
``adamw8bit`` and ``sgdm`` steps on equal fp32 gradients, top-k with error
feedback, and LoRA's delta and merge on JAX's adapters carried across
through ``convert``.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.optim import compression as jax_compression
from repro.optim import lora as jax_lora
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.models import build_model
from repro_torch.optim import (
    adamw,
    adamw8bit,
    lora_apply_delta,
    lora_init,
    lora_merge,
    make_optimizer,
    sgdm,
)
from repro_torch.optim.compression import ef_init, topk_compress_ef
from repro_torch.optim.lora import lora_param_bytes, lora_targets

# ``repro.optim`` and ``repro_torch.optim`` export functions named
# ``adamw``, which shadow their modules as attributes.
jax_adamw = importlib.import_module("repro.optim.adamw")
torch_adamw = importlib.import_module("repro_torch.optim.adamw")

#: leaf shapes whose last dims give every block size of ``_block_of``: 256
#: (2048, 384 -> 128), 32 (96), 8 (1000), 1 (7), a 0-d leaf, and a
#: stacked 3-D leaf as the layers' params are.
Q8_SHAPES = [(320, 2048), (4, 384), (3, 5, 96), (2, 1000), (7,), (), (2, 64, 256)]


def _rand(rng, shape, spread=True):
    """Normal values whose magnitude varies by block, as moments do."""
    x = rng.standard_normal(shape)
    if spread and shape:
        x = x * np.exp(rng.uniform(-12.0, 2.0, shape[:-1] + (1,)))
    return np.asarray(x, np.float32)


# -- test_substrate.py's tests, on the port -------------------------------------


def _quadratic_losses(opt, steps=200, dim=32):
    target = torch.from_numpy(np.random.default_rng(0).standard_normal(dim)
                              .astype(np.float32))
    params = {"w": torch.zeros(dim)}
    state = opt.init(params)
    losses = []
    for _ in range(steps):
        w = params["w"].detach().requires_grad_(True)
        loss = torch.sum((w - target) ** 2)
        (g,) = torch.autograd.grad(loss, [w])
        updates, state = opt.update({"w": g}, state, params)
        params = {"w": params["w"] - updates["w"]}
        losses.append(float(loss.detach()))
    return losses


def test_adamw_converges():
    losses = _quadratic_losses(adamw(lr=0.05, weight_decay=0.0))
    assert losses[-1] < 1e-2 * losses[0]


def test_adamw8bit_tracks_fp32():
    l32 = _quadratic_losses(adamw(lr=0.05, weight_decay=0.0), steps=100)
    l8 = _quadratic_losses(adamw8bit(lr=0.05, weight_decay=0.0), steps=100)
    assert l8[-1] < 1e-1 * l8[0]
    assert abs(np.log10(l8[-1] + 1e-12) - np.log10(l32[-1] + 1e-12)) < 2.0


def test_adamw8bit_state_is_small():
    params = {"w": torch.zeros((1024, 64))}
    st = adamw8bit().init(params)
    m_bytes = sum(leaf.numel() * leaf.element_size() for leaf in T.leaves(st["m"]))
    assert m_bytes < params["w"].numel() * 4 * 0.6  # far below fp32 moments


def test_sgdm_converges():
    losses = _quadratic_losses(sgdm(lr=0.02), steps=300)
    assert losses[-1] < 1e-2 * losses[0]


def test_topk_ef_converges_like_dense():
    target = torch.from_numpy(np.random.default_rng(1).standard_normal(64)
                              .astype(np.float32))
    params = {"w": torch.zeros(64)}
    resid = ef_init(params)
    lr = 0.05
    for _ in range(600):
        g = {"w": 2.0 * (params["w"] - target)}
        sparse, resid = topk_compress_ef(g, resid, k_frac=0.1)
        params = {"w": params["w"] - lr * sparse["w"]}
    assert float(torch.sum((params["w"] - target) ** 2)) < 1e-3


def test_topk_sparsity():
    g = {"w": torch.arange(100.0)}
    sparse, _ = topk_compress_ef(g, ef_init(g), k_frac=0.05)
    assert int(torch.sum(sparse["w"] != 0)) <= 6


def test_lora_targets_and_merge():
    params = build_model(get_config("gpt2").reduced(), device="cpu").init(
        torch.Generator().manual_seed(0))
    adapters, scaling = lora_init(params, rank=2)
    assert adapters, "no LoRA targets found"
    merged = lora_merge(params, adapters, scaling)
    # b is zero-init → merge is identity at init.
    for a, b in zip(T.leaves(params), T.leaves(merged)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    # LoRA state is tiny vs the model (the paper's 1.7 MiB point).
    model_bytes = sum(leaf.numel() * 4 for leaf in T.leaves(params))
    assert lora_param_bytes(adapters) < 0.2 * model_bytes


# -- parity with the JAX package --------------------------------------------------


@pytest.mark.parametrize("shape", Q8_SHAPES, ids=str)
def test_q8_bit_for_bit(shape):
    """``_q8`` on the same fp32 input: codes and scales equal to JAX's bit
    for bit (JAX op by op), and ``_dq8_static`` too."""
    x = _rand(np.random.default_rng(len(shape) * 7 + sum(shape)), shape)
    jc, js = jax_adamw._q8(jnp.asarray(x))
    tc, ts = torch_adamw._q8(torch.from_numpy(x))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(tc.shape) == jc.shape and tuple(ts.shape) == js.shape
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    assert np.asarray(js).tobytes() == ts.numpy().tobytes()
    jd = jax_adamw._dq8_static(jc, js, shape)
    td = torch_adamw._dq8_static(tc, ts, shape)
    assert np.asarray(jd).tobytes() == td.numpy().tobytes()
    assert torch_adamw._block_of(shape[-1] if shape else 1) == \
        jax_adamw._block_of(shape[-1] if shape else 1)


def _param_tree(rng):
    return {"a": {"w": _rand(rng, (8, 512), spread=False)},
            "b": _rand(rng, (3, 96), spread=False),
            "c": _rand(rng, (7,), spread=False)}


def _grads(rng, params):
    return jax.tree.map(lambda p: _rand(rng, p.shape), params)


def test_adamw8bit_steps_match_jax():
    """Three ``adamw8bit`` updates on equal fp32 gradients: the updates
    agree to fp32 rounding (rtol 1e-5), the step counts are equal, and the
    codes and scales of both moments agree; a code may differ by one where
    a moment lands within an ulp of a rounding edge, so those are counted
    and each held within one code. The update writes the moments into the
    state's own tensors and returns the same dict."""
    rng = np.random.default_rng(21)
    params = _param_tree(rng)
    jopt, topt = jax_adamw.adamw8bit(lr=1e-3), adamw8bit(lr=1e-3)
    jst = jopt.init(jax.tree.map(jnp.asarray, params))
    tparams = state_from_numpy(params, "cpu")
    tst = topt.init(tparams)
    codes_before = tst["m"]["a"]["w"]["codes"]
    n_codes = off_by_one = 0
    for _ in range(3):
        grads = _grads(rng, params)
        jup, jst = jopt.update(jax.tree.map(jnp.asarray, grads), jst,
                               jax.tree.map(jnp.asarray, params))
        tup, tst_out = topt.update(state_from_numpy(grads, "cpu"), tst, tparams)
        assert tst_out is tst
        for a, b in zip(T.leaves(state_to_numpy(tup)), jax.tree_util.tree_leaves(jup)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-9)
        for key in ("m", "v"):
            for (path, a), b in zip(T.flatten_with_paths(state_to_numpy(tst[key])),
                                    jax.tree_util.tree_leaves(jst[key])):
                b = np.asarray(b)
                if path[-1] == "codes":
                    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
                    assert d.max() <= 1, path
                    n_codes += d.size
                    off_by_one += int(d.sum())
                else:
                    np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)
    assert int(tst["step"]) == int(jst["step"]) == 3
    assert tst["m"]["a"]["w"]["codes"] is codes_before
    assert off_by_one <= 1e-3 * n_codes, (off_by_one, n_codes)


def test_sgdm_steps_match_jax():
    """Two ``sgdm`` updates (with weight decay) on equal fp32 gradients:
    the updates and ``mu`` agree to fp32 rounding, ``mu`` updated in place."""
    rng = np.random.default_rng(22)
    params = _param_tree(rng)
    jopt, topt = (jax_adamw.sgdm(lr=0.1, weight_decay=0.01),
                  sgdm(lr=0.1, weight_decay=0.01))
    jst = jopt.init(params)
    tparams = state_from_numpy(params, "cpu")
    tst = topt.init(tparams)
    mu = tst["mu"]["b"]
    for _ in range(2):
        grads = _grads(rng, params)
        jup, jst = jopt.update(grads, jst, params)
        tup, tst = topt.update(state_from_numpy(grads, "cpu"), tst, tparams)
        for a, b in zip(T.leaves(state_to_numpy(tup)), jax.tree_util.tree_leaves(jup)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-9)
    for a, b in zip(T.leaves(state_to_numpy(tst["mu"])),
                    jax.tree_util.tree_leaves(jst["mu"])):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-9)
    assert tst["mu"]["b"] is mu
    assert int(tst["step"]) == int(jst["step"]) == 2


@pytest.mark.parametrize("arch, kind", [("tinyllama-1.1b", "adamw"),
                                        ("llama3-405b", "adamw8bit"),
                                        ("gemma2-27b", "adamw8bit")])
def test_make_optimizer_builds_the_configs_optimizer(arch, kind):
    """``make_optimizer`` dispatches as JAX's does: the reduced config's
    optimizer state has the JAX state's paths, shapes and dtypes; an sgdm
    config gets ``mu`` and ``step``."""
    import dataclasses

    cfg = get_config(arch).reduced()
    assert cfg.optimizer == kind
    params = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    st = make_optimizer(cfg).init(params)
    jparams = jax.tree.map(jnp.asarray, state_to_numpy(params))
    jst = jax_adamw.make_optimizer(jax_get_config(arch).reduced()).init(jparams)
    assert [("/".join(p), tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for p, x in T.flatten_with_paths(st)] == \
        [("/".join(str(k.key) for k in p), x.shape, str(x.dtype))
         for p, x in jax.tree_util.tree_flatten_with_path(jst)[0]]
    sg = make_optimizer(dataclasses.replace(cfg, optimizer="sgdm")).init(params)
    assert sorted(sg) == ["mu", "step"]


@pytest.mark.parametrize("k_frac", [0.01, 0.1, 0.5])
def test_topk_compress_ef_matches_jax(k_frac):
    """The same sparse gradients and residuals as JAX, bit for bit, from a
    nonzero residual, with ties at the threshold (every tied entry
    passes, as in JAX)."""
    rng = np.random.default_rng(23)
    grads = {"a": rng.standard_normal((16, 40)).astype(np.float32),
             "b": np.round(rng.standard_normal(300) * 4).astype(np.float32)}
    resid = {"a": (0.1 * rng.standard_normal((16, 40))).astype(np.float32),
             "b": np.zeros(300, np.float32)}
    js, jr = jax_compression.topk_compress_ef(grads, resid, k_frac=k_frac)
    ts, tr = topk_compress_ef(state_from_numpy(grads, "cpu"),
                              state_from_numpy(resid, "cpu"), k_frac=k_frac)
    for t, j in ((ts, js), (tr, jr)):
        for a, b in zip(T.leaves(state_to_numpy(t)), jax.tree_util.tree_leaves(j)):
            assert a.tobytes() == np.asarray(b).tobytes()
    k = max(1, int(300 * k_frac))
    assert int((ts["b"] != 0).sum()) >= k  # ties at the threshold all pass


def test_lora_matches_jax():
    """JAX's adapters (``b`` made nonzero) on a reduced TinyLlama carried
    across: the same targets, and ``lora_apply_delta`` / ``lora_merge``
    within fp32 ``_tol`` of JAX's; ``params`` is left as it was."""
    jcfg = jax_get_config("tinyllama-1.1b").reduced()
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(3))
    adapters, scaling = jax_lora.lora_init(jparams, rank=4)
    rng = np.random.default_rng(24)
    adapters = {k: {"a": v["a"], "b": jnp.asarray(rng.standard_normal(v["b"].shape),
                                                   jnp.float32)}
                for k, v in adapters.items()}
    host = jax.tree.map(np.asarray, jparams)
    tparams = state_from_numpy(host, "cpu")
    tadapters = state_from_numpy(jax.tree.map(np.asarray, adapters), "cpu")
    assert ["/".join(p) for p in lora_targets(tparams)] == \
        ["/".join(p) for p in jax_lora.lora_targets(host)]
    assert any(p.endswith("w3") for p in tadapters)
    for jfn, tfn in ((jax_lora.lora_apply_delta, lora_apply_delta),
                     (jax_lora.lora_merge, lora_merge)):
        want = jax.tree.map(np.asarray, jfn(jparams, adapters, scaling))
        got = tfn(tparams, tadapters, scaling)
        for (path, a), b in zip(T.flatten_with_paths(state_to_numpy(got)),
                                jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5, err_msg=str(path))
    for a, b in zip(T.leaves(state_to_numpy(tparams)), jax.tree_util.tree_leaves(host)):
        assert a.tobytes() == b.tobytes()
    assert lora_param_bytes(tadapters) == jax_lora.lora_param_bytes(adapters)
    ours, s = lora_init(tparams, rank=4, generator=torch.Generator().manual_seed(0))
    assert s == scaling and set(ours) == set(tadapters)
    for key, ab in ours.items():
        assert ab["a"].shape == tadapters[key]["a"].shape and not ab["b"].any()
