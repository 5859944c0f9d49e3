"""The port's RWKV-6 against the JAX package's, on the CPU.

Reduced RWKV-6 (2 layers, d_model 64): both sides start from the same
JAX-initialised state (converted through numpy) and see the same tokens.
The full-size state is compared as shapes only (the JAX ``eval_shape``
against the port's init on the meta device). Tolerances are stated per
check.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import replication as jrep
from repro.models import build_model as jax_build_model
from repro.models import layers as JL
from repro.models import rwkv6 as jax_rwkv6
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import replication as trep
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models import rwkv6

ARCH = "rwkv6-1.6b"
SEQ = 64
#: share of parameters that agree to 1% of a step after one train step,
#: over all elements (RWKV-6 measured 98.6%) and, as the GPT-2 test asks,
#: 99% over the elements whose JAX gradient is resolved in bf16 (see
#: ``test_train_step_matches_jax``).
AGREE_ALL, AGREE = 0.98, 0.99
#: bf16's relative precision: an element whose gradient is below this
#: share of its leaf's gradient rms lies within the rounding of the bf16
#: products that are summed into it, so its sign is not resolved.
BF16_RESOLVED = 2.0 ** -8
#: the full-size training state: params, bytes (params + AdamW m, v, step)
#: and leaves.
FULL = (1_599_868_928, 19_198_427_140, 85)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config(ARCH).reduced()
    jmodel = jax_build_model(jcfg)
    jstate = jmodel.init_train_state(jax.random.PRNGKey(1))
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, jcfg.vocab, size=(2, SEQ + 1)).astype(np.int32)
    return jmodel, jstate, tokens


def _specs(jtree):
    return [("/".join(str(k.key) for k in p), tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(jtree)[0]]


def _tspecs(ttree):
    return [("/".join(p), tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for p, x in T.flatten_with_paths(ttree)]


def test_config_equals_jax():
    a, b = get_config(ARCH), jax_get_config(ARCH)
    assert a.__dict__ == b.__dict__
    assert a.reduced().__dict__ == b.reduced().__dict__
    assert a.param_count() == b.param_count()
    assert a.reduced().param_count() == b.reduced().param_count()


def test_full_size_state_matches_jax_specs():
    jspecs = jax_build_model(jax_get_config(ARCH)).train_state_specs()
    tstate = build_model(get_config(ARCH), device="meta").init_train_state(
        torch.Generator())
    assert _tspecs(tstate) == _specs(jspecs)
    n_params = sum(p.numel() for p in T.leaves(tstate["params"]))
    manifest = trep.build_manifest(tstate)
    assert (n_params, manifest.total_bytes, len(manifest.entries)) == FULL


def test_init_matches_jax_paths_shapes_and_dtypes(setup):
    _, jstate, _ = setup
    tstate = build_model(get_config(ARCH).reduced(), device="cpu") \
        .init_train_state(torch.Generator().manual_seed(0))
    assert _tspecs(tstate) == _specs(jax.tree.map(np.asarray, jstate))


def test_loss_matches_jax_pallas_path(setup):
    """rtol 2e-2: bf16 activations round at different places in the two
    frameworks (``_tol`` for bf16 in tests/test_kernels.py)."""
    jmodel, jstate, tokens = setup
    jloss, _ = jmodel.loss_fn(jstate["params"], {"tokens": tokens},
                              use_pallas=True)
    model = build_model(get_config(ARCH).reduced(), device="cpu")
    params = state_from_numpy(jax.tree.map(np.asarray, jstate["params"]), "cpu")
    ops.reset_launches()
    tloss, metrics = model.loss_fn(params, {"tokens": tokens})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=2e-2)
    assert float(metrics["aux_loss"]) == 0.0
    assert ops.launches["wkv6"] == 0  # the CPU path runs the plain version


def test_fp32_gradients_match_jax(setup):
    """With fp32 activations on both sides no bf16 rounding differs: loss
    and every leaf's gradient agree to 1e-4 (relative to the leaf's norm),
    so the port computes the JAX package's function, not only a loss near
    it."""
    jmodel, jstate, tokens = setup
    jcfg = jmodel.cfg

    def jloss(p):
        h, _ = jax_rwkv6.forward(jcfg, p, tokens[:, :-1], return_hidden=True,
                                dtype=jnp.float32, use_pallas=True)
        return JL.chunked_cross_entropy(p["embed"], h, tokens[:, 1:], jcfg)

    jl, jg = jax.value_and_grad(jloss)(jstate["params"])
    cfg = get_config(ARCH).reduced()
    params = state_from_numpy(jax.tree.map(np.asarray, jstate["params"]), "cpu")
    paths, leaves = zip(*T.flatten_with_paths(params))
    live = [p.requires_grad_(True) for p in leaves]
    tparams = T.unflatten(paths, live)
    toks = torch.from_numpy(tokens).long()
    h, _ = rwkv6.forward(cfg, tparams, toks[:, :-1], return_hidden=True,
                         dtype=torch.float32)
    tl = L.chunked_cross_entropy(tparams["embed"], h, toks[:, 1:], cfg)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(jg), torch.autograd.grad(tl, live)):
        a = np.asarray(a)
        assert np.linalg.norm(b.numpy() - a) <= 1e-4 * np.linalg.norm(a)


def test_remat_gives_the_same_loss_and_gradients(setup):
    """The full configs train with ``remat`` (a non-reentrant checkpoint
    per layer around the kernel wrappers): on the reduced model it must
    change nothing but what is kept for the backward."""
    import dataclasses

    _, jstate, tokens = setup
    host = jax.tree.map(np.asarray, jstate["params"])
    results = []
    for remat in (False, True):
        cfg = dataclasses.replace(get_config(ARCH).reduced(), remat=remat)
        params = state_from_numpy(host, "cpu")
        paths, leaves = zip(*T.flatten_with_paths(params))
        live = [p.requires_grad_(True) for p in leaves]
        loss, _ = build_model(cfg, device="cpu").loss_fn(
            T.unflatten(paths, live), {"tokens": tokens})
        results.append((loss, torch.autograd.grad(loss, live)))
    (l0, g0), (l1, g1) = results
    assert float(l0.detach()) == float(l1.detach())
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_train_step_matches_jax(setup):
    """Where the two frameworks disagree after one step, and why.

    Step-1 Adam moves an element by ``lr·g/(|g| + eps)`` (plus the same
    weight decay on both sides), so an element differs by more than 1% of a
    step only where its gradient's sign flips between the two frameworks'
    bf16 roundings, or where it is small enough that ``eps`` counts. Over
    all elements 98.6% agree; the rest sit mostly in the decay and mixing
    LoRAs (``tm/lora_A`` 4.0%, ``tm/wA`` 3.1% disagree), whose disagreeing
    elements have JAX gradients of median 3e-6 and 6e-6 against leaf rms
    1.5e-3 and 5.3e-4. Leaving out the elements whose JAX gradient is below
    ``BF16_RESOLVED`` of their leaf's gradient rms (7.3% of them), 99.3%
    agree. ``test_fp32_gradients_match_jax`` holds the algorithm itself to
    1e-4 with fp32 activations."""
    jmodel, jstate, tokens = setup
    host = jax.tree.map(np.asarray, jstate)
    jnew, jm = jax.jit(jmodel.make_train_step(use_pallas=True))(
        jstate, {"tokens": tokens})
    jgrads = jax.jit(jax.grad(lambda p: jmodel.loss_fn(
        p, {"tokens": tokens}, use_pallas=True)[0]))(jstate["params"])
    cfg = get_config(ARCH).reduced()
    tnew, tm = build_model(cfg, device="cpu").make_train_step()(
        state_from_numpy(host, "cpu"), {"tokens": tokens})
    # bf16 activations: loss and gradient norm agree to bf16's 2e-2.
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=2e-2)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=2e-2)
    lr = cfg.learning_rate
    jp = jax.tree_util.tree_leaves(jax.tree.map(np.asarray, jnew["params"]))
    tp = T.leaves(state_to_numpy(tnew["params"]))
    diff = np.concatenate([np.abs(a - b).reshape(-1) for a, b in zip(tp, jp)])
    resolved = np.concatenate([
        np.abs(g) >= BF16_RESOLVED * np.sqrt(np.mean(np.square(g)))
        for g in (np.asarray(g, np.float32).reshape(-1)
                  for g in jax.tree_util.tree_leaves(jgrads))])
    # A sign flip is the worst case: 2*lr.
    assert diff.max() <= 2 * lr * (1 + 1e-3)
    assert np.mean(diff <= 1e-2 * lr) >= AGREE_ALL
    assert np.mean(resolved) >= 0.9
    assert np.mean(diff[resolved] <= 1e-2 * lr) >= AGREE


def test_replication_manifest_matches_jax(setup):
    _, jstate, _ = setup
    host = jax.tree.map(np.asarray, jstate)
    jm = jrep.build_manifest(host)
    tm = trep.build_manifest(state_from_numpy(host, "cpu"))
    assert tm.total_bytes == jm.total_bytes
    assert [(e.path, tuple(e.shape), e.dtype, e.offset, e.nbytes)
            for e in tm.entries] == \
        [(e.path, tuple(e.shape), e.dtype, e.offset, e.nbytes)
         for e in jm.entries]
