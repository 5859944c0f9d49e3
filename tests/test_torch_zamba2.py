"""The port's Zamba2 against the JAX package's, on the CPU.

Reduced Zamba2 (2 Mamba2 blocks, d_model 64, the shared attention block
every 2 blocks): both sides start from the same
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
from repro.models import zamba2 as jax_zamba2
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import replication as trep
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models import zamba2

ARCH = "zamba2-1.2b"
SEQ = 64
#: share of parameters that agree to 1% of a step after one train step (as
#: in the GPT-2 test).
AGREE = 0.99
#: the full-size training state: params, bytes (params + AdamW m, v, step)
#: and leaves.
FULL = (1_096_549_248, 13_158_590_980, 61)


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
    assert ops.launches["ssd"] == ops.launches["flash_attention"] == 0  # the CPU path runs the plain version


def test_fp32_gradients_match_jax(setup):
    """With fp32 activations on both sides no bf16 rounding differs: loss
    and every leaf's gradient agree to 1e-4 (relative to the leaf's norm),
    so the port computes the JAX package's function, not only a loss near
    it."""
    jmodel, jstate, tokens = setup
    jcfg = jmodel.cfg

    def jloss(p):
        h, _ = jax_zamba2.forward(jcfg, p, tokens[:, :-1], return_hidden=True,
                                dtype=jnp.float32, use_pallas=True)
        return JL.chunked_cross_entropy(p["embed"], h, tokens[:, 1:], jcfg)

    jl, jg = jax.value_and_grad(jloss)(jstate["params"])
    cfg = get_config(ARCH).reduced()
    params = state_from_numpy(jax.tree.map(np.asarray, jstate["params"]), "cpu")
    paths, leaves = zip(*T.flatten_with_paths(params))
    live = [p.requires_grad_(True) for p in leaves]
    tparams = T.unflatten(paths, live)
    toks = torch.from_numpy(tokens).long()
    h, _ = zamba2.forward(cfg, tparams, toks[:, :-1], return_hidden=True,
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
    jmodel, jstate, tokens = setup
    host = jax.tree.map(np.asarray, jstate)
    jnew, jm = jax.jit(jmodel.make_train_step(use_pallas=True))(
        jstate, {"tokens": tokens})
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
    # Step-1 Adam moves every element by ±lr: the worst case is a
    # near-zero gradient whose sign flips between the two roundings (2*lr);
    # most elements agree to 1% of a step (AGREE).
    assert diff.max() <= 2 * lr * (1 + 1e-3)
    assert np.mean(diff <= 1e-2 * lr) >= AGREE


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


def test_prefill_state_path_is_the_training_forward():
    """From a zero state into a cache the prompt fills, the serving forward
    computes what the training forward computes (the same K/V attended, a
    zero conv context, a zero initial SSM state): logits bit for bit."""
    cfg = get_config(ARCH).reduced()
    params = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(2))
    toks = torch.randint(0, cfg.vocab, (2, 16),
                         generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want, _ = zamba2.forward(cfg, params, toks)
        got, state, _ = zamba2.forward(cfg, params, toks, last_only=True,
                                       state=zamba2.make_state(cfg, 2, 16))
    assert torch.equal(got, want[:, -1:])
    assert int(state["pos"]) == 16 and state["pos"].dtype == torch.int32


def test_conv_and_ssm_states_carry_a_sequence_split_in_two():
    """A Mamba2 block over 12 positions, run as 7 then 5 with the state
    carried, equals one run over all 12 (fp32: the conv bit for bit, the
    SSD's chunked sums within ``_rec_tol``), against the JAX block too."""
    from repro.models import mamba2 as jax_mamba2
    from repro_torch.models import mamba2

    cfg = get_config(ARCH).reduced()
    lp = T.unstack(build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(4))["mamba"], cfg.n_layers)[0]
    x = torch.randn((2, 12, cfg.d_model), generator=torch.Generator().manual_seed(5))
    st = mamba2.block_state(cfg, 2, dtype=torch.float32)
    with torch.no_grad():
        whole, end = mamba2.block_apply(lp, x, cfg, state=st)
        first, mid = mamba2.block_apply(lp, x[:, :7], cfg, state=st)
        second, end2 = mamba2.block_apply(lp, x[:, 7:], cfg, state=mid)
    tol = dict(rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(torch.cat([first, second], dim=1), whole, **tol)
    assert torch.equal(end2["conv"], end["conv"]) and end["conv"].dtype == torch.float32
    torch.testing.assert_close(end2["h"], end["h"], **tol)
    jlp = jax.tree.map(jnp.asarray, state_to_numpy(lp))
    jst = {"h": jnp.zeros(st["h"].shape, jnp.float32),
           "conv": jnp.zeros(st["conv"].shape, jnp.float32)}
    jout, jend = jax_mamba2.block_apply(jlp, jnp.asarray(x.numpy()),
                                        jax_get_config(ARCH).reduced(),
                                        state=jst, use_pallas=True)
    np.testing.assert_allclose(whole.numpy(), np.asarray(jout), **tol)
    np.testing.assert_allclose(end["h"].numpy(), np.asarray(jend["h"]), **tol)
    # The JAX block returns its context in bf16 whatever the forward's dtype.
    assert jend["conv"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        end["conv"].to(torch.bfloat16).float().numpy(),
        np.asarray(jend["conv"]).astype(np.float32))
