"""The port's reduced GPT-2 against the JAX package's, on the CPU.

Both sides start from the same JAX-initialised state (converted through
numpy) and see the same tokens. Activations are bf16 on both sides but
round at different places, hence the tolerances stated per check.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.models import build_model
from repro_torch.optim import adamw, clip_by_global_norm, global_norm

SEQ = 64


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config("gpt2").reduced()
    jmodel = jax_build_model(jcfg)
    jstate = jmodel.init_train_state(jax.random.PRNGKey(1))
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, jcfg.vocab, size=(2, SEQ + 1)).astype(np.int32)
    return jcfg, jmodel, jstate, tokens


def test_configs_equal():
    for name in ("gpt2", "gpt2-medium", "gpt2-large"):
        a, b = get_config(name), jax_get_config(name)
        assert a.__dataclass_fields__.keys() == b.__dataclass_fields__.keys()
        for f in a.__dataclass_fields__:
            assert getattr(a, f) == getattr(b, f), (name, f)
        assert a.reduced().__dict__ == b.reduced().__dict__
        assert a.param_count() == b.param_count()


def test_init_matches_jax_paths_shapes_and_dtypes(setup):
    _, jmodel, jstate, _ = setup
    cfg = get_config("gpt2").reduced()
    tstate = build_model(cfg, device="cpu").init_train_state(
        torch.Generator().manual_seed(0))
    jpaths = [("/".join(str(k.key) for k in p), np.asarray(x).shape,
               str(np.asarray(x).dtype))
              for p, x in jax.tree_util.tree_flatten_with_path(jstate)[0]]
    tpaths = [("/".join(p), tuple(x.shape), str(x.dtype).removeprefix("torch."))
              for p, x in T.flatten_with_paths(tstate)]
    assert tpaths == jpaths


def test_loss_matches_jax_pallas_path(setup):
    """rtol 2e-2: the bf16 activations of the two frameworks round at
    different places (``_tol`` for bf16 in tests/test_kernels.py)."""
    jcfg, jmodel, jstate, tokens = setup
    jloss, _ = jmodel.loss_fn(jstate["params"], {"tokens": tokens},
                              use_pallas=True)
    model = build_model(get_config("gpt2").reduced(), device="cpu")
    params = state_from_numpy(jax.tree.map(np.asarray, jstate["params"]), "cpu")
    tloss, metrics = model.loss_fn(params, {"tokens": tokens})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=2e-2)
    assert float(metrics["aux_loss"]) == 0.0


def test_train_step_matches_jax(setup):
    jcfg, jmodel, jstate, tokens = setup
    host = jax.tree.map(np.asarray, jstate)
    jnew, jm = jax.jit(jmodel.make_train_step(use_pallas=True))(
        jstate, {"tokens": tokens})
    model = build_model(get_config("gpt2").reduced(), device="cpu")
    tnew, tm = model.make_train_step()(state_from_numpy(host, "cpu"),
                                       {"tokens": tokens})
    # bf16 activations: the gradient norm agrees to bf16's 2e-2.
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=2e-2)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=2e-2)
    lr = jcfg.learning_rate
    assert int(tnew["opt"]["step"]) == int(jnew["opt"]["step"]) == 1
    jp = jax.tree_util.tree_leaves(jax.tree.map(np.asarray, jnew["params"]))
    tp = T.leaves(state_to_numpy(tnew["params"]))
    diff = np.concatenate([np.abs(a - b).reshape(-1) for a, b in zip(tp, jp)])
    # Step-1 Adam moves every element by ±lr (plus the same weight decay on
    # both sides): the worst case is a near-zero gradient whose sign flips
    # between the two bf16 roundings, a 2*lr difference.
    assert diff.max() <= 2 * lr * (1 + 1e-3)
    # Sign flips are rare: 99% of elements agree to 1% of a step.
    assert np.mean(diff <= 1e-2 * lr) >= 0.99


def test_adamw_update_matches_jax_on_equal_grads():
    """One update on equal fp32 grads: m, v, step and updates agree to fp32
    rounding (the in-place moment update keeps the JAX operation order)."""
    from repro.optim.adamw import adamw as jax_adamw
    from repro.optim.adamw import global_norm as jax_global_norm

    rng = np.random.default_rng(9)
    params = {"a": rng.standard_normal((4, 8)).astype(np.float32),
              "b": {"c": rng.standard_normal(16).astype(np.float32)}}
    grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32),
                         params)
    jopt = jax_adamw(lr=1e-3)
    jst = jopt.init(params)
    for _ in range(2):
        jup, jst = jopt.update(grads, jst, params)
    topt = adamw(lr=1e-3)
    tparams = state_from_numpy(params, "cpu")
    tst = topt.init(tparams)
    tgrads = state_from_numpy(grads, "cpu")
    for _ in range(2):
        tup, tst = topt.update(tgrads, tst, tparams)
    for a, b in zip(T.leaves(state_to_numpy(tup)), jax.tree_util.tree_leaves(jup)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-9)
    for key in ("m", "v"):
        for a, b in zip(T.leaves(state_to_numpy(tst[key])),
                        jax.tree_util.tree_leaves(jst[key])):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-12)
    assert int(tst["step"]) == int(jst["step"]) == 2
    cg, n = clip_by_global_norm(tgrads, 1.0)
    np.testing.assert_allclose(float(n), float(jax_global_norm(grads)), rtol=1e-6)
    np.testing.assert_allclose(float(global_norm(cg)), 1.0, rtol=1e-5)


def test_entry_points_refuse_to_run_on_cpu_unasked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(get_config("gpt2").reduced())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        state_from_numpy({"a": np.zeros(2, np.float32)})
