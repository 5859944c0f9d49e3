"""The port's moe family (Snowflake Arctic) against the JAX package's, on the
CPU.

``repro_torch.models.moe`` is held to ``repro.models.moe``: the capacity,
the dispatch indices and keeps and the tie-broken top-k with ``==``; the
MoE sublayer at one and two groups, with and without the shared expert
and the dense residual, at ``_tol`` in fp32 and 2e-2 in bf16, output and
aux, the routing (each group's expert choices, as both packages hand them
to ``_dispatch_indices``) asserted equal first so that a flipped choice
fails as a flip. The reduced Arctic (2 layers, 4 experts, top-2, moe_d_ff
32, the dense residual) runs on both sides from the same JAX-initialised
state (converted through numpy) and the same tokens, drawn from
``np.random.default_rng``: the forward, fp32 gradients, the loss, one
adamw8bit train step, the prefill and cached decode. The full-size config
is held as shapes on the meta device against ``jax.eval_shape``; the
reduced state's int8 scale-out against JAX's manifest and wire bytes.

JAX's MoE has no Pallas kernel; its attention runs the Pallas kernel in
interpret mode, as tests/test_torch_dense.py runs it. In bf16 the JAX
side runs op by op with ``jax.nn.silu`` rounded once, as
tests/test_torch_serve.py runs it (XLA CPU's bf16 numerics, ROADMAP).
Tolerances are tests/test_kernels.py's, from ``chip_smoke``.
"""
import contextlib
import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax import lax

from repro.configs import get_config as jax_get_config
from repro.core import replication as jrep
from repro.models import build_model as jax_build_model
from repro.models import moe as jax_moe
from repro.models import transformer as jax_transformer
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import replication as trep
from repro_torch.core.sharding_alg import NeighborLink
from repro_torch.elastic import ElasticTrainer
from repro_torch.models import build_model, moe, transformer

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "arctic-480b"
B, S, DECODE = 2, 32, 4
#: the full-size training state: params, manifest bytes, leaves.
FULL = (476_850_275_328, 2_876_004_226_596, 81)


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = _load("chip_smoke.py", "chip_smoke")
serve_tests = _load("tests/test_torch_serve.py", "_serve_tests")
TOL = {"float32": cs.tol(torch.float32), "bfloat16": cs.tol(torch.bfloat16)}


@pytest.fixture
def jax_op_by_op(monkeypatch):
    """JAX op by op, bf16 silu rounded once, the XLA attention's
    probabilities in fp32 (tests/test_torch_serve.py's fixture)."""
    monkeypatch.setattr(jax.nn, "silu", serve_tests._rounded_once(jax.nn.silu))
    monkeypatch.setattr(serve_tests.JL, "blocked_attention",
                        serve_tests._probabilities_in_fp32(
                            serve_tests.JL.blocked_attention))
    return jax.disable_jit


@contextlib.contextmanager
def routing(module):
    """Records, per ``_dispatch_indices`` call of ``module`` (either
    package's moe), the group's expert choices (T, k) and keeps (T·k,) as
    numpy arrays."""
    calls = []
    orig = module._dispatch_indices

    def recorded(idx, E, C):
        e, p, keep = orig(idx, E, C)
        calls.append((np.asarray(idx), np.asarray(keep)))
        return e, p, keep

    module._dispatch_indices = recorded
    try:
        yield calls
    finally:
        module._dispatch_indices = orig


def _same_routing(tcalls, jcalls):
    assert len(tcalls) == len(jcalls) > 0
    for i, ((ti, tk), (ji, jk)) in enumerate(zip(tcalls, jcalls)):
        flips = np.flatnonzero((ti != ji).any(-1))
        assert flips.size == 0, (f"call {i}: routing flips at tokens {flips[:8]}: "
                                 f"port {ti[flips[:4]]}, JAX {ji[flips[:4]]}")
        assert np.array_equal(tk, jk), f"call {i}: keeps differ"


@pytest.fixture(scope="module")
def setup():
    jmodel = jax_build_model(jax_get_config(ARCH).reduced())
    jstate = jmodel.init_train_state(jax.random.PRNGKey(1))
    host = jax.tree.map(np.asarray, jstate)
    tmodel = build_model(get_config(ARCH).reduced(), device="cpu")
    cfg = tmodel.cfg
    assert (cfg.family, cfg.n_layers, cfg.n_experts, cfg.top_k,
            cfg.dense_residual) == ("moe", 2, 4, 2, True)
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab, size=(B, S + DECODE + 1)).astype(np.int32)
    return jmodel, host, tmodel, tokens


def _specs(jtree):
    return [("/".join(str(k.key) for k in p), tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(jtree)[0]]


def _tspecs(ttree):
    return [("/".join(p), tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for p, x in T.flatten_with_paths(ttree)]


def _entries(manifest):
    return [(e.path, tuple(e.shape), e.dtype, e.offset, e.nbytes)
            for e in manifest.entries]


def test_config_equals_jax():
    a, b = get_config(ARCH), jax_get_config(ARCH)
    assert a.__dict__ == b.__dict__
    assert a.reduced().__dict__ == b.reduced().__dict__
    assert a.param_count() == b.param_count() == FULL[0]


@pytest.mark.parametrize("E, k, factor", [(4, 2, 1.25), (8, 2, 1.25), (128, 2, 1.25),
                                          (8, 1, 1.0), (384, 8, 1.25), (16, 4, 2.0)])
def test_capacity_matches_jax(E, k, factor):
    """``_capacity`` equals JAX's for every group size from 1 to 20,000 and
    the sizes the card runs."""
    base = get_config(ARCH).reduced()
    cfg = dataclasses.replace(base, n_experts=E, top_k=k, capacity_factor=factor)
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(), n_experts=E, top_k=k,
                               capacity_factor=factor)
    sizes = list(range(1, 20_001)) + [8 * 1031, 8 * 1152, 12 * 1024, 4 * 4096]
    assert [moe._capacity(t, cfg) for t in sizes] == \
        [jax_moe._capacity(t, jcfg) for t in sizes]


def _dispatch_cases():
    rng = np.random.default_rng(0)
    return {
        "random": (rng.integers(0, 8, (512, 2)), 8, 160),
        "random E 128": (np.stack([rng.permutation(128)[:2] for _ in range(4096)]),
                         128, 80),
        "all on one expert, overflow": (np.zeros((300, 1), np.int64), 4, 40),
        "every token on experts 0 and 1": (np.tile([[1, 0]], (100, 1)), 4, 64),
        "skewed, overflow": (np.minimum(rng.geometric(0.5, (1000, 2)) - 1, 7), 8, 320),
        "capacity 8, one token": (np.array([[3, 5]]), 8, 8),
    }


@pytest.mark.parametrize("case", list(_dispatch_cases()))
def test_dispatch_indices_match_jax(case):
    """Experts, slots and keeps equal JAX's (``==``, int32 and bool), on
    random and adversarial choices: every token on one expert, past its
    capacity."""
    idx, E, C = _dispatch_cases()[case]
    idx = idx.astype(np.int32)
    e, p, keep = moe._dispatch_indices(torch.from_numpy(idx), E, C)
    je, jp, jkeep = (np.asarray(a) for a in jax_moe._dispatch_indices(
        jnp.asarray(idx), E, C))
    assert (e.dtype, p.dtype, keep.dtype) == (torch.int32, torch.int32, torch.bool)
    assert np.array_equal(e.numpy(), je) and je.dtype == np.int32
    assert np.array_equal(p.numpy(), jp) and jp.dtype == np.int32
    assert np.array_equal(keep.numpy(), jkeep)
    if "overflow" in case:
        assert 0 < int((~keep).sum()) == int((~jkeep).sum())


def _tied_probs(E, rng, n=4096):
    """Softmax of router logits rounded to bf16, as ``moe_sublayer`` makes
    them, with exact ties planted at the top-1/top-2 boundary in a third of
    the rows and at the top-2/top-3 boundary in another third."""
    logits = rng.standard_normal((n, E)).astype(ml_dtypes.bfloat16).astype(np.float32)
    order = np.argsort(-logits, axis=1, kind="stable")
    rows = np.arange(n)
    third = n // 3
    a, b = rows[:third], rows[third:2 * third]
    logits[a, order[a, 1]] = logits[a, order[a, 0]]
    logits[b, order[b, 2]] = logits[b, order[b, 1]]
    return torch.softmax(torch.from_numpy(logits), dim=-1).numpy()


@pytest.mark.parametrize("E", [8, 128])
def test_top_k_breaks_ties_as_lax_top_k(E):
    """``moe._top_k`` (a stable descending sort cut at k) gives
    ``lax.top_k``'s values and indices on planted exact ties (``==``); on
    the same input ``torch.topk`` picks another expert set or order on some
    rows, which is why the port does not call it."""
    probs = _tied_probs(E, np.random.default_rng(E))
    vals, idx = moe._top_k(torch.from_numpy(probs), 2)
    jvals, jidx = lax.top_k(jnp.asarray(probs), 2)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert np.array_equal(vals.numpy(), np.asarray(jvals))
    _, tk = torch.topk(torch.from_numpy(probs), 2)
    assert int((tk.numpy() != np.asarray(jidx)).any(-1).sum()) > 0


def _skewed_input(params, rng, shape, dtype):
    """Tokens pushed toward expert 0 (the router's first column) so that
    it overflows: random normals plus 3 units along that column."""
    r0 = params["router"][:, 0]
    x = rng.standard_normal(shape).astype(np.float32) + 3.0 * r0 / np.linalg.norm(r0)
    return x.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else x


SUBLAYER_VARIANTS = {"experts only": dict(dense_residual=False),
                     "shared expert": dict(dense_residual=False, n_shared_experts=1),
                     "dense residual": dict(),
                     "shared and dense": dict(n_shared_experts=1)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", list(SUBLAYER_VARIANTS))
@pytest.mark.parametrize("groups", [1, 2])
def test_moe_sublayer_matches_jax(jax_op_by_op, groups, variant, dtype):
    """``moe_sublayer`` against JAX's on the same params (JAX's
    ``init_moe``) and inputs skewed so that tokens are dropped: the routing
    and keeps first (``==``), then the output at ``_tol`` of the dtype and
    the aux loss at fp32 ``_tol``."""
    kw = SUBLAYER_VARIANTS[variant]
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(), **kw)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), **kw)
    host = jax.tree.map(np.asarray, jax_moe.init_moe(jax.random.PRNGKey(3), jcfg))
    assert ("shared" in host) == bool(cfg.n_shared_experts)
    assert ("dense" in host) == cfg.dense_residual
    x = _skewed_input(host, np.random.default_rng(groups), (4, 32, cfg.d_model), dtype)
    with routing(jax_moe) as jcalls, jax_op_by_op():
        jy, jaux = jax_moe.moe_sublayer(jax.tree.map(jnp.asarray, host),
                                        jnp.asarray(x), jcfg, n_groups=groups)
    with routing(moe) as tcalls:
        ty, taux = moe.moe_sublayer(state_from_numpy(host, "cpu"),
                                    torch.from_numpy(x.astype(np.float32)).to(
                                        getattr(torch, dtype)), cfg, n_groups=groups)
    _same_routing(tcalls, jcalls)
    assert len(tcalls) == groups
    assert sum(int((~k).sum()) for _, k in tcalls) > 0  # the drop path runs
    assert ty.dtype == getattr(torch, dtype) and taux.dtype == torch.float32
    torch.testing.assert_close(ty.float(), torch.from_numpy(np.array(jy, np.float32)),
                               **TOL[dtype])
    torch.testing.assert_close(taux, torch.tensor(float(jaux)), **TOL["float32"])


def test_scatter_buffer_equals_jax_bit_for_bit():
    """The (G, E, C, d) dispatch buffer, with drops: the port's
    ``_scatter`` (an accumulating ``index_put_``) against JAX's scatter-add
    in ``moe_sublayer``, bit for bit in bf16 (``==`` on the bytes)."""
    rng = np.random.default_rng(11)
    G, Tg, d, E, k, C = 2, 96, 16, 4, 2, 40
    xg = rng.standard_normal((G, Tg, d)).astype(ml_dtypes.bfloat16)
    idx = np.minimum(rng.geometric(0.6, (G, Tg, k)) - 1, E - 1).astype(np.int32)
    idx[..., 1] = (idx[..., 0] + 1 + idx[..., 1] % (E - 1)) % E
    ep = [moe._dispatch_indices(torch.from_numpy(idx[g]), E, C) for g in range(G)]
    ef, pf, kf = (torch.stack([t[i] for t in ep]).reshape(G, Tg, k) for i in range(3))
    assert int((~kf).sum()) > 0
    x = torch.from_numpy(xg.astype(np.float32)).bfloat16()
    buf = moe._scatter(x, ef.long(), pf.long(), kf, E, C)
    jg = jnp.broadcast_to(jnp.arange(G, dtype=jnp.int32)[:, None], (G, Tg))
    jbuf = jnp.zeros((G, E, C, d), jnp.bfloat16)
    for j in range(k):
        jbuf = jbuf.at[jg, jnp.asarray(ef[:, :, j].numpy()), jnp.asarray(
            pf[:, :, j].numpy())].add(jnp.asarray(xg) * jnp.asarray(
                kf[:, :, j, None].numpy()).astype(jnp.bfloat16), mode="drop")
    assert buf.view(torch.int16).numpy().tobytes() == \
        np.asarray(jbuf).view(np.int16).tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(setup, jax_op_by_op, dtype):
    """The reduced Arctic's forward against JAX's (Pallas attention,
    interpret mode): every layer's routing first, then the logits at
    ``_tol`` of the dtype and the aux summed over the layers at fp32
    ``_tol``."""
    jmodel, host, tmodel, tokens = setup
    toks = tokens[:, :S]
    with routing(jax_moe) as jcalls, jax_op_by_op():
        jl, jaux = jax_transformer.forward(
            jmodel.cfg, jax.tree.map(jnp.asarray, host["params"]), jnp.asarray(toks),
            use_pallas=True, dtype=getattr(jnp, dtype))
    with routing(moe) as tcalls:
        tl, taux = transformer.forward(tmodel.cfg, state_from_numpy(host["params"], "cpu"),
                                       torch.from_numpy(toks).long(),
                                       dtype=getattr(torch, dtype))
    _same_routing(tcalls, jcalls)
    assert len(tcalls) == tmodel.cfg.n_layers
    torch.testing.assert_close(tl.float(), torch.from_numpy(np.array(jl, np.float32)),
                               **TOL[dtype])
    torch.testing.assert_close(taux, torch.tensor(float(jaux)), **TOL["float32"])
    assert float(taux) > 0.0


def test_fp32_gradients_match_jax(setup):
    """fp32 activations on both sides: the loss plus ``AUX_COEF`` times the
    aux agrees to 1e-5, and every leaf's gradient (router, experts through
    the scatter and gather, dense residual) to 1e-4 of the leaf's norm."""
    from repro.models import layers as JL
    from repro_torch.models import layers as L
    from repro_torch.models.model_api import AUX_COEF

    jmodel, host, tmodel, tokens = setup
    jcfg, cfg = jmodel.cfg, tmodel.cfg

    def jloss(p):
        h, aux = jax_transformer.forward(jcfg, p, tokens[:, :-1], return_hidden=True,
                                         dtype=jnp.float32, use_pallas=True)
        return JL.chunked_cross_entropy(p["embed"], h, tokens[:, 1:], jcfg) \
            + AUX_COEF * aux

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jax.tree.map(jnp.asarray, host["params"]))
    paths, leaves = zip(*T.flatten_with_paths(state_from_numpy(host["params"], "cpu")))
    live = [p.requires_grad_(True) for p in leaves]
    tparams = T.unflatten(paths, live)
    toks = torch.from_numpy(tokens).long()
    h, aux = transformer.forward(cfg, tparams, toks[:, :-1], return_hidden=True,
                                 dtype=torch.float32)
    tl = L.chunked_cross_entropy(tparams["embed"], h, toks[:, 1:], cfg) + AUX_COEF * aux
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    grads = torch.autograd.grad(tl, live)
    assert "layers/moe/w1" in ["/".join(p) for p in paths]
    for path, a, b in zip(paths, jax.tree_util.tree_leaves(jg), grads):
        a = np.asarray(a)
        assert np.linalg.norm(b.numpy() - a) <= 1e-4 * np.linalg.norm(a), path


def test_remat_gives_the_same_loss_aux_and_gradients():
    """Under ``cfg.remat`` the aux comes out of the checkpointed layers:
    the loss, the aux and every gradient equal those without remat."""
    cfg = get_config(ARCH).reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(2))
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (B, S)))
    out = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        paths, leaves = zip(*T.flatten_with_paths(params))
        live = [p.detach().clone().requires_grad_(True) for p in leaves]
        logits, aux = transformer.forward(c, T.unflatten(paths, live), toks)
        tot = logits.float().square().mean() + aux
        out.append((tot.detach(), aux.detach(), torch.autograd.grad(tot, live)))
    (t0, a0, g0), (t1, a1, g1) = out
    assert torch.equal(t0, t1) and torch.equal(a0, a1) and float(a0) > 0
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_loss_and_train_step_match_jax(setup):
    """``Model.loss_fn`` (loss and ``aux_loss``) against JAX's at rtol 2e-2
    (bf16 activations round at other places); one adamw8bit train step
    against the jitted JAX step, held as tests/test_torch_dense.py holds
    the dense family's: every element within 2·lr of JAX's, 99% within
    1% of lr, the new optimizer state with JAX's paths, shapes and
    dtypes."""
    jmodel, host, tmodel, tokens = setup
    jstate = jax.tree.map(jnp.asarray, host)
    jtot, jm = jmodel.loss_fn(jstate["params"], {"tokens": tokens}, use_pallas=True)
    ttot, tm = tmodel.loss_fn(state_from_numpy(host["params"], "cpu"), {"tokens": tokens})
    for key in ("loss", "aux_loss"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=2e-2)
    np.testing.assert_allclose(float(ttot), float(jtot), rtol=2e-2)
    jnew, jm = jax.jit(jmodel.make_train_step(use_pallas=True))(jstate, {"tokens": tokens})
    tnew, tm = tmodel.make_train_step()(state_from_numpy(host, "cpu"), {"tokens": tokens})
    for key in ("loss", "aux_loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=2e-2)
    assert int(tnew["opt"]["step"]) == int(jnew["opt"]["step"]) == 1
    assert _tspecs(tnew["opt"]) == _specs(jax.tree.map(np.asarray, jnew["opt"]))
    lr = tmodel.cfg.learning_rate
    jp = jax.tree_util.tree_leaves(jax.tree.map(np.asarray, jnew["params"]))
    tp = T.leaves(state_to_numpy(tnew["params"]))
    diff = np.concatenate([np.abs(a - b).reshape(-1) for a, b in zip(tp, jp)])
    assert diff.max() <= 2 * lr * (1 + 1e-3)
    assert np.mean(diff <= 1e-2 * lr) >= 0.99


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_cached_decode_match_jax(setup, jax_op_by_op, dtype):
    """Prefill into a cache of S + ``DECODE`` rows and ``DECODE``
    teacher-forced decode steps, each against JAX's ``transformer.forward``
    on its own cache (eagerly, its XLA attention with fp32 probabilities,
    ``jax_op_by_op``): the routing of every call first, then each call's
    logits at ``_tol`` of the dtype, and the caches at the end."""
    jmodel, host, tmodel, tokens = setup
    jcfg, cfg = jmodel.cfg, tmodel.cfg
    jparams = jax.tree.map(jnp.asarray, host["params"])
    tparams = state_from_numpy(host["params"], "cpu")
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jcache = jax_transformer.make_cache(jcfg, B, S + DECODE, dtype=jdt)
    tcache = transformer.make_cache(cfg, B, S + DECODE, dtype=tdt)
    pos, n = 0, S
    while pos < S + DECODE:
        toks = tokens[:, pos:pos + n]
        with routing(jax_moe) as jcalls, jax_op_by_op():
            jl, jcache, _ = jax_transformer.forward(
                jcfg, jparams, jnp.asarray(toks), cache=jcache,
                cache_pos=jnp.asarray(pos, jnp.int32), use_pallas=False,
                last_only=True, dtype=jdt)
        with routing(moe) as tcalls:
            tl, tcache, _ = transformer.forward(
                cfg, tparams, torch.from_numpy(toks).long(), cache=tcache,
                cache_pos=pos, last_only=True, dtype=tdt)
        _same_routing(tcalls, jcalls)
        torch.testing.assert_close(tl.float(), torch.from_numpy(
            np.array(jl, np.float32)), **TOL[dtype], msg=lambda m: f"pos {pos}: {m}")
        pos, n = pos + n, 1
    for key in ("k", "v"):
        torch.testing.assert_close(tcache[key].float(), torch.from_numpy(
            np.array(jcache[key], np.float32)), **TOL[dtype])


def test_serve_fp32_check_counts_drops(setup):
    """``chip_smoke.serve_fp32_check`` on the reduced Arctic: cached against
    cache-free fp32 at ``serve_tol`` on the rows that drop nothing, with the
    dropped pairs counted on both sides. Here the random init routes
    unevenly enough that one of the two rows drops pairs (the prefill's
    capacity is 40 of 64 tokens' 128 pairs over 4 experts): it is left out
    and the other row is held; the planted fault fails on it. At a
    capacity factor of 0.3 every row drops, and the check fails."""
    _, host, tmodel, tokens = setup
    params = state_from_numpy(host["params"], "cpu")
    toks = torch.from_numpy(tokens).long()  # S + DECODE + 1 tokens a row
    out = cs.serve_fp32_check(tmodel.cfg, params, toks, S, S + DECODE + 1)
    assert out["drops"]["cache_free"] + out["drops"]["cached"] > 0
    assert out["outside"] == 0 and out["rows_compared"] == 1 == out["rows_left_out"]
    assert out["n_logits"] == (DECODE + 2) * tmodel.cfg.vocab
    assert set(out["faults"]) == set(cs.serve_faults(tmodel.cfg)) != set()
    assert all(f["outside"] > 0 for f in out["faults"].values())
    tight = dataclasses.replace(tmodel.cfg, capacity_factor=0.3)
    with pytest.raises(AssertionError, match="no row to compare"):
        cs.serve_fp32_check(tight, params, toks, S, S + DECODE + 1)


@pytest.mark.parametrize("arch", [ARCH])
def test_full_size_specs_and_manifest_match_jax(arch):
    """The full-size state on the meta device against ``jax.eval_shape``
    path for path, and the replication manifest against JAX's
    ``build_manifest`` (zero-stride numpy views hold no memory)."""
    jmodel = jax_build_model(jax_get_config(arch))
    model = build_model(get_config(arch), device="cpu")
    params, state = model.param_specs(), model.train_state_specs()
    assert all(leaf.device.type == "meta" for leaf in T.leaves(state))
    assert _tspecs(params) == _specs(jmodel.param_specs())
    jspecs = jmodel.train_state_specs()
    assert _tspecs(state) == _specs(jspecs)
    views = jax.tree.map(lambda s: np.broadcast_to(
        np.zeros((), ml_dtypes.bfloat16 if s.dtype == jnp.bfloat16 else s.dtype),
        s.shape), jspecs)
    manifest = trep.build_manifest(state)
    assert _entries(manifest) == _entries(jrep.build_manifest(views))
    n_params = sum(p.numel() for p in T.leaves(params))
    assert (n_params, manifest.total_bytes, len(manifest.entries)) == FULL


def test_scale_out_matches_jax_manifest_and_wire():
    """The reduced Arctic's adamw8bit state after one JAX step: its manifest
    and int8 wire bytes equal JAX's ``build_manifest`` and
    ``encode_state``; an int8 scale-out of the port's ``ElasticTrainer``
    sends those bytes and leaves the state bit-unchanged."""
    jmodel = jax_build_model(jax_get_config(ARCH).reduced())
    jstate = jmodel.init_train_state(jax.random.PRNGKey(4))
    tokens = np.random.default_rng(7).integers(0, jmodel.cfg.vocab, (2, 33)).astype(np.int32)
    jstate, _ = jax.jit(jmodel.make_train_step())(jstate, {"tokens": tokens})
    host = jax.tree.map(np.asarray, jstate)
    tstate = state_from_numpy(host, "cpu")
    assert tuple(tstate["params"]["layers"]["moe"]["w1"].shape) == (2, 4, 64, 32)
    assert _entries(trep.build_manifest(tstate)) == _entries(jrep.build_manifest(host))
    _, _, jwire = jrep.encode_state(host, "int8", verify_kernel=False)
    _, _, twire = trep.encode_state(tstate, "int8")
    assert twire == jwire
    tr = ElasticTrainer(build_model(get_config(ARCH).reduced(), device="cpu"),
                        initial=2, per_device_batch=1, codec="int8",
                        link_model=lambda i: NeighborLink(0.002, 1 / (500e6 / 8), 0.0))
    tr.init(state=tstate)
    before = [leaf.clone() for leaf in T.leaves(tr.state)]
    ev = tr.scale_out()
    assert ev.plan_summary["codec"]["wire_bytes"] == jwire
    for a, b in zip(before, T.leaves(tr.state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    m = tr.step({"tokens": np.random.default_rng(8).integers(
        0, jmodel.cfg.vocab, (tr.global_batch, 33))})
    assert np.isfinite(m["loss"]) and m["aux_loss"] > 0


def test_launchers_take_arctic(capsys):
    """``repro_torch.launch.train --arch arctic-480b`` trains the reduced
    config on the CPU (``TRAIN_OK``) and ``launch.serve`` answers a
    request (``SERVE_OK``)."""
    from repro_torch.launch import serve, train

    assert train.main(["--arch", ARCH, "--steps", "2", "--batch", "2", "--seq", "16",
                       "--device", "cpu"]) == 0
    assert capsys.readouterr().out.rstrip().endswith("TRAIN_OK")
    assert serve.main(["--arch", ARCH, "--requests", "1", "--batch", "2",
                       "--prompt-len", "8", "--tokens", "4", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.rstrip().endswith("SERVE_OK")
