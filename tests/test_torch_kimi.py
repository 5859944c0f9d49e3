"""The port's Kimi-K2 (the moe family at top-8 of 16 experts with a shared
expert, attention at head dim 112) against the JAX package's, on the CPU.

Both sides build one small Kimi from their own ``kimi-k2-1t-a32b`` config
with ``dataclasses.replace``: 2 layers, d_model 64, 8 query heads to 1 kv
head (Kimi's group of 8) at head dim 112, 16 experts top-8 of width 32,
one shared expert, vocab 256. ``reduced()`` caps top-k at 2 and the experts
at 4, so it cannot stand in. Params come from the JAX init through
``convert``; tokens from ``np.random.default_rng``. Held: the top-k, the
dispatch indices and keeps, and the (G, E, C, d) scatter buffer equal to
JAX's with ``==`` at k = 8, with planted bf16 ties (the module's "exact in
any order" argument at k = 8); the MoE sublayer and the whole forward
(every call's routing asserted equal first; in bf16 as sets of choices,
``_same_routing``) at ``_tol``, JAX's attention
through the Pallas kernel in interpret mode at hd 112; fp32 gradients at
``_rec_tol``; the loss and an adamw8bit step, and ``_q8`` bit for bit
against JAX run op by op on every leaf shape; prefill and cached decode against
JAX's, its attention through the Pallas kernel (eagerly) and its XLA path;
``chip_smoke.serve_fp32_check`` with the drops counted; the full-size
specs and manifest against ``jax.eval_shape``; the launchers.
"""
import contextlib
import dataclasses
import importlib
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
from repro_torch.models import build_model, moe, transformer

jax_adamw = importlib.import_module("repro.optim.adamw")
torch_adamw = importlib.import_module("repro_torch.optim.adamw")
ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "kimi-k2-1t-a32b"
B, S, DECODE = 2, 32, 4
#: the small Kimi both sides build.
SMALL = dict(n_layers=2, d_model=64, n_heads=8, n_kv_heads=1, head_dim=112,
             n_experts=16, top_k=8, moe_d_ff=32, n_shared_experts=1, vocab=256,
             remat=False)
#: the full-size training state: params, manifest bytes, leaves.
FULL = (1_043_853_440_000, 6_295_770_792_868, 81)
#: After one adamw8bit step, the share of param elements within 1% of lr of
#: JAX's: over all of them (read 98.83%), over those whose JAX gradient is
#: resolved in bf16 (``BF16_RESOLVED``; 97.0% of them, read 99.26%), as
#: tests/test_torch_rwkv6.py holds RWKV-6's, and in each leaf (read 98.1%
#: at the least, ``layers/moe/w2``).
AGREE_ALL, AGREE, LEAF_AGREE = 0.98, 0.99, 0.95
#: bf16's relative precision: a gradient below this share of its leaf's
#: rms lies within the rounding of the bf16 products summed into it.
BF16_RESOLVED = 2.0 ** -8
#: Each leaf's new first moment, dequantized (``(1 - B1)`` times its
#: clipped gradient), against JAX's, relative to the norm of JAX's (read
#: 5.6% at most, the router, where bf16 logits choose among near-tied
#: experts; 3.4% the experts, 2.5% the rest).
B1, MOMENT_RTOL = 0.9, 0.1


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = _load("chip_smoke.py", "chip_smoke")
serve_tests = _load("tests/test_torch_serve.py", "_serve_tests")
TOL = {"float32": cs.tol(torch.float32), "bfloat16": cs.tol(torch.bfloat16)}
REC_TOL = cs.rec_tol(torch.float32)


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
    """Records, per ``_dispatch_indices`` call of ``module``, the group's
    expert choices (T, k) and keeps (T·k,) as numpy arrays."""
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


def _same_routing(tcalls, jcalls, ordered=True):
    """Every call's choices and keeps equal. ``ordered`` False compares
    each token's set of (expert, kept) pairs: in bf16 a layer's input
    rounds at other places in the two packages, which can swap two experts
    whose bf16 router logits tie inside a token's top 8 (the same experts,
    gates and keeps, the products summed in another order)."""
    assert len(tcalls) == len(jcalls) > 0
    for i, ((ti, tk), (ji, jk)) in enumerate(zip(tcalls, jcalls)):
        if not ordered:
            ti, ji = (np.sort(2 * a + k.reshape(a.shape), axis=-1)
                      for a, k in ((ti, tk), (ji, jk)))
            tk = jk = None
        flips = np.flatnonzero((ti != ji).any(-1))
        assert flips.size == 0, (f"call {i}: routing flips at tokens {flips[:8]}: "
                                 f"port {ti[flips[:4]]}, JAX {ji[flips[:4]]}")
        assert np.array_equal(tk, jk), f"call {i}: keeps differ"


def _small(get):
    return dataclasses.replace(get(ARCH), **SMALL)


@pytest.fixture(scope="module")
def setup():
    jmodel = jax_build_model(_small(jax_get_config))
    jstate = jax.jit(jmodel.init_train_state)(jax.random.PRNGKey(1))
    host = jax.tree.map(np.asarray, jstate)
    tmodel = build_model(_small(get_config), device="cpu")
    tokens = np.random.default_rng(5).integers(
        0, SMALL["vocab"], size=(B, S + DECODE + 1)).astype(np.int32)
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
    """The port's copy of the config equals JAX's field for field, and so
    do the small Kimi and the reduced one."""
    a, b = get_config(ARCH), jax_get_config(ARCH)
    assert a.__dict__ == b.__dict__
    assert a.reduced().__dict__ == b.reduced().__dict__
    assert _small(get_config).__dict__ == _small(jax_get_config).__dict__
    assert (a.head_dim, a.n_heads // a.n_kv_heads, a.top_k, a.n_shared_experts) == \
        (112, 8, 8, 1)
    assert a.param_count() == b.param_count() == FULL[0]


def _tied_probs(E, k, rng, n=4096):
    """Softmax of bf16-rounded router logits with exact ties planted at the
    top-k boundary (the k-th and (k+1)-th experts) in a third of the rows
    and inside the top k (the 3rd and 4th) in another third."""
    logits = rng.standard_normal((n, E)).astype(ml_dtypes.bfloat16).astype(np.float32)
    order = np.argsort(-logits, axis=1, kind="stable")
    rows = np.arange(n)
    a, b = rows[:n // 3], rows[n // 3:2 * n // 3]
    logits[a, order[a, k]] = logits[a, order[a, k - 1]]
    logits[b, order[b, 3]] = logits[b, order[b, 2]]
    return torch.softmax(torch.from_numpy(logits), dim=-1).numpy()


@pytest.mark.parametrize("E", [16, 384])
def test_top_8_breaks_ties_as_lax_top_k(E):
    """``moe._top_k`` at k = 8 gives ``lax.top_k``'s values and indices on
    planted exact ties (``==``)."""
    probs = _tied_probs(E, 8, np.random.default_rng(E))
    vals, idx = moe._top_k(torch.from_numpy(probs), 8)
    jvals, jidx = lax.top_k(jnp.asarray(probs), 8)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert np.array_equal(vals.numpy(), np.asarray(jvals))


@pytest.mark.parametrize("T_, E, C", [(512, 16, 320), (1024, 16, 640), (300, 16, 8),
                                      (4096, 384, 112)])
def test_dispatch_indices_at_top_8_match_jax(T_, E, C):
    """Experts, slots and keeps of T·8 pairs equal JAX's (``==``), the
    choices from the tied top-8 above, skewed so that experts overflow."""
    probs = _tied_probs(E, 8, np.random.default_rng(T_ + E), n=T_)
    probs[:, :3] *= 4.0  # experts 0-2 popular: past their capacity
    _, idx = moe._top_k(torch.from_numpy(probs), 8)
    e, p, keep = moe._dispatch_indices(idx, E, C)
    je, jp, jkeep = (np.asarray(a) for a in jax_moe._dispatch_indices(
        jnp.asarray(idx.numpy()), E, C))
    assert e.numel() == T_ * 8
    assert np.array_equal(e.numpy(), je)
    assert np.array_equal(p.numpy(), jp)
    assert np.array_equal(keep.numpy(), jkeep)
    assert 0 < int((~keep).sum()) < keep.numel()


def test_scatter_buffer_at_top_8_equals_jax_bit_for_bit():
    """The (G, E, C, d) dispatch buffer of top-8 choices (tied router
    probabilities, two groups, drops): the port's accumulating
    ``index_put_`` over the 8 choices against JAX's scatter-add, bit for
    bit in bf16: every kept slot gets one token over all 8 choices, every
    dropped pair adds ``0·x`` into slot C-1, so the order of the 8
    accumulations cannot matter."""
    rng = np.random.default_rng(12)
    G, Tg, d, E, k, C = 2, 128, 16, 16, 8, 56
    xg = rng.standard_normal((G, Tg, d)).astype(ml_dtypes.bfloat16)
    probs = _tied_probs(E, k, rng, n=G * Tg).reshape(G, Tg, E)
    probs[..., :2] *= 4.0
    _, idx = moe._top_k(torch.from_numpy(probs), k)
    ep = [moe._dispatch_indices(idx[g], E, C) for g in range(G)]
    ef, pf, kf = (torch.stack([t[i] for t in ep]).reshape(G, Tg, k) for i in range(3))
    assert int((~kf).sum()) > 0
    buf = moe._scatter(torch.from_numpy(xg.astype(np.float32)).bfloat16(), ef.long(),
                       pf.long(), kf, E, C)
    jg = jnp.broadcast_to(jnp.arange(G, dtype=jnp.int32)[:, None], (G, Tg))
    jbuf = jnp.zeros((G, E, C, d), jnp.bfloat16)
    for j in range(k):
        jbuf = jbuf.at[jg, jnp.asarray(ef[:, :, j].numpy()), jnp.asarray(
            pf[:, :, j].numpy())].add(jnp.asarray(xg) * jnp.asarray(
                kf[:, :, j, None].numpy()).astype(jnp.bfloat16), mode="drop")
    assert buf.view(torch.int16).numpy().tobytes() == \
        np.asarray(jbuf).view(np.int16).tobytes()
    # In the reverse order of the choices, the same bits.
    rev = moe._scatter(torch.from_numpy(xg.astype(np.float32)).bfloat16(),
                       ef.long().flip(-1), pf.long().flip(-1), kf.flip(-1), E, C)
    assert torch.equal(rev.view(torch.int16), buf.view(torch.int16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_sublayer_at_top_8_matches_jax(jax_op_by_op, dtype):
    """The MoE sublayer of the small Kimi (top-8 of 16, the shared expert)
    on inputs skewed toward one expert: routing and keeps first (``==``),
    then the output at ``_tol`` of the dtype, the aux at fp32 ``_tol``."""
    jcfg, cfg = _small(jax_get_config), _small(get_config)
    host = jax.tree.map(np.asarray, jax_moe.init_moe(jax.random.PRNGKey(3), jcfg))
    assert "shared" in host and "dense" not in host
    r0 = host["router"][:, 0]
    x = (np.random.default_rng(4).standard_normal((4, 32, cfg.d_model)).astype(np.float32)
         + 3.0 * r0 / np.linalg.norm(r0))
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
    with routing(jax_moe) as jcalls, jax_op_by_op():
        jy, jaux = jax_moe.moe_sublayer(jax.tree.map(jnp.asarray, host), jnp.asarray(x),
                                        jcfg)
    with routing(moe) as tcalls:
        ty, taux = moe.moe_sublayer(state_from_numpy(host, "cpu"),
                                    torch.from_numpy(x.astype(np.float32)).to(
                                        getattr(torch, dtype)), cfg)
    _same_routing(tcalls, jcalls)
    assert tcalls[0][0].shape == (128, 8)
    assert int((~tcalls[0][1]).sum()) > 0  # the drop path runs
    torch.testing.assert_close(ty.float(), torch.from_numpy(np.array(jy, np.float32)),
                               **TOL[dtype])
    torch.testing.assert_close(taux, torch.tensor(float(jaux)), **TOL["float32"])


def test_fp32_forward_matches_jax(setup, jax_op_by_op):
    """The small Kimi's fp32 forward against JAX's, whose attention runs the
    Pallas kernel at hd 112 in interpret mode: every layer's routing first
    (``==``), then the logits and the aux at fp32 ``_tol``. (In bf16 the
    two forwards round at other places: on these tokens 1 of 16,384 logits
    lies 0.0208 from JAX's where bf16 ``_tol`` allows 0.0205, with the
    routing forced to JAX's; bf16 is held on the MoE sublayer and the
    cached path.)"""
    jmodel, host, tmodel, tokens = setup
    toks = tokens[:, :S]
    with routing(jax_moe) as jcalls, jax_op_by_op():
        jl, jaux = jax_transformer.forward(
            jmodel.cfg, jax.tree.map(jnp.asarray, host["params"]), jnp.asarray(toks),
            use_pallas=True, dtype=jnp.float32)
    with routing(moe) as tcalls:
        tl, taux = transformer.forward(tmodel.cfg, state_from_numpy(host["params"], "cpu"),
                                       torch.from_numpy(toks).long(), dtype=torch.float32)
    _same_routing(tcalls, jcalls)
    assert len(tcalls) == tmodel.cfg.n_layers
    torch.testing.assert_close(tl, torch.from_numpy(np.array(jl)), **TOL["float32"])
    torch.testing.assert_close(taux, torch.tensor(float(jaux)), **TOL["float32"])


def test_fp32_gradients_match_jax(setup):
    """fp32 activations on both sides: the loss plus ``AUX_COEF`` times the
    aux at fp32 ``_tol``, every leaf's gradient (attention at hd 112, the
    router, the experts through the top-8 scatter and gather, the shared
    expert) at ``_rec_tol``."""
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
    torch.testing.assert_close(tl.detach(), torch.tensor(float(jl)), **TOL["float32"])
    grads = torch.autograd.grad(tl, live)
    names = ["/".join(p) for p in paths]
    assert "layers/moe/shared/w1" in names and "layers/moe/w1" in names
    for path, a, b in zip(names, jax.tree_util.tree_leaves(jg), grads):
        torch.testing.assert_close(b, torch.from_numpy(np.asarray(a)), **REC_TOL,
                                   msg=lambda m: f"{path}: {m}")


def test_loss_and_adamw8bit_step_match_jax(setup):
    """``Model.loss_fn`` against JAX's at rtol 2e-2 (bf16 activations); one
    adamw8bit train step against the jitted JAX step: loss, aux and
    gradient norm at rtol 2e-2, the new state's paths, shapes and dtypes,
    the params and the new first moments.

    A first Adam step moves each element by ``lr·g/(|g| + eps)`` plus the
    same weight decay on both sides, so an element differs by more than 1%
    of lr only where its gradient's sign flips between the two packages'
    bf16 roundings (2·lr at worst): ``AGREE_ALL``, ``AGREE`` and
    ``LEAF_AGREE`` bound how many. The step is blind to the gradient's
    scale, so the moments hold the clipping and each leaf's gradient:
    ``MOMENT_RTOL`` per leaf, and the global norm of the first moments,
    ``(1 - B1)`` times the clipped gradient norm, on both sides."""
    jmodel, host, tmodel, tokens = setup
    jstate = jax.tree.map(jnp.asarray, host)
    jtot, jm = jmodel.loss_fn(jstate["params"], {"tokens": tokens}, use_pallas=True)
    ttot, tm = tmodel.loss_fn(state_from_numpy(host["params"], "cpu"), {"tokens": tokens})
    for key in ("loss", "aux_loss"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=2e-2)
    jgrads = jax.tree_util.tree_leaves(jax.jit(jax.grad(lambda p: jmodel.loss_fn(
        p, {"tokens": tokens}, use_pallas=True)[0]))(jstate["params"]))
    jnew, jm = jax.jit(jmodel.make_train_step(use_pallas=True))(jstate, {"tokens": tokens})
    tnew, tm = tmodel.make_train_step()(state_from_numpy(host, "cpu"), {"tokens": tokens})
    for key in ("loss", "aux_loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=2e-2)
    assert _tspecs(tnew["opt"]) == _specs(jax.tree.map(np.asarray, jnew["opt"]))
    lr = tmodel.cfg.learning_rate
    jp = jax.tree_util.tree_leaves(jax.tree.map(np.asarray, jnew["params"]))
    paths, tp = zip(*T.flatten_with_paths(state_to_numpy(tnew["params"])))
    diffs = [np.abs(a - b).reshape(-1) for a, b in zip(tp, jp)]
    diff = np.concatenate(diffs)
    resolved = np.concatenate([
        np.abs(g) >= BF16_RESOLVED * np.sqrt(np.mean(np.square(g)))
        for g in (np.asarray(g, np.float32).reshape(-1) for g in jgrads)])
    assert diff.max() <= 2 * lr * (1 + 1e-3)
    assert np.mean(diff <= 1e-2 * lr) >= AGREE_ALL
    assert np.mean(resolved) >= 0.9
    assert np.mean(diff[resolved] <= 1e-2 * lr) >= AGREE
    for path, d in zip(paths, diffs):
        assert np.mean(d <= 1e-2 * lr) >= LEAF_AGREE, path
    sq = {"port": 0.0, "JAX": 0.0}
    for path, leaf in zip(paths, tp):
        tq = torch_adamw.at(tnew["opt"]["m"], path)
        jq = torch_adamw.at(jnew["opt"]["m"], path)
        t = torch_adamw._dq8_static(tq["codes"], tq["scale"], leaf.shape).numpy()
        j = np.asarray(jax_adamw._dq8_static(jq["codes"], jq["scale"], leaf.shape))
        assert np.linalg.norm(t - j) <= MOMENT_RTOL * np.linalg.norm(j), path
        sq["port"] += float(np.sum(np.square(t.astype(np.float64))))
        sq["JAX"] += float(np.sum(np.square(j.astype(np.float64))))
    for name, m in (("port", tm), ("JAX", jm)):
        clipped = min(float(m["grad_norm"]), tmodel.cfg.grad_clip)
        np.testing.assert_allclose(np.sqrt(sq[name]), (1 - B1) * clipped, rtol=1e-2,
                                   err_msg=name)


def test_q8_at_every_leaf_shape_matches_jax_op_by_op(setup):
    """adamw8bit's block quantizer ``_q8`` on the small Kimi's new moments
    after a port train step, at each leaf shape (the (L, E, d, ff) expert
    leaves, the shared expert, attention at hd 112, the embeddings): codes
    and scales bit for bit against JAX's run op by op, and the dequantized
    moments equal."""
    _, host, tmodel, tokens = setup
    state = tmodel.init_train_state(torch.Generator().manual_seed(3))
    state, _ = tmodel.make_train_step()(state, {"tokens": tokens})
    n, shapes = 0, set()
    for key in ("m", "v"):
        for path, leaf in T.flatten_with_paths(state["params"]):
            if (key, tuple(leaf.shape)) in shapes:
                continue
            shapes.add((key, tuple(leaf.shape)))
            q = torch_adamw.at(state["opt"][key], path)
            x = torch_adamw._dq8_static(q["codes"], q["scale"], leaf.shape)
            tc, ts = torch_adamw._q8(x)
            with jax.disable_jit():
                jc, js = jax_adamw._q8(jnp.asarray(x.numpy()))
                jx = jax_adamw._dq8_static(jc, js, leaf.shape)
            assert np.array_equal(tc.numpy(), np.asarray(jc)), (key, path)
            assert ts.numpy().tobytes() == np.asarray(js).tobytes(), (key, path)
            assert x.numpy().tobytes() == np.asarray(jx).tobytes(), (key, path)
            n += int(bool(x.abs().max() > 0))
    assert n == len(shapes) >= 2 * 8


@pytest.mark.parametrize("dtype, use_pallas", [("float32", True), ("bfloat16", False)])
def test_prefill_and_cached_decode_match_jax(setup, jax_op_by_op, dtype, use_pallas):
    """Prefill into a cache of S + ``DECODE`` rows and ``DECODE``
    teacher-forced decode steps, each against JAX's cached forward on its
    own cache (eagerly; in fp32 its attention at hd 112 through the Pallas
    kernel in interpret mode, in bf16 its XLA path with fp32
    probabilities): the routing of every call first (in bf16 as sets,
    ``_same_routing``), then each call's logits at ``_tol`` of the dtype,
    and the caches at the end."""
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
                cache_pos=jnp.asarray(pos, jnp.int32), use_pallas=use_pallas,
                last_only=True, dtype=jdt)
        with routing(moe) as tcalls:
            tl, tcache, _ = transformer.forward(
                cfg, tparams, torch.from_numpy(toks).long(), cache=tcache,
                cache_pos=pos, last_only=True, dtype=tdt)
        _same_routing(tcalls, jcalls, ordered=dtype == "float32")
        torch.testing.assert_close(tl.float(), torch.from_numpy(
            np.array(jl, np.float32)), **TOL[dtype], msg=lambda m: f"pos {pos}: {m}")
        pos, n = pos + n, 1
    for key in ("k", "v"):
        assert tuple(tcache[key].shape) == (2, B, S + DECODE, 1, 112)
        torch.testing.assert_close(tcache[key].float(), torch.from_numpy(
            np.array(jcache[key], np.float32)), **TOL[dtype])


def test_serve_fp32_check_counts_drops(setup):
    """``chip_smoke.serve_fp32_check`` on the small Kimi: cached against
    cache-free fp32 at ``serve_tol`` on the rows that drop nothing, with
    the dropped pairs counted on both sides; a decode step (2 tokens,
    capacity 8) never drops. The planted faults fail on the rows held."""
    _, host, tmodel, tokens = setup
    params = state_from_numpy(host["params"], "cpu")
    toks = torch.from_numpy(tokens).long()
    out = cs.serve_fp32_check(tmodel.cfg, params, toks, S, S + DECODE + 1)
    assert out["outside"] == 0 and out["rows_compared"] >= 1
    assert out["rows_compared"] + out["rows_left_out"] == B
    assert set(out["faults"]) == set(cs.serve_faults(tmodel.cfg)) != set()
    assert all(f["outside"] > 0 for f in out["faults"].values())


def test_full_size_specs_and_manifest_match_jax():
    """The full-size state on the meta device against ``jax.eval_shape``
    path for path, and the replication manifest against JAX's
    ``build_manifest`` (zero-stride numpy views hold no memory)."""
    jmodel = jax_build_model(jax_get_config(ARCH))
    model = build_model(get_config(ARCH), device="cpu")
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


def test_card_cut_keeps_every_width():
    """``chip_smoke.kimi_cut`` keeps every width of the config and cuts
    only depth and experts, to more than 8 experts, so that top-8 routing
    chooses."""
    full = get_config(ARCH)
    for n_layers in (None, cs.KIMI_SERVE_LAYERS):
        cut = cs.kimi_cut(n_layers)
        changed = {k for k in full.__dict__ if full.__dict__[k] != cut.__dict__[k]}
        assert changed == {"n_layers", "n_experts"}
        assert cut.n_experts > cut.top_k == 8


def test_launchers_take_kimi(capsys):
    """``repro_torch.launch.train --arch kimi-k2-1t-a32b`` trains the
    reduced config on the CPU (``TRAIN_OK``) and ``launch.serve`` answers
    a request (``SERVE_OK``)."""
    from repro_torch.launch import serve, train

    assert train.main(["--arch", ARCH, "--steps", "2", "--batch", "2", "--seq", "16",
                       "--device", "cpu"]) == 0
    assert capsys.readouterr().out.rstrip().endswith("TRAIN_OK")
    assert serve.main(["--arch", ARCH, "--requests", "1", "--batch", "2",
                       "--prompt-len", "8", "--tokens", "4", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.rstrip().endswith("SERVE_OK")
