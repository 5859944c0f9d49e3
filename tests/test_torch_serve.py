"""The port's serving path against the JAX package's, on the CPU.

Reduced GPT-2, TinyLlama, granite-34b, llama3-405b and gemma2-27b (dense,
KV cache; gemma2's local and global layers alternate, and its window of 8
binds over these 28 positions), RWKV-6 (ssm, recurrent state) and Zamba2
(hybrid: a KV cache per application of the shared block, and each Mamba2
block's conv and SSM states), and Zamba2 at 5 blocks (``THREE_APPS``: the
reduced config applies its shared block once, so only here can the
applications' caches be told apart): both sides start from the same
params (the port's init, seeded, carried to JAX through numpy) and see the
same tokens, drawn from ``np.random.default_rng``. The tolerances are
tests/test_kernels.py's, taken from ``chip_smoke.tol`` and
``chip_smoke.rec_tol``: bf16 ``_tol`` for logits and bf16 caches and
states, ``_rec_tol`` for the fp32 WKV and SSM states;
``chip_smoke.serve_tol`` for cached against cache-free logits in one
package (``_tol`` for the dense family, ``_rec_tol`` for RWKV-6 and
Zamba2). The JAX side runs with ``use_pallas`` False and True, except for
gemma2: JAX scans its per-layer local flag as a traced value, which
``repro/kernels/ops.py`` refuses on the Pallas path, so gemma2 is held to
JAX's XLA path only.

The JAX side of a bf16 comparison runs op by op (``jax.disable_jit``), with
bf16 ``sigmoid``, tanh-``gelu`` and ``silu`` evaluated in fp32 and rounded
once, as torch evaluates them (``jax_op_by_op``). ``jax.nn.silu`` is ``x ·
sigmoid(x)`` with two bf16 roundings, and it calls its module's own
``sigmoid``, so patching ``jax.nn.sigmoid`` does not reach it: on the CPU
it differs from torch's ``silu`` by one unit in the last place on many
bf16 inputs, and Zamba2 calls it twice a Mamba2 block. Compiled, the JAX forward's
``lax.scan`` body lets XLA keep fused bf16 elementwise chains in fp32, and
XLA's CPU backend evaluates bf16 ``sigmoid`` and ``gelu`` with bf16
intermediates, off the correctly rounded value for a third of bf16 inputs
when this was written (ROADMAP Queue 3). Each
such rounding moves a bf16 residual by one unit in the last place, which
the next layer norm amplifies: the compiled reference and the port then
differ by up to 0.07 in the reduced RWKV-6's logits, in the training
forward as much as in serving. Op by op, the two agree bit for bit on
RWKV-6 and on GPT-2 with Pallas. JAX's XLA attention (``use_pallas``
False) rounds its probabilities to bf16 before P·V, where its Pallas
kernel and the port's attention keep them in fp32; over the reduced
TinyLlama's and llama3's depth that one rounding moves a few bf16 logits
past ``_tol`` (``test_xla_attention_probability_cast_is_the_difference``),
so ``jax_op_by_op`` also runs that attention with fp32 probabilities
(``_probabilities_in_fp32``) and nothing else changed.
"""
import contextlib
import dataclasses
import importlib.util
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import layers as JL
from repro.models import mamba2 as jax_mamba2
from repro.models import rwkv6 as jax_rwkv6
from repro.models import transformer as jax_transformer
from repro.models import zamba2 as jax_zamba2
from repro_torch import tree as T
from repro_torch.configs import ShapeCell, get_config
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.kernels import wkv6 as W
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models import mamba2, rwkv6, zamba2

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("gpt2", "rwkv6-1.6b", "zamba2-1.2b", "tinyllama-1.1b", "granite-34b",
         "llama3-405b", "gemma2-27b")
#: the reduced Zamba2 at 5 blocks: 3 applications of the shared block and a
#: ragged last segment (2 + 2 + 1), as the full config's 38 blocks every 6.
THREE_APPS = "zamba2-1.2b, 5 blocks"
CASES = ARCHS + (THREE_APPS,)
#: (case, use_pallas) of the parity tests: both paths, gemma2 XLA only.
PALLAS_CASES = [(c, p) for c in CASES for p in (False, True)
                if not (p and c == "gemma2-27b")]
PALLAS_IDS = [f"{c}-{p}" for c, p in PALLAS_CASES]
B, S, DECODE = 2, 24, 4


def _load(rel):
    """The module at ``rel`` under the repository root, by its path."""
    spec = importlib.util.spec_from_file_location(pathlib.Path(rel).stem, ROOT / rel)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = _load("chip_smoke.py")
BF16, F32 = cs.tol(torch.bfloat16), cs.rec_tol(torch.float32)
#: the fp32 recurrent states, held at ``_rec_tol``.
FP32_STATES = ("wkv", "mamba/h")


def _reduced(case, get_config):
    """The reduced config of ``case`` from either package's ``get_config``."""
    if case == THREE_APPS:
        return dataclasses.replace(get_config("zamba2-1.2b").reduced(), n_layers=5)
    return get_config(case).reduced()


def _rounded_once(fn):
    """``fn`` on a bf16 input evaluated in fp32 and rounded to bf16 once."""
    def once(x, *args, **kwargs):
        if x.dtype == jnp.bfloat16:
            return fn(x.astype(jnp.float32), *args, **kwargs).astype(x.dtype)
        return fn(x, *args, **kwargs)
    return once


def _probabilities_in_fp32(attention):
    """JAX's ``blocked_attention`` whose XLA path keeps the probabilities in
    fp32 for P·V: a bf16 ``q`` is handed over in fp32 (exact; the path
    scales and multiplies it in fp32 anyway), so the cast of the
    probabilities to ``q.dtype`` keeps fp32, and the output is rounded to
    bf16 once, as the path rounds it. The Pallas path is left as it is."""
    def fp32_probabilities(q, k, v, spec, *, use_pallas=False, **kw):
        if use_pallas or q.dtype != jnp.bfloat16:
            return attention(q, k, v, spec, use_pallas=use_pallas, **kw)
        return attention(q.astype(jnp.float32), k, v, spec, **kw).astype(q.dtype)
    return fp32_probabilities


@pytest.fixture
def jax_op_by_op(monkeypatch):
    """A context that runs the JAX package op by op, with bf16 ``sigmoid``,
    ``gelu`` and ``silu`` rounded once and the XLA attention's
    probabilities kept in fp32 (see the module's docstring)."""
    monkeypatch.setattr(jax.nn, "sigmoid", _rounded_once(jax.nn.sigmoid))
    monkeypatch.setattr(jax.nn, "gelu", _rounded_once(jax.nn.gelu))
    monkeypatch.setattr(jax.nn, "silu", _rounded_once(jax.nn.silu))
    monkeypatch.setattr(JL, "blocked_attention",
                        _probabilities_in_fp32(JL.blocked_attention))
    return jax.disable_jit


@pytest.fixture(scope="module")
def setup(request):
    """Both packages' models on the same params (the port's init, seeded,
    carried to JAX through numpy) and the same tokens."""
    case = request.param
    jmodel = jax_build_model(_reduced(case, jax_get_config))
    tmodel = build_model(_reduced(case, get_config), device="cpu")
    tparams = tmodel.init(torch.Generator().manual_seed(1))
    jparams = jax.tree.map(jnp.asarray, state_to_numpy(tparams))
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, tmodel.cfg.vocab, size=(B, S + DECODE)).astype(np.int32)
    return jmodel, jparams, tmodel, tparams, tokens


def _close(got, want, path=""):
    """A port tensor against a JAX array: bf16 ``_tol``, or ``_rec_tol``
    for the fp32 WKV and SSM states."""
    want = np.asarray(want)
    tol = F32 if path in FP32_STATES else BF16
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype), path
    torch.testing.assert_close(got.float(), torch.from_numpy(want.astype(np.float32)),
                               **tol, msg=lambda m: f"{path}: {m}")


def _close_tree(got, want):
    for path, leaf in T.flatten_with_paths(got):
        node = want
        for key in path:
            node = node[key]
        _close(leaf, node, "/".join(path))


def _jax(tree):
    """A port tensor, or a tree of them, as JAX arrays."""
    if isinstance(tree, torch.Tensor):
        return jnp.asarray(state_to_numpy({"x": tree})["x"])
    return jax.tree.map(jnp.asarray, state_to_numpy(tree))


@contextlib.contextmanager
def _module_parity(cfg, jcfg, op_by_op, on=True):
    """For the hybrid family (and ``on``): every Mamba2 block and every application of
    the shared block that the port runs meanwhile is run again by the JAX
    package (op by op, through its kernels: Pallas in interpret mode) on the
    same inputs — params, activations, state or KV cache as the port's
    module received them — and its output and new state held to the
    port's: outputs, KV caches and conv state at bf16 ``_tol``, the SSM
    state at ``_rec_tol``. Yields the list of modules checked. Other
    families, or not ``on``: nothing. (The tests turn it on in their
    ``use_pallas`` runs only: the port's side is the same in both.)

    Why module by module: end to end, the two packages' bf16 paths round
    differently now and then, and Zamba2's depth carries one such rounding
    into its states beyond bf16 ``_tol`` while the logits stay within it:
    torch's and XLA's bf16 GEMMs on the CPU sum in different orders, so an
    output of a projection now and then rounds one unit apart, and the
    SSD's fp32 sums differ in order before y is rounded to bf16. Why through the JAX
    kernels: the port always computes their arithmetic, and the JAX XLA
    attention rounds its probabilities to bf16 first, which moves the
    shared block's bf16 output by one unit in the last place of its
    residual sum where that sum nearly cancels."""
    if cfg.family != "hybrid" or not on:
        yield []
        return
    checked = []
    block, shared = mamba2.block_apply, zamba2._shared_apply

    def block_parity(lp, x, cfg_, state=None):
        out, new = block(lp, x, cfg_, state)
        with op_by_op():
            jout, jnew = jax_mamba2.block_apply(_jax(lp), _jax(x), jcfg,
                                                state=_jax(state), use_pallas=True)
        _close(out, jout, "mamba2 block output")
        _close_tree({"mamba": new}, {"mamba": jnew})
        checked.append("mamba2")
        return out, new

    def shared_parity(sp, x, x0, cfg_, positions, cache_kv=None, cache_pos=None):
        before = _jax({"k": cache_kv[0], "v": cache_kv[1]})
        out = shared(sp, x, x0, cfg_, positions, cache_kv, cache_pos)
        with op_by_op():
            jout, (jk, jv) = jax_zamba2._shared_apply(
                _jax(sp), _jax(x), _jax(x0), jcfg, _jax(positions),
                cache_kv=(before["k"], before["v"]),
                cache_pos=jnp.asarray(cache_pos, jnp.int32), use_pallas=True)
        _close(out, jout, "shared block output")
        _close(cache_kv[0], jk, "attn_k")
        _close(cache_kv[1], jv, "attn_v")
        checked.append("shared")
        return out

    mamba2.block_apply, zamba2._shared_apply = block_parity, shared_parity
    try:
        yield checked
    finally:
        mamba2.block_apply, zamba2._shared_apply = block, shared


def _state_matches(got, want, family):
    """The port's cache or state against the JAX package's: every leaf at
    its tolerance; for the hybrid family (held module by module, see
    ``_module_parity``) the same paths, shapes and dtypes, and ``pos``."""
    if family != "hybrid":
        _close_tree(got, want)
        return
    jleaves = dict(("/".join(str(k.key) for k in path), leaf) for path, leaf
                   in jax.tree_util.tree_flatten_with_path(want)[0])
    tleaves = dict(("/".join(path), leaf) for path, leaf in T.flatten_with_paths(got))
    assert list(tleaves) == list(jleaves)
    for path, leaf in tleaves.items():
        assert tuple(leaf.shape) == jleaves[path].shape, path
        assert str(leaf.dtype).removeprefix("torch.") == str(jleaves[path].dtype), path
    assert int(tleaves["pos"]) == int(jleaves["pos"])


def _jax_prefill(jmodel, jparams, prompts, max_len, use_pallas):
    """The JAX package's prefill into a cache of ``max_len`` positions, as
    its serving launcher runs it for the dense family (its ``Model.prefill``
    sizes the cache at the prompt); the ssm state has no length."""
    cfg = jmodel.cfg
    if cfg.family == "ssm":
        return jmodel.prefill(jparams, {"tokens": prompts}, use_pallas=use_pallas)
    if cfg.family == "hybrid":
        logits, state, _ = jax_zamba2.forward(
            cfg, jparams, prompts, state=jax_zamba2.make_state(cfg, B, max_len),
            use_pallas=use_pallas, last_only=True)
        return logits, state
    logits, cache, _ = jax_transformer.forward(
        cfg, jparams, prompts, cache=jax_transformer.make_cache(cfg, B, max_len),
        cache_pos=jnp.zeros((), jnp.int32), use_pallas=use_pallas, last_only=True)
    return logits, cache


@pytest.mark.parametrize("setup, use_pallas", PALLAS_CASES, indirect=["setup"],
                         ids=PALLAS_IDS)
def test_prefill_matches_jax(setup, jax_op_by_op, use_pallas):
    """(a) ``Model.prefill`` against the JAX ``Model.prefill`` (Pallas in
    interpret mode with ``use_pallas``): logits and the cache or state
    (Zamba2's module by module, ``_module_parity``)."""
    jmodel, jparams, tmodel, tparams, tokens = setup
    cfg = tmodel.cfg
    with jax_op_by_op():
        jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens[:, :S])},
                                use_pallas=use_pallas)
    with _module_parity(cfg, jmodel.cfg, jax_op_by_op, use_pallas) as checked:
        tl, tc = tmodel.prefill(tparams, {"tokens": torch.from_numpy(tokens[:, :S])})
    assert tl.shape == (B, 1, cfg.vocab)
    _close(tl, jl, "logits")
    _state_matches(tc, jc, cfg.family)
    if cfg.family == "hybrid" and use_pallas:
        assert len(checked) == cfg.n_layers + zamba2.n_shared_apps(cfg)


@pytest.mark.parametrize("setup, use_pallas", PALLAS_CASES, indirect=["setup"],
                         ids=PALLAS_IDS)
def test_decode_from_jax_cache_matches_jax(setup, jax_op_by_op, use_pallas):
    """(b) The JAX prefill's cache or state carried into the port, then
    ``DECODE`` teacher-forced ``decode_step``s on both sides, the JAX side
    eagerly (jitted, its Pallas decode raises at ``int(q_offset)``): the
    logits of each step and the cache or state at the end (Zamba2's module
    by module, ``_module_parity``)."""
    jmodel, jparams, tmodel, tparams, tokens = setup
    cfg = tmodel.cfg
    with jax_op_by_op():
        _, jc = _jax_prefill(jmodel, jparams, jnp.asarray(tokens[:, :S]),
                             S + DECODE, use_pallas)
    tc = state_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    for t in range(DECODE):
        tok = tokens[:, S + t:S + t + 1]
        with jax_op_by_op():
            jl, jc = jmodel.decode_step(
                jparams, {"tokens": jnp.asarray(tok),
                          "pos": jnp.asarray(S + t, jnp.int32), "cache": jc},
                use_pallas=use_pallas)
        with _module_parity(cfg, jmodel.cfg, jax_op_by_op, use_pallas) as checked:
            tl, tc = tmodel.decode_step(tparams, {"tokens": torch.from_numpy(tok),
                                                  "pos": S + t, "cache": tc})
        _close(tl, jl, f"logits, step {t}")
        if cfg.family == "hybrid" and use_pallas:
            assert len(checked) == cfg.n_layers + zamba2.n_shared_apps(cfg)
    _state_matches(tc, jc, cfg.family)


@pytest.mark.parametrize("case", CASES)
def test_fp32_cached_matches_cache_free(case):
    """(c) In the port, fp32 prefill + teacher-forced decode against the
    cache-free fp32 forward at every position, within ``serve_tol``; each
    of the family's planted faults leaves that tolerance."""
    cfg = _reduced(case, get_config)
    params = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, size=(B, S + DECODE)))
    out = cs.serve_fp32_check(cfg, params, toks, S, S + DECODE + 3)
    assert out["outside"] == 0 and out["n_logits"] == B * (DECODE + 1) * cfg.vocab
    assert out["tolerance"] == cs.serve_tol(cfg, torch.float32)
    assert set(out["faults"]) == set(cs.serve_faults(cfg))
    assert all(f["outside"] > 0 for f in out["faults"].values())


@pytest.mark.parametrize("case, fault", [
    (c, f) for c in CASES for f in cs.serve_faults(_reduced(c, get_config))])
def test_fp32_check_fails_on_a_planted_fault(case, fault):
    """(c) The check itself raises when the fault is planted around it."""
    cfg = _reduced(case, get_config)
    params = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, size=(B, S + DECODE)))
    with cs.planted_fault(fault):
        with pytest.raises(AssertionError, match="differ from the cache-free"):
            cs.serve_fp32_check(cfg, params, toks, S, S + DECODE + 3)


def test_xla_attention_probability_cast_is_the_difference(monkeypatch):
    """Why ``jax_op_by_op`` keeps the XLA attention's probabilities in
    fp32: reduced TinyLlama's bf16 prefill logits through JAX's XLA path
    leave bf16 ``_tol`` of the port's on some logits as the path stands,
    and are within it with that one cast undone; the Pallas path (whose
    kernel keeps them in fp32) is within it as it stands."""
    cfg = get_config("tinyllama-1.1b").reduced()
    jmodel = jax_build_model(jax_get_config("tinyllama-1.1b").reduced())
    tmodel = build_model(cfg, device="cpu")
    tparams = tmodel.init(torch.Generator().manual_seed(1))
    jparams = jax.tree.map(jnp.asarray, state_to_numpy(tparams))
    prompts = np.random.default_rng(3).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    got, _ = tmodel.prefill(tparams, {"tokens": torch.from_numpy(prompts)})
    got = got.float().numpy()
    monkeypatch.setattr(jax.nn, "silu", _rounded_once(jax.nn.silu))

    def outside(use_pallas):
        with jax.disable_jit():
            want, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompts)},
                                     use_pallas=use_pallas)
        want = np.asarray(want).astype(np.float32)
        return int((np.abs(got - want) > BF16["atol"] + BF16["rtol"] * np.abs(want)).sum())

    as_is, pallas = outside(False), outside(True)
    monkeypatch.setattr(JL, "blocked_attention",
                        _probabilities_in_fp32(JL.blocked_attention))
    assert (as_is, pallas, outside(False)) == (as_is, 0, 0) and as_is > 0


def test_softcap_fault_shows_where_scores_reach_the_cap():
    """Why the reduced gemma2 is not given the planted fault "the attention
    softcap dropped": its random-init scores (spread 0.25) barely reach the
    softcap's curve, so the fault is listed for the full config only
    (``chip_smoke.softcap_shift``). With the query projection scaled by 8
    (scores spread 2) the check sees it on the reduced model too."""
    fault = "the attention softcap dropped"
    cfg = get_config("gemma2-27b").reduced()
    assert fault in cs.serve_faults(get_config("gemma2-27b"))
    assert fault not in cs.serve_faults(cfg)
    params = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    params["layers"]["attn"]["wq"].mul_(8.0)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, size=(B, S + DECODE)))
    cs.serve_fp32_check(cfg, params, toks, S, S + DECODE + 3)
    with cs.planted_fault(fault):
        with pytest.raises(AssertionError, match="differ from the cache-free"):
            cs.serve_fp32_check(cfg, params, toks, S, S + DECODE + 3)


def test_jax_conv_context_cast_would_leave_rec_tol(monkeypatch):
    """Why the port keeps Zamba2's conv context in the forward's dtype: with
    the JAX block's cast of the new context to bf16 reproduced, the fp32
    cached logits leave ``serve_tol`` of the cache-free forward (the cast
    rounds every decode step's context), where the port's pass it."""
    cfg = get_config("zamba2-1.2b").reduced()
    params = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, size=(B, S + DECODE)))
    block = mamba2.block_apply

    def jax_cast(lp, x, cfg_, state=None):
        out, new = block(lp, x, cfg_, state)
        if new is not None:
            new = dict(new, conv=new["conv"].to(torch.bfloat16))
        return out, new

    monkeypatch.setattr(mamba2, "block_apply", jax_cast)
    with pytest.raises(AssertionError, match="differ from the cache-free"):
        cs.serve_fp32_check(cfg, params, toks, S, S + DECODE + 3)


def test_fp32_state_keeps_the_activation_dtype():
    """RWKV-6's carried ``tm_x``/``cm_x`` come back in the forward's dtype,
    not rounded into the bf16 buffers ``make_state`` gives."""
    cfg = get_config("rwkv6-1.6b").reduced()
    params = build_model(cfg, device="cpu").init()
    toks = torch.randint(0, cfg.vocab, (B, 5), generator=torch.Generator().manual_seed(0))
    state = rwkv6.make_state(cfg, B)
    with torch.no_grad():
        _, new, _ = rwkv6.forward(cfg, params, toks, state=state, dtype=torch.float32)
    assert new["tm_x"].dtype == new["cm_x"].dtype == new["wkv"].dtype == torch.float32
    assert state["tm_x"].dtype == torch.bfloat16 and not state["tm_x"].any()


def test_rounded_once_bf16_sigmoid_and_gelu_match_torch():
    """What ``jax_op_by_op`` relies on: on every bf16 value in [-6, 6], a
    bf16 ``sigmoid`` and tanh-``gelu`` evaluated in fp32 and rounded once
    (``_rounded_once``), and torch's, are the correctly rounded value (the
    fp64 function rounded to bf16) nearly always. The count for XLA's own
    CPU bf16 versions, off on about a third of them when this was written,
    is reported in the message, not required."""
    x = np.unique(np.linspace(-6.0, 6.0, 20001).astype(ml_dtypes.bfloat16))
    x64 = x.astype(np.float64)
    truths = {"sigmoid": 1.0 / (1.0 + np.exp(-x64)),
              "gelu": 0.5 * x64 * (1.0 + np.tanh(np.sqrt(2.0 / np.pi)
                                                 * (x64 + 0.044715 * x64 ** 3)))}
    fns = {"sigmoid": (jax.nn.sigmoid, torch.sigmoid),
           "gelu": (lambda a: jax.nn.gelu(a, approximate=True),
                    lambda a: torch.nn.functional.gelu(a, approximate="tanh"))}
    tx = torch.from_numpy(x64.astype(np.float32)).to(torch.bfloat16)
    for name, (jfn, tfn) in fns.items():
        truth = truths[name].astype(ml_dtypes.bfloat16)
        off_jax = int((np.asarray(jfn(jnp.asarray(x))) != truth).sum())
        off_once = int((np.asarray(_rounded_once(jfn)(jnp.asarray(x))) != truth).sum())
        off_torch = int((state_to_numpy({"y": tfn(tx)})["y"] != truth).sum())
        assert off_once < len(x) // 20 and off_torch < len(x) // 20, \
            (name, f"rounded once {off_once}, torch {off_torch}, XLA's own "
             f"{off_jax} off of {len(x)}")


def test_rounded_once_bf16_silu_equals_torch():
    """What ``jax_op_by_op`` relies on for Zamba2: on every bf16 value in
    [-20, 20], ``jax.nn.silu`` evaluated in fp32 and rounded once
    (``_rounded_once``) equals torch's bf16 ``silu`` bit for bit."""
    x = np.unique(np.linspace(-20.0, 20.0, 100001).astype(ml_dtypes.bfloat16))
    once = np.asarray(_rounded_once(jax.nn.silu)(jnp.asarray(x)))
    tx = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    got = state_to_numpy({"y": torch.nn.functional.silu(tx)})["y"]
    assert once.dtype == got.dtype == ml_dtypes.bfloat16
    assert np.array_equal(once.view(np.uint16), got.view(np.uint16))


def test_decode_past_the_cache_raises():
    """(d) A dense decode at ``pos = max_len`` raises in the port."""
    cfg = get_config("gpt2").reduced()
    model = build_model(cfg, device="cpu")
    params = model.init()
    prompts = torch.randint(0, cfg.vocab, (B, 8), generator=torch.Generator().manual_seed(0))
    logits, cache = model.prefill(params, {"tokens": prompts}, max_len=10)
    tok = logits.argmax(-1)
    for pos in (8, 9):
        logits, cache = model.decode_step(params, {"tokens": tok, "pos": pos,
                                                   "cache": cache})
    with pytest.raises(ValueError, match="KV cache overflow"):
        model.decode_step(params, {"tokens": tok, "pos": 10, "cache": cache})
    with pytest.raises(ValueError, match="KV cache overflow"):
        model.prefill(params, {"tokens": prompts}, max_len=7)


def test_jax_reference_clamps_a_decode_past_the_cache():
    """(d) The JAX reference decodes at ``pos = max_len`` with no error:
    ``lax.dynamic_update_slice_in_dim`` clamps the start, so the step's K/V
    overwrite the cache's last row (a reference fault, ROADMAP Queue 3)."""
    jcfg = jax_get_config("gpt2").reduced()
    jmodel = jax_build_model(jcfg)
    jparams = jax.tree.map(jnp.asarray, state_to_numpy(
        build_model(get_config("gpt2").reduced(), device="cpu").init()))
    prompts = jnp.asarray(np.random.default_rng(0).integers(0, jcfg.vocab, (B, 8)),
                          jnp.int32)
    _, cache = jmodel.prefill(jparams, {"tokens": prompts})  # cache sized 8
    before = np.asarray(cache["k"])
    _, after = jmodel.decode_step(jparams, {"tokens": prompts[:, :1],
                                            "pos": jnp.asarray(8, jnp.int32),
                                            "cache": cache})
    after = np.asarray(after["k"])
    assert after.shape == before.shape
    np.testing.assert_array_equal(after[:, :, :7], before[:, :, :7])
    assert not np.array_equal(after[:, :, 7], before[:, :, 7])


def test_jax_vlm_decode_at_s_plus_t_overwrites_a_prefilled_row():
    """(d) The JAX serving launcher decodes the vlm family at ``pos = S +
    t`` (``repro/launch/serve.py``), where its prefill wrote rows ``0 …
    n_patches + S - 1``: on reduced PaliGemma (fp32, the XLA path) the
    first step overwrites the K/V of a prefilled row, and the steps'
    logits leave fp32 ``_tol`` of the cache-free forward over patches and
    tokens, where decoding at ``n_patches + S + t`` (the port's position)
    stays within it (a reference fault, ROADMAP Queue 3)."""
    jcfg = jax_get_config("paligemma-3b").reduced()
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(3))
    rng = np.random.default_rng(8)
    toks = rng.integers(0, jcfg.vocab, (B, S + DECODE)).astype(np.int32)
    patches = jnp.asarray(0.02 * rng.standard_normal((B, jcfg.n_patches, jcfg.d_model)),
                          jnp.float32)
    f32, P = jnp.float32, jcfg.n_patches
    want, _ = jax_transformer.forward(jcfg, jparams, jnp.asarray(toks),
                                      patch_embeds=patches, dtype=f32)
    want = np.asarray(want)[:, S:]

    def served(decode_at):
        cache = jax_transformer.make_cache(jcfg, B, S + DECODE, f32, prefix=P)
        _, cache, _ = jax_transformer.forward(
            jcfg, jparams, jnp.asarray(toks[:, :S]), patch_embeds=patches,
            cache=cache, cache_pos=jnp.zeros((), jnp.int32), dtype=f32)
        prefilled = np.asarray(cache["k"])
        out = []
        for t in range(DECODE):
            logits, cache, _ = jax_transformer.forward(
                jcfg, jparams, jnp.asarray(toks[:, S + t:S + t + 1]), cache=cache,
                cache_pos=jnp.asarray(decode_at(t), jnp.int32), dtype=f32)
            out.append(np.asarray(logits)[:, 0])
            if t == 0:
                first = np.asarray(cache["k"])
        return np.stack(out, axis=1), prefilled, first

    t32 = cs.tol(torch.float32)
    got, _, _ = served(lambda t: P + S + t)
    np.testing.assert_allclose(got, want, **t32)
    got, prefilled, first = served(lambda t: S + t)  # the JAX launcher's
    assert S < P + S  # row S holds the prompt's token S - n_patches
    assert np.abs(prefilled[:, :, S]).max() > 0
    assert not np.array_equal(first[:, :, S], prefilled[:, :, S])
    outside = np.abs(got - want) > t32["atol"] + t32["rtol"] * np.abs(want)
    assert outside.sum() > 0


def test_jax_elastic_launcher_passes_tokens_only():
    """(d) The JAX launcher's elastic loop hands ``ElasticTrainer.step``
    the tokens alone (``repro/launch/train.py``), so PaliGemma's loss fails
    on the missing patches (a reference fault, ROADMAP Queue 3); the port's
    elastic loop passes them (tests/test_torch_vlm.py)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-m", "repro.launch.train", "--arch",
                          "paligemma-3b", "--elastic", "--steps", "3"],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0
    assert "KeyError: 'patches'" in out.stderr


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_specs_match_jax(arch):
    """(e) Full-size ``cache_specs`` and the decode cell's ``input_specs``
    on the meta device: the JAX package's shapes and dtypes."""
    jmodel = jax_build_model(jax_get_config(arch))
    tmodel = build_model(get_config(arch), device="meta")

    def specs(tree, jax_side):
        leaves = (jax.tree_util.tree_flatten_with_path(tree)[0] if jax_side
                  else T.flatten_with_paths(tree))
        out = []
        for path, x in leaves:
            key = "/".join(str(k.key) for k in path) if jax_side else "/".join(path)
            out.append((key, tuple(x.shape), str(x.dtype).removeprefix("torch.")))
        return out

    assert specs(tmodel.cache_specs(8, 1152), False) == specs(jmodel.cache_specs(8, 1152), True)
    cell = ShapeCell("decode_32k", 32_768, 128, "decode")
    got = tmodel.input_specs(cell)
    assert all(leaf.device.type == "meta" for leaf in T.leaves(got))
    assert specs(got, False) == specs(jmodel.input_specs(cell), True)
    prefill = ShapeCell("prefill_32k", 32_768, 32, "prefill")
    assert specs(tmodel.input_specs(prefill), False) == \
        specs(jmodel.input_specs(prefill), True)


def test_wkv6_decode_matches_jax_and_the_chunked_form():
    """(f) ``wkv6_decode`` against the JAX ``wkv6_decode`` and the plain
    chunked form at S = 1, fp32 ``_rec_tol``, from a nonzero state, with
    decays over ``_decay``'s clip range."""
    rng = np.random.default_rng(11)
    Bn, H, hd = 3, 4, 16
    r, k, v = (rng.standard_normal((Bn, H, hd)).astype(np.float32) for _ in range(3))
    lw = np.clip(-np.exp(rng.uniform(-8.0, 3.0, (Bn, H, hd))), -60.0, -1e-6).astype(np.float32)
    u = (0.3 * rng.standard_normal((H, hd))).astype(np.float32)
    st = (0.1 * rng.standard_normal((Bn, H, hd, hd))).astype(np.float32)
    jo, js = jax_rwkv6.wkv6_decode(*(jnp.asarray(a) for a in (r, k, v, lw, u, st)))
    t = [torch.from_numpy(a) for a in (r, k, v, lw, u, st)]
    o, s = rwkv6.wkv6_decode(*t)
    torch.testing.assert_close(o, torch.from_numpy(np.asarray(jo)), **F32)
    torch.testing.assert_close(s, torch.from_numpy(np.asarray(js)), **F32)
    po, ps = W.wkv6_plain(*(x[:, None] for x in t[:4]), t[4], t[5], chunk=64)
    torch.testing.assert_close(o, po[:, 0], **F32)
    torch.testing.assert_close(s, ps, **F32)


def test_convert_round_trips_bf16_bit_for_bit():
    """(g) bf16 leaves (a JAX KV cache, numpy ``ml_dtypes.bfloat16``)
    cross both ways bit for bit, beside fp32 and int32 leaves and 0-d ones."""
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2 ** 16, size=(3, 5, 7), dtype=np.uint16)
    bits[0, 0, :3] = (0x7F80, 0xFF80, 0x7FC1)  # +inf, -inf, a NaN payload
    tree = {"k": bits.view(ml_dtypes.bfloat16),
            "j": np.asarray(jnp.asarray(rng.standard_normal((4, 2)), jnp.bfloat16)),
            "s": np.asarray(jnp.asarray(1.5, jnp.bfloat16)),
            "f": rng.standard_normal((2, 3)).astype(np.float32),
            "i": np.arange(4, dtype=np.int32)}
    got = state_from_numpy(tree, "cpu")
    assert got["k"].dtype == got["j"].dtype == got["s"].dtype == torch.bfloat16
    assert got["s"].shape == ()
    back = state_to_numpy(got)
    for key, a in tree.items():
        assert back[key].dtype == a.dtype and back[key].shape == a.shape
        assert back[key].tobytes() == a.tobytes(), key


def test_serving_entry_points_print_serve_ok(capsys):
    """(h) The launcher, as a module in its own process, and the example on
    the CPU."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "gpt2",
         "--device", "cpu"], capture_output=True, text=True, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.rstrip().endswith("SERVE_OK")
    assert _load("examples/torch_serve.py").main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out.rstrip().endswith("SERVE_OK")


def test_zamba2_serving_entry_points_print_serve_ok(capsys):
    """(h) The launcher and the example serve the hybrid family on the CPU."""
    assert serve.main(["--arch", "zamba2-1.2b", "--requests", "1", "--tokens", "4",
                       "--device", "cpu"]) == 0
    assert _load("examples/torch_serve.py").main(
        ["--arch", "zamba2-1.2b", "--tokens", "4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("req 0: ") and out[1] == "SERVE_OK"
    assert out[2].startswith("arch=zamba2-1.2b-reduced") and out[-1] == "SERVE_OK"


def test_serve_launcher_lines(capsys):
    """The launcher's per-request lines, as the JAX launcher prints them."""
    assert serve.main(["--arch", "rwkv6-1.6b", "--requests", "2", "--tokens", "4",
                       "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in lines] == ["req 0", "req 1", "SERVE_OK"]
    assert "decode 4 toks" in lines[0] and "| sample [" in lines[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_streams_or_times_one_window(arch, monkeypatch):
    """``generate`` prefills into a cache of ``S + n_tokens`` positions and
    decodes greedily: with ``stream`` or without, its tokens equal those of
    a prefill and decode loop written out here; only ``stream`` times each
    step."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    prompts = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (B, 8)))
    n = 5
    logits, cache = model.prefill(params, {"tokens": prompts}, max_len=8 + n)
    want = [logits[:, -1:].argmax(-1)]
    for t in range(n - 1):
        logits, cache = model.decode_step(params, {"tokens": want[-1], "pos": 8 + t,
                                                   "cache": cache})
        want.append(logits[:, -1:].argmax(-1))
    want = torch.cat(want, dim=1)
    sizes = []
    prefill = model.prefill
    monkeypatch.setattr(model, "prefill", lambda p, b, *, max_len: (
        sizes.append(max_len), prefill(p, b, max_len=max_len))[1])
    streamed = serve.generate(model, params, prompts, n, stream=True, keep_logits=True)
    window = serve.generate(model, params, prompts, n)
    assert sizes == [8 + n, 8 + n]
    assert torch.equal(streamed.tokens, want) and torch.equal(window.tokens, want)
    assert len(streamed.step_ms) == n - 1 and window.step_ms == []
    assert len(streamed.logits) == n and window.logits is None
    assert window.decode_ms > 0 and streamed.decode_ms >= sum(streamed.step_ms)


def test_serving_entry_points_need_cuda_without_device(monkeypatch):
    """(h) Without ``--device`` they run on CUDA, and raise where there is
    none, for every served arch (Whisper and Kimi among them, now that
    every config is ported); a name no config has exits non-zero."""
    example = _load("examples/torch_serve.py")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (serve.main, example.main):
        for arch in ARCHS + ("whisper-small", "kimi-k2-1t-a32b"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                main(["--arch", arch])
        assert main(["--arch", "no-such-arch", "--device", "cpu"]) != 0

