"""The port's vlm family (PaliGemma) against the JAX package's, on the CPU.

Reduced PaliGemma (2 layers, d_model 64, 4 heads on 1 kv head at head dim
16, 4 patches) runs on both sides from the same JAX-initialised params
(converted through numpy), the same tokens and the same patch embeddings,
drawn from ``np.random.default_rng`` (random, never zeros: an all-zero patch
has a zero norm output, so zero q, k and v, and a wrong prefix mask would
not show). The JAX side runs with ``use_pallas`` False and True (its Pallas
kernel in interpret mode). Tolerances are tests/test_kernels.py's, from
``chip_smoke``: bf16 ``_tol`` for bf16 logits, fp32 ``_tol`` for fp32 ones;
the loss and one train step as tests/test_torch_dense.py holds the dense
family. The bf16 comparisons run the JAX side op by op with its bf16 gelu
rounded once and its XLA attention's probabilities kept in fp32, as
tests/test_torch_serve.py does (``jax_op_by_op`` there).
"""
import importlib.util
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import layers as JL
from repro.models import transformer as jax_transformer
from repro_torch import tree as T
from repro_torch.configs import ShapeCell, get_config
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.elastic import ElasticTrainer
from repro_torch.launch import serve
from repro_torch.models import build_model, transformer

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "paligemma-3b"
B, S, DECODE = 2, 24, 4


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = _load("chip_smoke.py", "chip_smoke")
#: tests/test_torch_serve.py's bf16 helpers for the JAX side.
serve_tests = _load("tests/test_torch_serve.py", "_serve_tests")
BF16, F32 = cs.tol(torch.bfloat16), cs.tol(torch.float32)


@pytest.fixture
def jax_op_by_op(monkeypatch):
    """JAX op by op, bf16 gelu rounded once, the XLA attention's
    probabilities in fp32 (tests/test_torch_serve.py's fixture)."""
    monkeypatch.setattr(jax.nn, "gelu", serve_tests._rounded_once(jax.nn.gelu))
    monkeypatch.setattr(JL, "blocked_attention",
                        serve_tests._probabilities_in_fp32(JL.blocked_attention))
    return jax.disable_jit


@pytest.fixture(scope="module")
def setup():
    jmodel = jax_build_model(jax_get_config(ARCH).reduced())
    jstate = jmodel.init_train_state(jax.random.PRNGKey(1))
    host = jax.tree.map(np.asarray, jstate)
    tmodel = build_model(get_config(ARCH).reduced(), device="cpu")
    cfg = tmodel.cfg
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_patches) == ("vlm", 2, 64, 4)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab, size=(B, S + DECODE + 1)).astype(np.int32)
    patches = (0.02 * rng.standard_normal((B, cfg.n_patches, cfg.d_model))
               ).astype(np.float32)
    return jmodel, jstate, host, tmodel, tokens, patches


def _tparams(host):
    return state_from_numpy(host["params"], "cpu")


def test_config_equals_jax():
    a, b = get_config(ARCH), jax_get_config(ARCH)
    assert a.__dict__ == b.__dict__
    assert a.reduced().__dict__ == b.reduced().__dict__
    assert a.param_count() == b.param_count() == 2_508_662_784


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_matches_jax(setup, jax_op_by_op, use_pallas, dtype):
    """``transformer.forward(patch_embeds=)`` against the JAX forward:
    logits over the text (the patches' rows dropped after the final norm),
    at ``_tol`` of the dtype."""
    jmodel, _, host, tmodel, tokens, patches = setup
    toks = tokens[:, :S]
    with jax_op_by_op():
        jl, _ = jax_transformer.forward(
            jmodel.cfg, jax.tree.map(jnp.asarray, host["params"]), jnp.asarray(toks),
            patch_embeds=jnp.asarray(patches), use_pallas=use_pallas,
            dtype=getattr(jnp, dtype))
    tl, _ = transformer.forward(tmodel.cfg, _tparams(host), torch.from_numpy(toks).long(),
                                patch_embeds=torch.from_numpy(patches),
                                dtype=getattr(torch, dtype))
    assert tl.shape == (B, S, tmodel.cfg.vocab)
    torch.testing.assert_close(tl.float(), torch.from_numpy(np.array(jl, np.float32)),
                               **(BF16 if dtype == "bfloat16" else F32))


def test_prefix_mask_is_on_the_path(setup, monkeypatch):
    """The patches reach the text's logits through the prefix mask: the
    forward with a causal mask over the patches moves the logits past fp32
    ``_tol``, and so do other patches; the planted fault of the cached
    prefill leaves the cache-free forward alone."""
    _, _, host, tmodel, tokens, patches = setup
    cfg, params = tmodel.cfg, _tparams(host)
    toks = torch.from_numpy(tokens[:, :S]).long()

    def logits(p):
        return transformer.forward(cfg, params, toks, patch_embeds=torch.from_numpy(p),
                                   dtype=torch.float32)[0]

    want = logits(patches)
    with cs.planted_fault("causal mask on the cached prefill"):
        assert torch.equal(logits(patches), want)
    assert (logits(patches[::-1].copy()) - want).abs().max() > 100 * F32["atol"]
    spec = transformer.MaskSpec
    monkeypatch.setattr(transformer, "MaskSpec", lambda kind, window, prefix_len:
                        spec("causal", window=window))
    assert (logits(patches) - want).abs().max() > 100 * F32["atol"]


@pytest.mark.parametrize("use_pallas", [False, True])
def test_loss_and_train_step_match_jax(setup, use_pallas):
    """``Model.loss_fn`` with the batch's patches against JAX's (bf16
    activations round at other places: rtol 2e-2), and one train step
    against the jitted JAX step as tests/test_torch_dense.py holds it: the
    gradient norm within 2e-2, every param within 2·lr, 99% within 1% of
    lr."""
    jmodel, jstate, host, tmodel, tokens, patches = setup
    batch = {"tokens": tokens[:, :S + 1], "patches": patches}
    jloss, _ = jmodel.loss_fn(jstate["params"], batch, use_pallas=use_pallas)
    tloss, metrics = tmodel.loss_fn(_tparams(host), batch)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=2e-2)
    assert float(metrics["aux_loss"]) == 0.0
    jnew, jm = jax.jit(jmodel.make_train_step(use_pallas=use_pallas))(jstate, batch)
    tnew, tm = tmodel.make_train_step()(state_from_numpy(host, "cpu"), batch)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=2e-2)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=2e-2)
    lr = tmodel.cfg.learning_rate
    jp = jax.tree_util.tree_leaves(jax.tree.map(np.asarray, jnew["params"]))
    tp = T.leaves(state_to_numpy(tnew["params"]))
    diff = np.concatenate([np.abs(a - b).reshape(-1) for a, b in zip(tp, jp)])
    assert diff.max() <= 2 * lr * (1 + 1e-3)
    assert np.mean(diff <= 1e-2 * lr) >= 0.99


def _jax_serve(jmodel, jparams, tokens, patches, use_pallas, decode_at):
    """JAX prefill of patches + prompt into a cache of ``S + DECODE`` text
    rows behind the patches' (``make_cache(prefix=)``), then ``DECODE``
    forced decode steps, eagerly (jitted, its Pallas decode raises), step
    ``t`` at cache row ``decode_at(t)``. Returns the logits and the
    cache."""
    cfg = jmodel.cfg
    cache = jax_transformer.make_cache(cfg, B, S + DECODE, prefix=cfg.n_patches)
    logits, cache, _ = jax_transformer.forward(
        cfg, jparams, jnp.asarray(tokens[:, :S]), patch_embeds=jnp.asarray(patches),
        cache=cache, cache_pos=jnp.zeros((), jnp.int32), use_pallas=use_pallas,
        last_only=True)
    out = [logits]
    for t in range(DECODE):
        logits, cache = jmodel.decode_step(
            jparams, {"tokens": jnp.asarray(tokens[:, S + t:S + t + 1]),
                      "pos": jnp.asarray(decode_at(t), jnp.int32), "cache": cache},
            use_pallas=use_pallas)
        out.append(logits)
    return out, cache


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_and_decode_match_jax(setup, jax_op_by_op, use_pallas):
    """``Model.prefill`` with patches and ``DECODE`` forced
    ``Model.decode_step``s at row ``n_patches + S + t`` against the JAX
    prefill and decode at the same rows: every step's logits and the cache
    at bf16 ``_tol``; the cache holds ``n_patches + S + DECODE`` rows."""
    jmodel, _, host, tmodel, tokens, patches = setup
    P = tmodel.cfg.n_patches
    with jax_op_by_op():
        jout, jcache = _jax_serve(jmodel, jax.tree.map(jnp.asarray, host["params"]),
                                  tokens, patches, use_pallas, lambda t: P + S + t)
    params = _tparams(host)
    tl, cache = tmodel.prefill(params, {"tokens": torch.from_numpy(tokens[:, :S]),
                                        "patches": torch.from_numpy(patches)},
                               max_len=S + DECODE)
    assert cache["k"].shape[2] == P + S + DECODE
    tout = [tl]
    for t in range(DECODE):
        tl, cache = tmodel.decode_step(params, {
            "tokens": torch.from_numpy(tokens[:, S + t:S + t + 1]),
            "pos": P + S + t, "cache": cache})
        tout.append(tl)
    for t, (a, b) in enumerate(zip(tout, jout)):
        serve_tests._close(a, b, f"logits, step {t}")
    serve_tests._close_tree(cache, jcache)


def test_fp32_cached_matches_cache_free_and_faults_fail(setup):
    """``chip_smoke.serve_fp32_check`` on the reduced model: prefill and
    forced decode steps against the cache-free forward over patches and
    tokens at fp32 ``_tol``; each planted fault leaves it (decoding at the
    JAX launcher's ``S + t``; a causal mask on the cached prefill; the
    cache written one row late) or raises (a cache without the patches'
    rows)."""
    _, _, host, tmodel, tokens, patches = setup
    cfg = tmodel.cfg
    toks = torch.from_numpy(tokens[:, :S + DECODE]).long()
    out = cs.serve_fp32_check(cfg, _tparams(host), toks, S, S + DECODE + 3,
                              patches=torch.from_numpy(patches))
    assert out["tolerance"] == F32 and out["outside"] == 0
    assert set(out["faults"]) == set(cs.SERVE_FAULTS["vlm"]) == set(cs.serve_faults(cfg))
    for fault, f in out["faults"].items():
        if fault in cs.RAISING_FAULTS:
            assert "KV cache overflow" in f["raised"]
        else:
            assert f["outside"] > 0, fault


def test_elastic_trainer_steps_with_patches(setup):
    """``ElasticTrainer.step`` moves every array of the batch and hands the
    whole dict to the step: its loss is ``Model.loss_fn``'s on the same
    batch; a patches array of another row count raises."""
    _, _, host, tmodel, tokens, patches = setup
    batch = {"tokens": tokens[:, :S + 1], "patches": patches}
    want, _ = tmodel.loss_fn(_tparams(host), batch)
    trainer = ElasticTrainer(tmodel, pool_size=2, initial=2, per_device_batch=1)
    trainer.init(state=state_from_numpy(host, "cpu"))
    m = trainer.step(batch)
    assert m["loss"] == pytest.approx(float(want), rel=1e-6)
    with pytest.raises(ValueError, match="patches"):
        trainer.step({"tokens": tokens[:, :S + 1], "patches": patches[:1]})


def test_full_size_specs_match_jax():
    """Full-size params (the tied 257,216 x 2,048 embedding among them),
    ``cache_specs`` (the patches' 256 rows in front) and the train, prefill
    and decode cells' ``input_specs`` on the meta device: the JAX package's
    paths, shapes and dtypes."""
    jmodel = jax_build_model(jax_get_config(ARCH))
    tmodel = build_model(get_config(ARCH), device="meta")

    def specs(tree, jax_side):
        leaves = (jax.tree_util.tree_flatten_with_path(tree)[0] if jax_side
                  else T.flatten_with_paths(tree))
        return [("/".join(str(k.key) for k in p) if jax_side else "/".join(p),
                 tuple(x.shape), str(x.dtype).removeprefix("torch."))
                for p, x in leaves]

    params = tmodel.param_specs()
    assert specs(params, False) == specs(jmodel.param_specs(), True)
    assert tuple(params["embed"]["tok"].shape) == (257_216, 2_048)
    assert "unembed" not in params["embed"]
    assert specs(tmodel.cache_specs(8, 1152), False) == \
        specs(jmodel.cache_specs(8, 1152), True)
    assert tuple(tmodel.cache_specs(8, 1152)["k"].shape) == (18, 8, 1408, 1, 256)
    for cell in (ShapeCell("train_4k", 4096, 256, "train"),
                 ShapeCell("prefill_32k", 32_768, 32, "prefill"),
                 ShapeCell("decode_32k", 32_768, 128, "decode")):
        assert specs(tmodel.input_specs(cell), False) == \
            specs(jmodel.input_specs(cell), True), cell.kind


def test_convert_carries_jax_params_path_for_path(setup):
    """The JAX params, the tied embedding included, cross into the port and
    back bit for bit, path for path."""
    _, _, host, _, _, _ = setup
    back = state_to_numpy(state_from_numpy(host["params"], "cpu"))
    jleaves = jax.tree_util.tree_flatten_with_path(host["params"])[0]
    tleaves = T.flatten_with_paths(back)
    assert [tuple(str(k.key) for k in p) for p, _ in jleaves] == [p for p, _ in tleaves]
    for (_, a), (_, b) in zip(jleaves, tleaves):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")


def test_serve_cli_serves_paligemma():
    """``python -m repro_torch.launch.serve --arch paligemma-3b --device
    cpu`` exits 0 and prints ``SERVE_OK``; so does the example."""
    for cmd in ([sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
                 "--device", "cpu", "--requests", "1"],
                [sys.executable, str(ROOT / "examples" / "torch_serve.py"), "--arch",
                 ARCH, "--device", "cpu", "--tokens", "4"]):
        out = subprocess.run(cmd, capture_output=True, text=True, env=_env(),
                             timeout=120)
        assert out.returncode == 0, out.stderr
        assert "SERVE_OK" in out.stdout


def test_vlm_path_runs_with_jax_and_repro_blocked():
    """With ``jax``, ``repro`` and ``networkx`` unimportable, the port's
    vlm modules import, the elastic launcher trains reduced PaliGemma
    (patches in every step's batch) and ``generate`` serves it."""
    code = """
import sys
sys.modules.update(dict.fromkeys(("jax", "repro", "networkx")))
import torch
from repro_torch.launch import serve, train
from repro_torch.models import build_model
from repro_torch.configs import get_config
assert train.main(["--arch", "paligemma-3b", "--elastic", "--steps", "3",
                   "--device", "cpu"]) == 0
cfg = get_config("paligemma-3b").reduced()
model = build_model(cfg, device="cpu")
run = serve.generate(model, model.init(), torch.zeros((2, 8), dtype=torch.long), 3,
                     patches=torch.randn(2, cfg.n_patches, cfg.d_model) * 0.02)
assert run.tokens.shape == (2, 3)
assert not any(m == "jax" or m.startswith(("jax.", "repro.")) for m in sys.modules
               if sys.modules[m] is not None)
print("VLM_OK")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=_env(), timeout=120)
    assert out.returncode == 0, out.stderr
    assert "VLM_OK" in out.stdout


def test_generate_needs_patches_for_a_vlm():
    model = build_model(get_config(ARCH).reduced(), device="cpu")
    with pytest.raises(ValueError, match="patches"):
        serve.generate(model, model.init(), torch.zeros((1, 4), dtype=torch.long), 2)
