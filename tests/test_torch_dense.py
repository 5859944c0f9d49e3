"""The rest of the dense family in the port against the JAX package's, on
the CPU: TinyLlama 1.1B (swiglu, GQA, RoPE θ 1e4, untied embeddings),
granite-34b (MQA, gelu2, learned positions, layernorm), llama3-405b
(swiglu, RoPE θ 5e5, adamw8bit) and gemma2-27b (geglu, local/global
alternation, softcaps, ``query_scale``, ``post_norm``, ``embed_scale``,
adamw8bit).

The reduced configs run on both sides from the same JAX-initialised state
(converted through numpy) and the same tokens, drawn from
``np.random.default_rng``. The JAX side runs its Pallas kernels (interpret
mode) except for gemma2, whose per-layer local flag is a traced value in
JAX's layer scan, which ``repro/kernels/ops.py`` refuses: gemma2 is held
to JAX's XLA path (``use_pallas=False``). The full-size configs are held
as shapes: the port's specs on the meta device against ``jax.eval_shape``.
Tolerances are stated per check.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import replication as jrep
from repro.models import build_model as jax_build_model
from repro.models import layers as JL
from repro.models import transformer as jax_transformer
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import replication as trep
from repro_torch.core.sharding_alg import NeighborLink
from repro_torch.elastic import ElasticTrainer
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models import transformer

ARCHS = ("tinyllama-1.1b", "granite-34b", "llama3-405b", "gemma2-27b")
SEQ = 64
#: the full-size training state: params, bytes and leaves (params + the
#: optimizer's moments, or codes and scales, and step).
FULL = {"tinyllama-1.1b": (1_100_048_384, 13_200_580_612, 37),
        "granite-34b": (33_862_791_168, 406_353_494_020, 43),
        "llama3-405b": (405_853_388_800, 2_447_803_251_204, 61),
        "gemma2-27b": (27_227_128_320, 164_213_617_684, 66)}


def _use_pallas(arch):
    """JAX's Pallas path, except for gemma2 (see the module's docstring)."""
    return arch != "gemma2-27b"


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    jmodel = jax_build_model(jax_get_config(arch).reduced())
    jstate = jmodel.init_train_state(jax.random.PRNGKey(1))
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, jmodel.cfg.vocab, size=(2, SEQ + 1)).astype(np.int32)
    return arch, jmodel, jstate, tokens


def _specs(jtree):
    return [("/".join(str(k.key) for k in p), tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(jtree)[0]]


def _tspecs(ttree):
    return [("/".join(p), tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for p, x in T.flatten_with_paths(ttree)]


def _entries(manifest):
    return [(e.path, tuple(e.shape), e.dtype, e.offset, e.nbytes)
            for e in manifest.entries]


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_jax(arch):
    a, b = get_config(arch), jax_get_config(arch)
    assert a.__dataclass_fields__.keys() == b.__dataclass_fields__.keys()
    assert a.__dict__ == b.__dict__
    assert a.reduced().__dict__ == b.reduced().__dict__
    assert a.param_count() == b.param_count()
    assert a.reduced().param_count() == b.reduced().param_count()


def test_init_matches_jax_paths_shapes_and_dtypes(setup):
    arch, _, jstate, _ = setup
    tstate = build_model(get_config(arch).reduced(), device="cpu") \
        .init_train_state(torch.Generator().manual_seed(0))
    assert _tspecs(tstate) == _specs(jax.tree.map(np.asarray, jstate))


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_specs_and_manifest_match_jax(arch):
    """``param_specs`` / ``train_state_specs`` at full size on the meta
    device against ``jax.eval_shape`` path for path, and the replication
    manifest against the JAX ``build_manifest`` (over zero-stride numpy
    views of the full shapes, which hold no memory)."""
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
    assert (n_params, manifest.total_bytes, len(manifest.entries)) == FULL[arch]


def test_loss_matches_jax(setup):
    """rtol 2e-2: the bf16 activations of the two frameworks round at
    different places (``_tol`` for bf16 in tests/test_kernels.py)."""
    arch, jmodel, jstate, tokens = setup
    jloss, _ = jmodel.loss_fn(jstate["params"], {"tokens": tokens},
                              use_pallas=_use_pallas(arch))
    model = build_model(get_config(arch).reduced(), device="cpu")
    params = state_from_numpy(jax.tree.map(np.asarray, jstate["params"]), "cpu")
    tloss, metrics = model.loss_fn(params, {"tokens": tokens})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=2e-2)
    assert float(metrics["aux_loss"]) == 0.0


def test_fp32_gradients_match_jax(setup):
    """With fp32 activations on both sides no bf16 rounding differs: the
    loss agrees to 1e-5 and every leaf's gradient to 1e-4 of the leaf's
    norm, so the port computes the JAX package's function."""
    arch, jmodel, jstate, tokens = setup
    jcfg = jmodel.cfg

    def jloss(p):
        h, _ = jax_transformer.forward(jcfg, p, tokens[:, :-1], return_hidden=True,
                                       dtype=jnp.float32,
                                       use_pallas=_use_pallas(arch))
        return JL.chunked_cross_entropy(p["embed"], h, tokens[:, 1:], jcfg)

    jl, jg = jax.value_and_grad(jloss)(jstate["params"])
    cfg = get_config(arch).reduced()
    params = state_from_numpy(jax.tree.map(np.asarray, jstate["params"]), "cpu")
    paths, leaves = zip(*T.flatten_with_paths(params))
    live = [p.requires_grad_(True) for p in leaves]
    tparams = T.unflatten(paths, live)
    toks = torch.from_numpy(tokens).long()
    h, _ = transformer.forward(cfg, tparams, toks[:, :-1], return_hidden=True,
                               dtype=torch.float32)
    tl = L.chunked_cross_entropy(tparams["embed"], h, toks[:, 1:], cfg)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for path, a, b in zip(paths, jax.tree_util.tree_leaves(jg),
                          torch.autograd.grad(tl, live)):
        a = np.asarray(a)
        assert np.linalg.norm(b.numpy() - a) <= 1e-4 * np.linalg.norm(a), path


def test_train_step_matches_jax(setup):
    """One train step of the config's optimizer against the jitted JAX
    step. Step-1 Adam (fp32 or int8 moments alike: the moments start at
    zero and are quantized after the update is formed) moves an element by
    ``lr·g/(|g| + eps)`` plus the same weight decay on both sides, so the
    worst case is a near-zero gradient whose sign flips between the two
    bf16 roundings, a 2·lr difference; 99% of elements agree to 1% of a
    step. The new optimizer state has JAX's paths, shapes and dtypes."""
    arch, jmodel, jstate, tokens = setup
    host = jax.tree.map(np.asarray, jstate)
    jnew, jm = jax.jit(jmodel.make_train_step(use_pallas=_use_pallas(arch)))(
        jstate, {"tokens": tokens})
    cfg = get_config(arch).reduced()
    tnew, tm = build_model(cfg, device="cpu").make_train_step()(
        state_from_numpy(host, "cpu"), {"tokens": tokens})
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=2e-2)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=2e-2)
    assert int(tnew["opt"]["step"]) == int(jnew["opt"]["step"]) == 1
    assert _tspecs(tnew["opt"]) == _specs(jax.tree.map(np.asarray, jnew["opt"]))
    lr = cfg.learning_rate
    jp = jax.tree_util.tree_leaves(jax.tree.map(np.asarray, jnew["params"]))
    tp = T.leaves(state_to_numpy(tnew["params"]))
    diff = np.concatenate([np.abs(a - b).reshape(-1) for a, b in zip(tp, jp)])
    assert diff.max() <= 2 * lr * (1 + 1e-3)
    assert np.mean(diff <= 1e-2 * lr) >= 0.99


def test_gemma2_layers_alternate_against_jax():
    """Reduced gemma2 (window 8) over 64 positions, layer by layer in fp32:
    each port layer on its input against JAX's ``_layer_body`` (XLA path)
    on the same input and the same flag (layer 0 local, layer 1 global),
    at fp32 ``_tol``; the final logits too. The window binds: the local
    layer run as global, or the global one as local, moves its output far
    outside that tolerance."""
    arch = "gemma2-27b"
    jcfg = jax_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    assert cfg.alt_local_global and cfg.sliding_window == 8 < SEQ
    assert transformer._is_local_flags(cfg) == [True, False]
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(2))
    params = state_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (2, SEQ)).astype(np.int32)
    positions = torch.arange(SEQ)
    spec = L.MaskSpec(kind="causal", window=cfg.sliding_window)
    jspec = JL.MaskSpec(kind="causal", window=jcfg.sliding_window)
    f32 = dict(rtol=2e-5, atol=2e-5)
    x = L.embed_tokens(params["embed"], torch.from_numpy(toks).long(), cfg,
                       positions=positions, dtype=torch.float32)
    layers = T.unstack(params["layers"], cfg.n_layers)
    for i, (lp, is_local) in enumerate(zip(layers, transformer._is_local_flags(cfg))):
        jlp = jax.tree.map(lambda a: a[i], jparams["layers"])
        jx = jnp.asarray(x.numpy())
        jout, _, _ = jax_transformer._layer_body(
            jcfg, jx, jlp, jnp.asarray(i % 2 == 0), jspec,
            jnp.arange(SEQ, dtype=jnp.int32), None, None, 1, False)
        out, _ = transformer._layer_body(cfg, x, lp, spec, is_local, positions)
        torch.testing.assert_close(out, torch.from_numpy(np.array(jout)), **f32)
        flipped, _ = transformer._layer_body(cfg, x, lp, spec, not is_local, positions)
        assert (flipped - out).abs().max() > 1e3 * f32["atol"], i
        x = out
    jlogits, _ = jax_transformer.forward(jcfg, jparams, toks, dtype=jnp.float32)
    tlogits, _ = transformer.forward(cfg, params, torch.from_numpy(toks).long(),
                                     dtype=torch.float32)
    torch.testing.assert_close(tlogits, torch.from_numpy(np.array(jlogits)), **f32)


def test_adamw8bit_state_replicates_as_in_jax():
    """Reduced llama3's adamw8bit state after one JAX step crosses into the
    port and back bit for bit; its manifest, int8 encode (the int8 moment
    codes ship raw, their fp32 scales and the params through the codec) and
    decode equal the JAX package's; an int8 scale-out of the port's trainer
    leaves it bit-unchanged."""
    jcfg = jax_get_config("llama3-405b").reduced()
    jmodel = jax_build_model(jcfg)
    jstate = jmodel.init_train_state(jax.random.PRNGKey(4))
    tokens = np.random.default_rng(7).integers(0, jcfg.vocab, (2, 33)).astype(np.int32)
    jstate, _ = jax.jit(jmodel.make_train_step())(jstate, {"tokens": tokens})
    host = jax.tree.map(np.asarray, jstate)
    tstate = state_from_numpy(host, "cpu")
    for a, b in zip(T.leaves(state_to_numpy(tstate)), jax.tree_util.tree_leaves(host)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert tstate["opt"]["m"]["layers"]["mlp"]["w3"]["codes"].dtype == torch.int8
    assert _entries(trep.build_manifest(tstate)) == _entries(jrep.build_manifest(host))
    jenc, _, jwire = jrep.encode_state(host, "int8", verify_kernel=False)
    tenc, tm, twire = trep.encode_state(tstate, "int8")
    assert twire == jwire
    kinds = {e.path: te.kind for e, te in zip(tm.entries, tenc)}
    assert kinds["opt/m/layers/mlp/w3/codes"] == "raw"
    assert kinds["opt/m/layers/mlp/w3/scale"] == "int8"
    for je, te in zip(jenc, tenc):
        assert (te.kind, te.payload_bytes, te.wire_bytes) == \
            (je.kind, je.payload_bytes, je.wire_bytes)
        if te.kind == "int8":
            assert np.array_equal(te.codes.numpy(), je.codes)
            assert np.array_equal(te.scales.numpy(), je.scales)
        else:
            assert np.array_equal(te.raw.numpy(), je.raw)
    jdec = jax.tree.map(np.asarray, jrep.decode_state(
        jenc, jrep.build_manifest(host), verify_kernel=False))
    tdec = trep.decode_state(tenc, tm)
    for a, b in zip(T.leaves(state_to_numpy(tdec)), jax.tree_util.tree_leaves(jdec)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert trep.roundtrip_max_error_ok(tstate, tdec, tenc)

    cfg = get_config("llama3-405b").reduced()
    tr = ElasticTrainer(build_model(cfg, device="cpu"), initial=2, per_device_batch=1,
                        link_model=lambda i: NeighborLink(0.002, 1 / (500e6 / 8), 0.0),
                        codec="int8")
    tr.init(state=tstate)
    before = [leaf.clone() for leaf in T.leaves(tr.state)]
    ev = tr.scale_out()
    assert ev.plan_summary["codec"]["wire_bytes"] == jwire
    for a, b in zip(before, T.leaves(tr.state)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_takes_the_dense_configs(arch, capsys):
    """``repro_torch.launch.train`` trains each reduced config on the CPU
    (llama3 and gemma2 with adamw8bit) and prints ``TRAIN_OK``."""
    from repro_torch.launch import train

    assert train.main(["--arch", arch, "--steps", "2", "--batch", "2", "--seq", "16",
                       "--device", "cpu"]) == 0
    assert capsys.readouterr().out.rstrip().endswith("TRAIN_OK")


def test_unported_archs_exit_non_zero(capsys):
    """Every config of the JAX package is in the port, so an unported arch
    is one neither registry has: it exits non-zero from both launchers,
    with each launcher's own unknown-arch message."""
    from repro.configs import list_configs as jax_list_configs
    from repro_torch.configs import get_config as torch_get_config
    from repro_torch.launch import serve, train

    for name in jax_list_configs():
        assert torch_get_config(name).name == name
    arch = "no-such-arch"
    assert arch not in jax_list_configs()
    assert train.main(["--arch", arch, "--device", "cpu"]) != 0
    assert serve.main(["--arch", arch, "--device", "cpu"]) != 0
    err = capsys.readouterr().err
    assert f"train: unknown arch {arch!r}" in err
    assert f"serve: unknown arch {arch!r}" in err
