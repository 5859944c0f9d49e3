"""The port's encdec family (Whisper-small) against the JAX package's, on
the CPU.

The reduced Whisper (2 encoder and 2 decoder layers, d_model 64, 4 heads on
2 kv heads at head dim 16, ``enc_len`` 16) and the same at a ragged
``enc_len`` of 24 run on both sides from the same JAX-initialised params
(converted through numpy), the same tokens and the same frame embeddings,
drawn from ``np.random.default_rng`` (random, never zeros). The JAX side
runs its XLA attention (``use_pallas=False``). Held: the encoder, the
teacher-forced forward, the loss and fp32 gradients, one train step,
``precompute_cross_kv``, the prefill and cached decode (self and cross
caches), state paths and the replication manifest, full-size specs,
``ElasticTrainer`` steps with frames across an int8 scale-out,
``chip_smoke.serve_fp32_check`` with Whisper's planted faults, and the
launchers. Tolerances are tests/test_kernels.py's, from ``chip_smoke``:
``_tol`` of the dtype for activations, ``_rec_tol`` for gradients; bf16
runs JAX op by op with its bf16 gelu rounded once and its XLA attention's
probabilities in fp32, as tests/test_torch_serve.py does. Also the leftovers
that name the new configs: ``configs.ASSIGNED``, ``Model.make_batch`` and
``data.synthetic.ImageStream``; and the JAX encdec prefill's cache size.
"""
import dataclasses
import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED as JAX_ASSIGNED
from repro.configs import get_config as jax_get_config
from repro.core import replication as jrep
from repro.data.synthetic import ImageStream as JaxImageStream
from repro.models import build_model as jax_build_model
from repro.models import layers as JL
from repro.models import whisper as jax_whisper
from repro_torch import tree as T
from repro_torch.configs import ASSIGNED, ShapeCell, get_config
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import replication as trep
from repro_torch.core.sharding_alg import NeighborLink
from repro_torch.data import ImageStream
from repro_torch.elastic import ElasticTrainer
from repro_torch.launch import serve
from repro_torch.models import build_model, whisper

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "whisper-small"
B, S, DECODE = 2, 12, 4
ENC_LENS = (16, 24)
#: After one adamw step, the share of param elements within 1% of lr of
#: JAX's: over all of them (read 99.96%; the learned positions' unused
#: rows, 93% of the elements, have no gradient), over those whose JAX
#: gradient is resolved in bf16 (``BF16_RESOLVED``; read 99.81%), and in
#: each leaf (read 98.4% at the least, a norm's 64 or 128 elements).
AGREE, LEAF_AGREE = 0.99, 0.95
#: bf16's relative precision: a gradient below this share of its leaf's
#: rms lies within the rounding of the bf16 products summed into it.
BF16_RESOLVED = 2.0 ** -8
#: Each leaf's new first moment (``(1 - B1)`` times its clipped gradient)
#: against JAX's, relative to the norm of JAX's (read 1.9% at most,
#: ``decoder/xattn/wk``).
B1, MOMENT_RTOL = 0.9, 5e-2


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
    """JAX op by op, bf16 gelu rounded once, the XLA attention's
    probabilities in fp32 (tests/test_torch_serve.py's fixture)."""
    monkeypatch.setattr(jax.nn, "gelu", serve_tests._rounded_once(jax.nn.gelu))
    monkeypatch.setattr(JL, "blocked_attention",
                        serve_tests._probabilities_in_fp32(JL.blocked_attention))
    return jax.disable_jit


def _cfgs(enc_len):
    return tuple(dataclasses.replace(get(ARCH).reduced(), enc_len=enc_len)
                 for get in (jax_get_config, get_config))


@functools.lru_cache(maxsize=None)
def _setup(enc_len):
    jcfg, cfg = _cfgs(enc_len)
    jmodel = jax_build_model(jcfg)
    host = jax.tree.map(np.asarray, jax.jit(jmodel.init_train_state)(
        jax.random.PRNGKey(1)))
    tmodel = build_model(cfg, device="cpu")
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab, size=(B, S + DECODE + 1)).astype(np.int32)
    frames = (0.02 * rng.standard_normal((B, cfg.enc_len, cfg.d_model))).astype(
        np.float32)
    return jmodel, host, tmodel, tokens, frames


@pytest.fixture
def setup():
    """The reduced Whisper at ``enc_len`` 16."""
    return _setup(ENC_LENS[0])


@pytest.fixture(params=ENC_LENS, ids=[f"enc{n}" for n in ENC_LENS])
def each_enc_len(request):
    """The reduced Whisper at ``enc_len`` 16 and at a ragged 24."""
    return _setup(request.param)


def _tparams(host):
    return state_from_numpy(host["params"], "cpu")


def _close(got, want, dtype, **kw):
    torch.testing.assert_close(got.float(), torch.from_numpy(
        np.array(want, np.float32)), **TOL[dtype], **kw)


def test_config_and_assigned_equal_jax():
    """The port's copy of the config equals JAX's field for field (also
    reduced), and ``configs.ASSIGNED`` is the JAX package's tuple."""
    a, b = get_config(ARCH), jax_get_config(ARCH)
    assert a.__dict__ == b.__dict__
    assert a.reduced().__dict__ == b.reduced().__dict__
    assert a.param_count() == b.param_count() == 264_378_624
    assert ASSIGNED == JAX_ASSIGNED
    assert all(get_config(name).name == name for name in ASSIGNED)


def test_encoder_and_cross_kv_match_jax(each_enc_len):
    """``encode`` in fp32 (full attention over the frames) and
    ``precompute_cross_kv`` on its output against JAX's at fp32 ``_tol``."""
    jmodel, host, tmodel, _, frames = each_enc_len
    jparams = jax.tree.map(jnp.asarray, host["params"])
    jenc = jax_whisper.encode(jmodel.cfg, jparams, jnp.asarray(frames))
    tenc = whisper.encode(tmodel.cfg, _tparams(host), torch.from_numpy(frames))
    _close(tenc, jenc, "float32")
    jk, jv = jax_whisper.precompute_cross_kv(jmodel.cfg, jparams, jenc)
    tk, tv = whisper.precompute_cross_kv(tmodel.cfg, _tparams(host),
                                         torch.from_numpy(np.asarray(jenc)))
    assert tuple(tk.shape) == (2, B, tmodel.cfg.enc_len, 2, 16)
    _close(tk, jk, "float32")
    _close(tv, jv, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(each_enc_len, jax_op_by_op, dtype):
    """The teacher-forced forward (encoder, decoder self- and
    cross-attention, tied unembedding) against JAX's at ``_tol`` of the
    dtype."""
    jmodel, host, tmodel, tokens, frames = each_enc_len
    with jax_op_by_op():
        jl, _ = jax_whisper.forward(jmodel.cfg, jax.tree.map(jnp.asarray, host["params"]),
                                    jnp.asarray(tokens[:, :S]), frames=jnp.asarray(frames),
                                    dtype=getattr(jnp, dtype))
    tl, aux = whisper.forward(tmodel.cfg, _tparams(host), torch.from_numpy(tokens[:, :S]).long(),
                              frames=torch.from_numpy(frames), dtype=getattr(torch, dtype))
    assert tl.shape == (B, S, tmodel.cfg.vocab) and float(aux) == 0.0
    _close(tl, jl, dtype)


def test_loss_and_fp32_gradients_match_jax(setup):
    """fp32 activations on both sides: the loss at fp32 ``_tol`` and every
    leaf's gradient (the encoder through the cross-attention among them)
    at ``_rec_tol``."""
    jmodel, host, tmodel, tokens, frames = setup
    jcfg, cfg = jmodel.cfg, tmodel.cfg

    def jloss(p):
        h, _ = jax_whisper.forward(jcfg, p, tokens[:, :-1], frames=frames,
                                   return_hidden=True, dtype=jnp.float32)
        return JL.chunked_cross_entropy(p["embed"], h, tokens[:, 1:], jcfg)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jax.tree.map(jnp.asarray, host["params"]))
    paths, leaves = zip(*T.flatten_with_paths(_tparams(host)))
    live = [p.requires_grad_(True) for p in leaves]
    tparams = T.unflatten(paths, live)
    from repro_torch.models import layers as L
    toks = torch.from_numpy(tokens).long()
    h, _ = whisper.forward(cfg, tparams, toks[:, :-1], frames=torch.from_numpy(frames),
                           return_hidden=True, dtype=torch.float32)
    tl = L.chunked_cross_entropy(tparams["embed"], h, toks[:, 1:], cfg)
    torch.testing.assert_close(tl.detach(), torch.tensor(float(jl)), **TOL["float32"])
    names = ["/".join(p) for p in paths]
    assert "decoder/xattn/wk" in names and "encoder/attn/wq" in names
    for path, a, b in zip(names, jax.tree_util.tree_leaves(jg),
                          torch.autograd.grad(tl, live)):
        torch.testing.assert_close(b, torch.from_numpy(np.array(a)), **REC_TOL,
                                   msg=lambda m: f"{path}: {m}")


def test_train_step_matches_jax(setup):
    """``Model.loss_fn`` with frames and one adamw step against the jitted
    JAX step: the loss and gradient norm at rtol 2e-2 (bf16 activations),
    the optimizer state's paths, the params and the new first moments.

    A first Adam step moves each element by ``lr·g/(|g| + eps)`` plus the
    same weight decay on both sides, so an element differs by more than 1%
    of lr only where its gradient's sign flips between the two packages'
    bf16 roundings (2·lr at worst): ``AGREE`` and ``LEAF_AGREE`` bound how
    many. The step is blind to the gradient's scale, so the moments hold
    the clipping and each leaf's gradient: ``MOMENT_RTOL`` per leaf, and
    the global norm of the first moments, ``(1 - B1)`` times the clipped
    gradient norm, on both sides."""
    jmodel, host, tmodel, tokens, frames = setup
    batch = {"tokens": tokens, "frames": frames}
    jstate = jax.tree.map(jnp.asarray, host)
    jgrads = jax.tree_util.tree_leaves(jax.jit(jax.grad(
        lambda p: jmodel.loss_fn(p, batch)[0]))(jstate["params"]))
    jnew, jm = jax.jit(jmodel.make_train_step())(jstate, batch)
    tnew, tm = tmodel.make_train_step()(state_from_numpy(host, "cpu"), batch)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=2e-2)
    assert [p for p, _ in T.flatten_with_paths(tnew["opt"])] == [
        tuple(str(k.key) for k in p)
        for p, _ in jax.tree_util.tree_flatten_with_path(jnew["opt"])[0]]
    lr = tmodel.cfg.learning_rate
    paths, tp = zip(*T.flatten_with_paths(state_to_numpy(tnew["params"])))
    diffs = [np.abs(a - np.asarray(b)).reshape(-1)
             for a, b in zip(tp, jax.tree_util.tree_leaves(jnew["params"]))]
    diff = np.concatenate(diffs)
    resolved = np.concatenate([
        np.abs(g) >= BF16_RESOLVED * np.sqrt(np.mean(np.square(g)))
        for g in (np.asarray(g, np.float32).reshape(-1) for g in jgrads)])
    assert diff.max() <= 2 * lr * (1 + 1e-3)
    assert np.mean(diff <= 1e-2 * lr) >= AGREE
    assert np.mean(diff[resolved] <= 1e-2 * lr) >= AGREE
    for path, d in zip(paths, diffs):
        assert np.mean(d <= 1e-2 * lr) >= LEAF_AGREE, path
    ms = {"port": T.leaves(state_to_numpy(tnew["opt"]["m"])),
          "JAX": [np.asarray(m) for m in jax.tree_util.tree_leaves(jnew["opt"]["m"])]}
    for path, t, j in zip(paths, ms["port"], ms["JAX"]):
        assert np.linalg.norm(t - j) <= MOMENT_RTOL * np.linalg.norm(j), path
    for name, m in (("port", tm), ("JAX", jm)):
        clipped = min(float(m["grad_norm"]), tmodel.cfg.grad_clip)
        norm = np.sqrt(sum(float(np.sum(np.square(x.astype(np.float64))))
                           for x in ms[name]))
        np.testing.assert_allclose(norm, (1 - B1) * clipped, rtol=1e-2, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_cached_decode_match_jax(each_enc_len, jax_op_by_op, dtype):
    """A prefill of S tokens with the frames into a cache of S + ``DECODE``
    rows, then ``DECODE`` teacher-forced decode steps reading the cross
    cache as it is: each call's logits against JAX's cached forward on its
    own cache at ``_tol`` of the dtype, and the self and cross caches at
    the end."""
    jmodel, host, tmodel, tokens, frames = each_enc_len
    jcfg, cfg = jmodel.cfg, tmodel.cfg
    jparams = jax.tree.map(jnp.asarray, host["params"])
    tparams = _tparams(host)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jcache = jax_whisper.make_cache(jcfg, B, S + DECODE, dtype=jdt)
    tcache = whisper.make_cache(cfg, B, S + DECODE, dtype=tdt)
    pos, n = 0, S
    while pos < S + DECODE:
        toks = tokens[:, pos:pos + n]
        kw = {"frames": frames} if pos == 0 else {}
        with jax_op_by_op():
            jl, jcache, _ = jax_whisper.forward(
                jcfg, jparams, jnp.asarray(toks), cache=jcache,
                cache_pos=jnp.asarray(pos, jnp.int32), last_only=True, dtype=jdt,
                **{k: jnp.asarray(v) for k, v in kw.items()})
        tl, tcache, _ = whisper.forward(
            cfg, tparams, torch.from_numpy(toks).long(), cache=tcache, cache_pos=pos,
            last_only=True, dtype=tdt, **{k: torch.from_numpy(v) for k, v in kw.items()})
        _close(tl, jl, dtype, msg=lambda m: f"pos {pos}: {m}")
        pos, n = pos + n, 1
    for key in ("k", "v", "xk", "xv"):
        assert tcache[key].dtype == tdt
        _close(tcache[key], jcache[key], dtype)


def test_jax_encdec_prefill_cache_is_sized_s_and_a_decode_overwrites_a_row(setup):
    """The JAX ``Model.prefill`` sizes Whisper's self cache at the prompt's
    S rows, so the decode at position S clamps its write start to S - 1
    and overwrites the last prompt row's K/V (the hybrid family's fault,
    ROADMAP Queue 3). The port's ``Model.prefill`` sizes it as JAX does by
    default and raises at that decode; ``generate`` sizes it S + n_tokens."""
    jmodel, host, tmodel, tokens, frames = setup
    jparams = jax.tree.map(jnp.asarray, host["params"])
    prompt = jnp.asarray(tokens[:, :S])
    _, jcache = jmodel.prefill(jparams, {"tokens": prompt, "frames": jnp.asarray(frames)})
    assert jcache["k"].shape[2] == S
    before = np.asarray(jcache["k"])
    _, after = jmodel.decode_step(jparams, {"tokens": jnp.asarray(tokens[:, S:S + 1]),
                                            "pos": jnp.asarray(S, jnp.int32),
                                            "cache": jcache})
    after = np.asarray(after["k"])
    assert np.array_equal(after[:, :, :S - 1], before[:, :, :S - 1])
    assert not np.array_equal(after[:, :, S - 1], before[:, :, S - 1])
    tparams = _tparams(host)
    _, tcache = tmodel.prefill(tparams, {"tokens": tokens[:, :S], "frames": frames})
    assert tcache["k"].shape[2] == S
    with pytest.raises(ValueError, match="KV cache overflow"):
        tmodel.decode_step(tparams, {"tokens": tokens[:, S:S + 1], "pos": S,
                                     "cache": tcache})
    run = serve.generate(tmodel, tparams, tokens[:, :S], DECODE, frames=frames)
    assert run.tokens.shape == (B, DECODE)


def test_state_paths_manifest_and_full_size_specs_match_jax(setup):
    """The JAX state crosses into the port and back bit for bit, path for
    path; the replication manifest equals JAX's; at full size the params,
    the cache and the train, prefill and decode cells' inputs (frames
    among them) on the meta device have JAX's paths, shapes and dtypes."""
    jmodel, host, _, _, _ = setup
    back = state_to_numpy(state_from_numpy(host, "cpu"))
    jleaves = jax.tree_util.tree_flatten_with_path(host)[0]
    tleaves = T.flatten_with_paths(back)
    assert [tuple(str(k.key) for k in p) for p, _ in jleaves] == [p for p, _ in tleaves]
    assert all(a.dtype == b.dtype and np.array_equal(a, b)
               for (_, a), (_, b) in zip(jleaves, tleaves))
    entries = [(e.path, tuple(e.shape), e.dtype, e.offset, e.nbytes)
               for m in (trep.build_manifest(state_from_numpy(host, "cpu")),
                         jrep.build_manifest(host)) for e in m.entries]
    assert entries[:len(entries) // 2] == entries[len(entries) // 2:]

    jfull = jax_build_model(jax_get_config(ARCH))
    tfull = build_model(get_config(ARCH), device="meta")

    def specs(tree, jax_side):
        leaves = (jax.tree_util.tree_flatten_with_path(tree)[0] if jax_side
                  else T.flatten_with_paths(tree))
        return [("/".join(str(k.key) for k in p) if jax_side else "/".join(p),
                 tuple(x.shape), str(x.dtype).removeprefix("torch."))
                for p, x in leaves]

    assert specs(tfull.param_specs(), False) == specs(jfull.param_specs(), True)
    assert specs(tfull.train_state_specs(), False) == \
        specs(jfull.train_state_specs(), True)
    assert specs(tfull.cache_specs(8, 228), False) == specs(jfull.cache_specs(8, 228), True)
    assert tuple(tfull.cache_specs(8, 228)["xk"].shape) == (12, 8, 1500, 12, 64)
    for cell in (ShapeCell("train_4k", 4096, 256, "train"),
                 ShapeCell("prefill_32k", 32_768, 32, "prefill"),
                 ShapeCell("decode_32k", 32_768, 128, "decode")):
        assert specs(tfull.input_specs(cell), False) == \
            specs(jfull.input_specs(cell), True), cell.kind


def test_elastic_trainer_scales_out_with_frames(setup):
    """``ElasticTrainer`` steps with frames in every batch: the first
    step's loss is ``Model.loss_fn``'s, an int8 scale-out leaves the state
    bit-unchanged and sends JAX's wire bytes, and the steps after it on
    three devices are finite."""
    _, host, tmodel, tokens, frames = setup
    rng = np.random.default_rng(6)
    trainer = ElasticTrainer(tmodel, pool_size=3, initial=2, per_device_batch=1,
                             codec="int8",
                             link_model=lambda i: NeighborLink(0.002, 1 / (500e6 / 8), 0.0))
    trainer.init(state=state_from_numpy(host, "cpu"))
    batch = {"tokens": tokens[:, :S + 1], "frames": frames}
    want, _ = tmodel.loss_fn(_tparams(host), batch)
    assert trainer.step(batch)["loss"] == pytest.approx(float(want), rel=1e-6)
    before = [leaf.clone() for leaf in T.leaves(trainer.state)]
    _, _, jwire = jrep.encode_state(state_to_numpy(trainer.state), "int8",
                                    verify_kernel=False)
    ev = trainer.scale_out()
    assert ev.plan_summary["codec"]["wire_bytes"] == jwire
    assert all(torch.equal(a, b) for a, b in zip(before, T.leaves(trainer.state)))
    for _ in range(2):
        m = trainer.step({"tokens": rng.integers(0, tmodel.cfg.vocab, (3, S + 1)),
                          "frames": (0.02 * rng.standard_normal(
                              (3, tmodel.cfg.enc_len, tmodel.cfg.d_model))).astype(
                                  np.float32)})
        assert np.isfinite(m["loss"])
    with pytest.raises(ValueError, match="frames"):
        trainer.step({"tokens": tokens[:1, :S + 1].repeat(3, 0), "frames": frames})


def test_serve_fp32_check_holds_and_faults_fail(setup):
    """``chip_smoke.serve_fp32_check`` on the reduced Whisper with its
    frames: fp32 prefill and forced decode steps against the cache-free
    forward within ``_tol``; the self cache written one row off and the
    cross cache filled from the other row's frames each leave it."""
    _, host, tmodel, tokens, frames = setup
    out = cs.serve_fp32_check(tmodel.cfg, _tparams(host), torch.from_numpy(tokens).long(),
                              S, S + DECODE + 1, frames=torch.from_numpy(frames))
    assert out["tolerance"] == TOL["float32"]
    assert out["outside"] == 0 and out["rows_compared"] == B
    assert set(out["faults"]) == set(cs.SERVE_FAULTS["encdec"]) == \
        set(cs.serve_faults(tmodel.cfg))
    assert all(f["outside"] > 0 for f in out["faults"].values())


def test_launchers_take_whisper(capsys):
    """``launch.train --arch whisper-small`` trains the reduced config in
    plain and elastic mode on the CPU, and ``launch.serve`` answers a
    request with seeded frames (``SERVE_OK``); ``generate`` needs frames."""
    from repro_torch.launch import train

    assert train.main(["--arch", ARCH, "--steps", "2", "--batch", "2", "--seq", "16",
                       "--device", "cpu"]) == 0
    assert capsys.readouterr().out.rstrip().endswith("TRAIN_OK")
    assert train.main(["--arch", ARCH, "--elastic", "--steps", "3", "--device",
                       "cpu"]) == 0
    assert "scale-out" in capsys.readouterr().out
    assert serve.main(["--arch", ARCH, "--requests", "1", "--batch", "2",
                       "--prompt-len", "4", "--tokens", "4", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.rstrip().endswith("SERVE_OK")
    model = build_model(get_config(ARCH).reduced(), device="cpu")
    with pytest.raises(ValueError, match="frames"):
        serve.generate(model, model.init(), torch.zeros((1, 4), dtype=torch.long), 2)


@pytest.mark.parametrize("arch, kind", [(ARCH, "train"), (ARCH, "decode"),
                                        ("paligemma-3b", "prefill")])
def test_make_batch_matches_jax_specs(arch, kind):
    """``Model.make_batch`` gives JAX's ``make_batch`` shapes and dtypes
    (frames for encdec, patches for vlm, a decode's cache): tokens in
    [0, vocab), the decode position ``seq_len - 1``, float arrays 0.02 x
    normals; the same generator seed gives the same batch."""
    cell = ShapeCell("t", 8, 2, kind)
    jmodel = jax_build_model(jax_get_config(arch).reduced())
    tmodel = build_model(get_config(arch).reduced(), device="cpu")
    jb = jax.tree.map(np.asarray, jmodel.make_batch(cell))
    tb = tmodel.make_batch(cell, torch.Generator().manual_seed(1))
    tleaves = T.flatten_with_paths(tb)
    jleaves = jax.tree_util.tree_flatten_with_path(jb)[0]
    assert [(p, tuple(x.shape), str(x.dtype).removeprefix("torch.")) for p, x in tleaves] == \
        [(tuple(str(k.key) for k in p), x.shape,
          "bfloat16" if x.dtype == ml_dtypes.bfloat16 else str(x.dtype))
         for p, x in jleaves]
    for path, x in tleaves:
        if x.dtype == torch.int32 and x.dim():
            assert 0 <= int(x.min()) and int(x.max()) < tmodel.cfg.vocab
        elif x.dtype == torch.int32:
            assert int(x) == cell.seq_len - 1
        else:
            assert 0 < float(x.float().std()) < 0.05, path
    again = tmodel.make_batch(cell, torch.Generator().manual_seed(1))
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(tb), T.leaves(again)))


def test_image_stream_matches_jax():
    """``data.synthetic.ImageStream`` (numpy only) gives the JAX package's
    examples and batches bit for bit."""
    for seed in (0, 3):
        a, b = ImageStream(seed=seed), JaxImageStream(seed=seed)
        xa, ya = a.batch(range(0, 5000, 97))
        xb, yb = b.batch(range(0, 5000, 97))
        assert xa.tobytes() == xb.tobytes() and np.array_equal(ya, yb)
        assert ya.dtype == yb.dtype == np.int32
