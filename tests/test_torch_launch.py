"""The port's training launcher (``repro_torch.launch.train``) and the twin
of ``examples/elastic_training.py`` on the CPU, against the JAX package.

``repro.launch.train`` sets ``XLA_FLAGS`` when it is imported, so it is
not imported here: the port is held to the JAX launcher's loop through
``repro.models.build_model(cfg).make_train_step()``, the JAX
``make_train_batch`` and the JAX launcher's schedule rules, restated in
:func:`_jax_schedule`.
"""
import dataclasses
import importlib.util
import os
import pathlib
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jax_load_checkpoint
from repro.configs import get_config as jax_get_config
from repro.configs.base import ShapeCell as JaxShapeCell
from repro.data.synthetic import TokenStream as JaxTokenStream
from repro.data.synthetic import make_train_batch as jax_make_train_batch
from repro.models import build_model as jax_build_model
from repro_torch import tree as T
from repro_torch.checkpoint import AsyncCheckpointer, load_checkpoint
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.convert import state_from_numpy
from repro_torch.data import make_train_batch
from repro_torch.launch import train as launch
from repro_torch.models import build_model

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: the launcher's reduced defaults: --batch 8, --seq 64, --lr 1e-3.
CELL = ShapeCell("launch", 64, 8, "train")
JAX_CELL = JaxShapeCell("launch", 64, 8, "train")


def _cfgs():
    """The launcher's reduced GPT-2 in both packages."""
    return (dataclasses.replace(get_config("gpt2").reduced(), learning_rate=1e-3),
            dataclasses.replace(jax_get_config("gpt2").reduced(), learning_rate=1e-3))


@pytest.fixture(scope="module")
def jax_init():
    """The JAX model and its init (``PRNGKey(0)``), as numpy."""
    jmodel = jax_build_model(_cfgs()[1])
    host = jax.tree.map(np.asarray, jmodel.init_train_state(jax.random.PRNGKey(0)))
    return jmodel, host


_JAX_STEPS = {}


def _jax_step(jmodel):
    """The JAX train step, jitted once per model (it compiles per batch
    shape)."""
    if id(jmodel) not in _JAX_STEPS:
        _JAX_STEPS[id(jmodel)] = (jmodel, jax.jit(jmodel.make_train_step()))
    return _JAX_STEPS[id(jmodel)][1]


def _raw(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).reshape(-1).view(np.uint8).tobytes()


def _same_bits(host_tree, state) -> bool:
    """A numpy tree (as the JAX package loads it) against a port state,
    path by path, shape, dtype name and bytes."""
    a, b = T.flatten_with_paths(host_tree), T.flatten_with_paths(state)
    return [p for p, _ in a] == [p for p, _ in b] and all(
        tuple(x.shape) == tuple(y.shape)
        and str(x.dtype) == str(y.dtype).removeprefix("torch.")
        and _raw(x) == _raw(y) for (_, x), (_, y) in zip(a, b))


def _jax_schedule(steps, global_batch=8, ckpt_every=10, pool=8):
    """The JAX launcher's elastic rules (``repro/launch/train.py``): start
    on ``max(2, pool // 2)`` devices, join at ``steps // 3`` and leave at
    ``2 * steps // 3`` where the pool allows, a checkpoint at every ``i %
    ckpt_every == 0``. Returns (devices per step, join steps, leave steps,
    checkpoint steps, per-device batch)."""
    n, per_step, joins, leaves = max(2, pool // 2), [], [], []
    for i in range(steps):
        if i == steps // 3 and n < pool:
            n += 1
            joins.append(i)
        if i == 2 * steps // 3 and n > 1:
            n -= 1
            leaves.append(i)
        per_step.append(n)
    return (per_step, joins, leaves, [i for i in range(steps) if i % ckpt_every == 0],
            max(1, global_batch // pool))


# ---------------------------------------------------------------------------
# Data.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_make_train_batch_matches_jax(seed):
    cfg, jcfg = _cfgs()
    for cell, jcell in ((CELL, JAX_CELL),
                        (ShapeCell("c", 33, 3, "train"), JaxShapeCell("c", 33, 3, "train"))):
        ours = make_train_batch(cfg, cell, seed=seed)
        theirs = jax_make_train_batch(jcfg, jcell, seed=seed)
        assert ours.keys() == theirs.keys() == {"tokens"}
        assert ours["tokens"].dtype == theirs["tokens"].dtype
        assert np.array_equal(ours["tokens"], theirs["tokens"])
    # The vlm and encdec branches, on a stand-in config of each family.
    for family, key in (("vlm", "patches"), ("encdec", "frames")):
        fake = types.SimpleNamespace(family=family, vocab=300, d_model=16,
                                     n_patches=4, enc_len=5)
        ours = make_train_batch(fake, CELL, seed=seed)
        theirs = jax_make_train_batch(fake, JAX_CELL, seed=seed)
        assert _raw(ours[key]) == _raw(theirs[key]) and ours[key].dtype == np.float32
        assert np.array_equal(ours["tokens"], theirs["tokens"])
    stream = JaxTokenStream(300, 20, seed=seed)
    assert np.array_equal(make_train_batch(cfg, CELL, stream=stream, seed=9)["tokens"],
                          jax_make_train_batch(jcfg, JAX_CELL, stream=stream)["tokens"])


# ---------------------------------------------------------------------------
# The two modes against the JAX train step and schedule.
# ---------------------------------------------------------------------------


#: One step's tolerance, as a share of the norm of what the JAX step changes
#: in each leaf. The step is re-run in JAX from the port's own state before
#: it, so differences do not pile up over steps. The optimizer's moments
#: follow the batch's gradient and its square (a launcher on reduced GPT-2
#: lands within 0.02 of the step's change, a batch shifted by one sequence
#: 0.6 or more away); the parameters only at 0.5, because Adam's first
#: update is ``lr * sign(g)`` and the sign of a gradient near zero follows
#: the bf16 rounding (within 0.25 of the step's change on the first step,
#: 0.03 later).
MOMENT_TOL, PARAM_TOL = 0.1, 0.5


def _host(state):
    return T.tree_map(lambda t: t.detach().cpu().numpy().copy(), state)


def _float_leaves(tree):
    return [(p, np.asarray(x, np.float64)) for p, x in T.flatten_with_paths(tree)
            if np.issubdtype(np.asarray(x).dtype, np.floating)]


def _check_steps(jmodel, states, batches):
    """Each step of the port (``states[k]`` to ``states[k + 1]`` on
    ``batches[k]``) against the JAX train step taken from ``states[k]``:
    per leaf, the distance to the JAX result within ``MOMENT_TOL`` (the
    optimizer's moments) or ``PARAM_TOL`` (the parameters) of the norm of
    the JAX step's change, and the step counter equal. Returns the JAX
    losses."""
    step = _jax_step(jmodel)
    losses = []
    for k, batch in enumerate(batches):
        ref, m = step(states[k], {"tokens": batch})
        ref = jax.tree.map(np.asarray, ref)
        losses.append(float(m["loss"]))
        assert int(states[k + 1]["opt"]["step"]) == int(ref["opt"]["step"]), k
        for part, tol in (("params", PARAM_TOL), ("m", MOMENT_TOL), ("v", MOMENT_TOL)):
            pick = (lambda s: s["params"]) if part == "params" else (lambda s: s["opt"][part])
            for (path, ours), (_, want), (_, before) in zip(
                    _float_leaves(pick(states[k + 1])), _float_leaves(pick(ref)),
                    _float_leaves(pick(states[k]))):
                change = np.linalg.norm(want - before)
                if change == 0.0:
                    np.testing.assert_array_equal(ours, want, err_msg=f"{k} {part} {path}")
                    continue
                off = np.linalg.norm(ours - want) / change
                assert off <= tol, (k, part, path, off)
    return losses


def _recording_step(model, fed, states):
    """Wraps ``model.make_train_step`` so that every step records the
    tokens it is given and a host copy of the state it returns."""
    make = model.make_train_step

    def make_recording():
        step = make()

        def run(state, batch):
            fed.append(np.array(batch["tokens"]))
            state, m = step(state, batch)
            states.append(_host(state))
            return state, m
        return run
    model.make_train_step = make_recording
    return model


def _jax_elastic_batches(vocab, per_step, per_dev, seq_len=64):
    """The JAX launcher's draws: ``stream.batch(range(i * gb, (i + 1) *
    gb))`` with ``gb`` the global batch at step ``i``."""
    stream = JaxTokenStream(vocab, seq_len, seed=0)
    return [stream.batch(range(i * n * per_dev, (i + 1) * n * per_dev))
            for i, n in enumerate(per_step)]


@pytest.fixture(scope="module")
def elastic_run(jax_init, tmp_path_factory):
    """``train_elastic`` for ``--steps 9 --ckpt-every 3`` from the JAX
    init, with the tokens of every step and the state after it recorded."""
    _, host = jax_init
    cfg, _ = _cfgs()
    ckdir = tmp_path_factory.mktemp("elastic_ckpt")
    fed, states = [], [host]
    ck = AsyncCheckpointer(ckdir, keep=3)
    run = launch.train_elastic(_recording_step(build_model(cfg, device="cpu"), fed, states),
                               CELL, 9, state=state_from_numpy(host, "cpu"), ckpt=ck,
                               ckpt_every=3)
    ck.close()
    return run, fed, states, ckdir


def test_train_plain_follows_the_jax_train_step(jax_init):
    """The batches the launcher feeds are ``make_train_batch(cfg, cell,
    seed=i)`` bit for bit; every step is the JAX train step's
    (:func:`_check_steps`); the losses are within 2e-2 of a JAX run from
    the same init (bf16 activations round differently in the two
    frameworks, as in tests/test_torch_trainer.py)."""
    jmodel, host = jax_init
    cfg, jcfg = _cfgs()
    fed, states = [], [host]
    run = launch.train_plain(_recording_step(build_model(cfg, device="cpu"), fed, states),
                             CELL, 3, state=state_from_numpy(host, "cpu"))
    batches = [jax_make_train_batch(jcfg, JAX_CELL, seed=i)["tokens"] for i in range(3)]
    assert len(fed) == 3 and all(a.dtype == b.dtype and np.array_equal(a, b)
                                 for a, b in zip(fed, batches))
    assert all(np.isfinite(run.losses)) and run.events == [] and run.ckpt_steps == []
    forced = _check_steps(jmodel, states, batches)
    np.testing.assert_allclose(run.losses, forced, rtol=2e-2)
    step = _jax_step(jmodel)
    jstate, jlosses = host, []
    for b in batches:
        jstate, m = step(jstate, {"tokens": b})
        jlosses.append(float(m["loss"]))
    np.testing.assert_allclose(run.losses, jlosses, rtol=2e-2)


def test_train_elastic_follows_the_jax_schedule_and_train_step(jax_init, elastic_run):
    """``--steps 9 --ckpt-every 3``: the devices per step, the join and
    leave steps and the checkpoint steps of the JAX launcher's rules; the
    tokens fed at each step bit for bit those rules' draws from the stream;
    every step the JAX train step over that global batch (one synchronous
    step over the global batch is the data-parallel step's math), and the
    losses within 2e-2 of a JAX run from the same init."""
    jmodel, host = jax_init
    _, jcfg = _cfgs()
    run, fed, states, ckdir = elastic_run
    per_step, joins, leaves, ckpts, per_dev = _jax_schedule(9, ckpt_every=3)
    assert (per_step, joins, leaves, ckpts) == ([4, 4, 4, 5, 5, 5, 4, 4, 4], [3], [6],
                                                [0, 3, 6])
    assert run.n_active == per_step and run.ckpt_steps == ckpts
    assert [(e.kind, e.step) for e in run.events] == \
        [("scale-out", s) for s in joins] + [("scale-in", s) for s in leaves]
    assert run.trainer.per_device_batch == per_dev == 1
    assert sorted(p.name for p in ckdir.glob("*.ckpt")) == \
        [f"step_{s:08d}.ckpt" for s in ckpts]
    batches = _jax_elastic_batches(jcfg.vocab, per_step, per_dev)
    assert [b.shape[0] for b in batches] == per_step
    assert len(fed) == 9 and all(a.dtype == b.dtype and np.array_equal(a, b)
                                 for a, b in zip(fed, batches))
    forced = _check_steps(jmodel, states, batches)
    np.testing.assert_allclose(run.losses, forced, rtol=2e-2)
    step = _jax_step(jmodel)
    jstate, jlosses = host, []
    for b in batches:
        jstate, m = step(jstate, {"tokens": b})
        jlosses.append(float(m["loss"]))
    np.testing.assert_allclose(run.losses, jlosses, rtol=2e-2)


@pytest.mark.parametrize("fault", ["shifted_batch", "skipped_update"])
@pytest.mark.parametrize("at", [0, 3, 8])
def test_step_check_catches_a_wrong_batch_or_update(jax_init, elastic_run, fault, at):
    """:func:`_check_steps` fails on the elastic run's record with one
    fault at step ``at``: the batch drawn one sequence later, or the step's
    update left out (the state after it is the state before it)."""
    jmodel, _ = jax_init
    _, jcfg = _cfgs()
    _, _, states, _ = elastic_run
    per_step, *_, per_dev = _jax_schedule(9)
    batches = _jax_elastic_batches(jcfg.vocab, per_step, per_dev)
    states = list(states)
    if fault == "shifted_batch":
        n = per_step[at] * per_dev
        batches[at] = JaxTokenStream(jcfg.vocab, 64, seed=0).batch(
            range(at * n + 1, (at + 1) * n + 1))
    else:
        states[at + 1] = states[at]
    with pytest.raises(AssertionError):
        _check_steps(jmodel, states[:at + 2], batches[:at + 1])


@pytest.mark.parametrize("steps,ckpt_every", [(20, 10), (2, 1), (1, 10)])
def test_train_elastic_schedule_edges(steps, ckpt_every, tmp_path):
    """The JAX rules at ``--steps 20`` (the default) and where the join and
    the leave fall on the same step or on step 0."""
    cfg, _ = _cfgs()
    ck = AsyncCheckpointer(tmp_path, keep=3)
    run = launch.train_elastic(build_model(cfg, device="cpu"),
                               ShapeCell("launch", 16, 8, "train"), steps,
                               ckpt=ck, ckpt_every=ckpt_every)
    ck.close()
    per_step, joins, leaves, ckpts, _ = _jax_schedule(steps, ckpt_every=ckpt_every)
    assert run.n_active == per_step and run.ckpt_steps == ckpts
    assert [(e.kind, e.step) for e in run.events] == \
        [("scale-out", s) for s in joins] + [("scale-in", s) for s in leaves]
    assert [len(run.losses), run.trainer.step_count] == [steps, steps]
    assert all(np.isfinite(run.losses))


# ---------------------------------------------------------------------------
# The command line.
# ---------------------------------------------------------------------------


def test_plain_checkpoints_load_in_jax_bit_for_bit(jax_init, tmp_path, capsys):
    """``main --ckpt DIR --ckpt-every 1 --steps 3`` writes the states after
    steps 0, 1 and 2. Each loads through the JAX package's
    ``load_checkpoint`` equal bit for bit to the state after that step in a
    run of that many steps, and to the port's own load: the save copies to
    the host before the next step updates the state in place."""
    _, host = jax_init
    ckdir = tmp_path / "ck"
    assert launch.main(["--arch", "gpt2", "--steps", "3", "--ckpt", str(ckdir),
                        "--ckpt-every", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.rstrip().endswith("TRAIN_OK") and "step    2 loss" in out
    cfg, _ = _cfgs()
    model = build_model(cfg, device="cpu")
    for k in range(3):
        path = ckdir / f"step_{k:08d}.ckpt"
        state = launch.train_plain(model, CELL, k + 1).state
        assert _same_bits(jax_load_checkpoint(path, host), state), k
        assert _same_bits(T.tree_map(lambda t: t.numpy(), load_checkpoint(path, state)),
                          state), k


def test_elastic_cli_runs_as_a_module(jax_init, tmp_path):
    """``python -m repro_torch.launch.train --arch gpt2 --elastic --steps 9
    --ckpt DIR --ckpt-every 3 --device cpu`` in its own process: exit 0,
    the JAX launcher's lines, and checkpoints at steps 0, 3 and 6 that the
    JAX package and the port load alike, with finite leaves."""
    _, host = jax_init
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "gpt2",
         "--elastic", "--steps", "9", "--ckpt", str(tmp_path), "--ckpt-every", "3",
         "--device", "cpu"], capture_output=True, text=True, env=env, cwd=tmp_path,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert len(lines) == 5, lines
    assert lines[1].startswith("[elastic] scale-out -> 5 devices (")
    assert lines[3] == "[elastic] scale-in -> 4 devices"
    assert [ln.split()[:2] for ln in lines[0::2]] == [["step", "0"], ["step", "5"],
                                                     ["step", "8"]]
    paths = sorted(tmp_path.glob("*.ckpt"))
    assert [p.name for p in paths] == [f"step_{s:08d}.ckpt" for s in (0, 3, 6)]
    skeleton = state_from_numpy(host, "cpu")
    for p in paths:
        ours = load_checkpoint(p, skeleton)
        assert all(bool(torch.isfinite(leaf).all()) for leaf in T.leaves(ours)
                   if leaf.is_floating_point())
        assert _same_bits(jax_load_checkpoint(p, host), ours)


def test_lower_only_exits_non_zero(capsys):
    """``--lower-only`` prints the dry run's single-mesh record of the full
    config, without its trace analysis, and exits 0."""
    assert launch.main(["--arch", "gpt2", "--lower-only", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.rstrip().splitlines()[-1]
    assert out.startswith("{'arch': 'gpt2', 'shape': 'train_4k', 'mesh': 'single'")
    assert "'roofline'" in out and "'memory_analysis'" in out
    assert "trace_analysis" not in out


def test_launcher_without_cuda_raises():
    """No ``--device``: CUDA or an error, never a quiet fall back to the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main(["--arch", "gpt2", "--steps", "1"])


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-1.2b"])
def test_plain_mode_on_the_recurrent_families(arch, capsys):
    assert launch.main(["--arch", arch, "--steps", "2", "--batch", "2", "--seq", "16",
                        "--device", "cpu"]) == 0
    assert capsys.readouterr().out.rstrip().endswith("TRAIN_OK")


def test_torch_elastic_training_example(capsys):
    spec = importlib.util.spec_from_file_location(
        "torch_elastic_training", ROOT / "examples" / "torch_elastic_training.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    assert module.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "ELASTIC_DEMO_OK" in out
    assert "scale-out -> 6 devices" in out and "scale-in -> 5 devices" in out
