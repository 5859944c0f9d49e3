"""The port's ElasticTrainer on the CPU, against the JAX train step and
the JAX replication planner.

3 steps on 2 logical devices, an int8 scale-out, 2 steps on 3, a scale-in,
1 step on 2. The per-step losses must follow the JAX ``make_train_step``
applied to the same global batches; the scale-out must leave the state
bit-unchanged and plan exactly as the JAX ``plan_replication`` does.
"""
import ast
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.replication import encode_state as jax_encode_state
from repro.core.replication import plan_replication as jax_plan_replication
from repro.core.sharding_alg import NeighborLink as JaxLink
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.convert import state_from_numpy
from repro_torch.core.replication import flatten_state
from repro_torch.core.sharding_alg import NeighborLink
from repro_torch.data import ShardedLoader, TokenStream
from repro_torch.elastic import ElasticTrainer
from repro_torch.kernels import ops
from repro_torch.models import build_model

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEQ = 32
PER_DEV = 2


def _link(device_id: int):
    """Heterogeneous links as in examples/elastic_training.py."""
    fast = device_id % 2 == 0
    return (0.002 if fast else 0.01,
            1 / (500e6 / 8) if fast else 1 / (120e6 / 8), 0.0)


@pytest.fixture(scope="module")
def run():
    jcfg = jax_get_config("gpt2").reduced()
    jmodel = jax_build_model(jcfg)
    jstate0 = jmodel.init_train_state(jax.random.PRNGKey(3))
    host = jax.tree.map(np.asarray, jstate0)

    cfg = get_config("gpt2").reduced()
    loader = ShardedLoader(TokenStream(cfg.vocab, SEQ, seed=0), 256, [0],
                           PER_DEV)
    tr = ElasticTrainer(build_model(cfg, device="cpu"), initial=2,
                        per_device_batch=PER_DEV,
                        link_model=lambda i: NeighborLink(*_link(i)),
                        on_reshard=loader.reshard, codec="int8")
    tr.init(state=state_from_numpy(host, "cpu"))
    batches, losses = [], []

    def steps(n):
        for _ in range(n):
            toks = np.concatenate([loader.next_batch(i)
                                   for i in tr.device_ids()])
            batches.append(toks)
            losses.append(tr.step({"tokens": toks})["loss"])

    ops.reset_launches()
    steps(3)
    before, _ = flatten_state(tr.state)
    before = before.clone()
    ev = tr.scale_out()
    after, _ = flatten_state(tr.state)
    steps(2)
    ev_in = tr.scale_in()
    steps(1)
    return dict(tr=tr, jmodel=jmodel, jstate0=jstate0, batches=batches,
                losses=losses, before=before, after=after, ev=ev, ev_in=ev_in)


def test_losses_follow_the_jax_train_step(run):
    """rtol 2e-2: bf16 activations round differently in the two frameworks;
    the small drift that accumulates over six steps stays inside it."""
    step = jax.jit(run["jmodel"].make_train_step())
    jstate, jlosses = run["jstate0"], []
    for toks in run["batches"]:
        jstate, m = step(jstate, {"tokens": toks})
        jlosses.append(float(m["loss"]))
    assert [b.shape[0] for b in run["batches"]] == [4, 4, 4, 6, 6, 4]
    assert all(np.isfinite(run["losses"]))
    np.testing.assert_allclose(run["losses"], jlosses, rtol=2e-2)


def test_scale_out_leaves_state_bit_unchanged(run):
    assert torch.equal(run["before"], run["after"])


def test_plan_summary_matches_jax_plan(run):
    tr, ev = run["tr"], run["ev"]
    links = {i: JaxLink(*_link(i)) for i in (0, 1)}
    jplan = jax_plan_replication(run["jstate0"], links)
    s = ev.plan_summary
    assert s["shard_size"] == jplan.assignment.shard_size
    assert s["n_shards"] == jplan.assignment.n_shards
    assert s["bytes_per_source"] == jplan.bytes_per_source
    assert s["predicted_completion_s"] == jplan.assignment.completion_s
    _, manifest, wire = jax_encode_state(jax.tree.map(np.asarray, run["jstate0"]),
                                         "int8", verify_kernel=False)
    assert s["codec"]["payload_bytes"] == manifest.total_bytes
    assert s["codec"]["wire_bytes"] == wire
    assert ev.kind == "scale-out" and ev.step == 3


def test_membership_and_metrics(run):
    tr = run["tr"]
    assert tr.device_ids() == [0, 1] and tr.step_count == 6
    assert run["ev_in"].kind == "scale-in" and run["ev_in"].device == "cpu#2"
    snap = tr.metrics_snapshot()
    assert snap["n_active"] == 2
    assert {n: len(t) for n, t in snap["step_times"].items()} == {2: 4, 3: 2}
    rep = tr.straggler_report()
    assert rep[3]["n_steps"] == 1 and rep[2]["n_steps"] == 3
    # The CPU path runs the plain versions: no kernel was launched.
    assert ops.launches == {"shard_encode": 0, "shard_decode": 0,
                            "flash_attention": 0, "wkv6": 0, "ssd": 0,
                            "flash_attention_bwd": 0}
    with pytest.raises(ValueError):
        tr.step({"tokens": np.zeros((3, SEQ + 1), np.int32)})


def test_link_events_reshape_neighbors():
    cfg = get_config("gpt2").reduced()
    tr = ElasticTrainer(build_model(cfg, device="cpu"), initial=2,
                        link_model=lambda i: NeighborLink(*_link(i)))
    tr.apply_link_event("link-degrade", [1], bandwidth_mbps=10.0, link=(1, 5))
    assert tr.effective_link(1).trans_s_per_byte == pytest.approx(1 / (10e6 / 8))
    tr.apply_link_event("link-failure", [1], link=(1, 6))
    assert tr.effective_link(1).trans_s_per_byte == 1.0
    tr.apply_link_event("link-join", [1], link=(1, 6))
    tr.apply_link_event("link-join", [1], link=(1, 5))
    assert tr.effective_link(1) == NeighborLink(*_link(1))
    tr.apply_link_event("link-loss", [0], loss_rate=0.5, link=(0, 7))
    assert tr.effective_link(0).trans_s_per_byte == pytest.approx(2 / (500e6 / 8))
    with pytest.raises(ValueError):
        tr.apply_link_event("bogus", [0])


def _catches_import_error(handler: ast.ExceptHandler) -> bool:
    types = (handler.type.elts if isinstance(handler.type, ast.Tuple)
             else [handler.type])
    return any(isinstance(t, ast.Name)
               and t.id in ("ImportError", "ModuleNotFoundError") for t in types)


def _imports(path: pathlib.Path):
    """``(module, guarded)`` for every absolute import in ``path``;
    ``guarded`` when it sits in the body of a ``try`` that catches
    ``ImportError``."""
    tree = ast.parse(path.read_text(), str(path))
    guarded = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Try) and any(
                _catches_import_error(h) for h in node.handlers):
            guarded.update(id(sub) for stmt in node.body for sub in ast.walk(stmt))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from ((a.name, id(node) in guarded) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module, id(node) in guarded


def test_port_imports_neither_jax_nor_repro():
    """The port imports torch, numpy and the standard library: never JAX,
    ``repro``, ``networkx`` or ``msgpack``, and the optional ``zstandard``
    only where an ``ImportError`` is caught."""
    port = ROOT / "src" / "repro_torch"
    files = sorted(port.rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "examples" / "torch_elastic_training.py"]
    assert len(files) > 20
    names = {p.relative_to(port).as_posix() for p in files
             if "repro_torch" in p.parts}
    assert {"kernels/wkv6.py", "kernels/ssd.py", "models/rwkv6.py",
            "models/mamba2.py", "models/zamba2.py", "configs/rwkv6_1_6b.py",
            "configs/zamba2_1_2b.py", "core/engine.py", "core/recovery.py",
            "core/plans.py", "scenarios/trace.py", "checkpoint/__init__.py",
            "checkpoint/_msgpack.py", "checkpoint/async_ckpt.py",
            "checkpoint/memory_ckpt.py", "core/goodput.py", "core/telemetry.py",
            "launch/train.py", "core/graph.py", "core/topology.py",
            "core/simulator.py", "core/monitor.py", "core/negotiation.py",
            "core/baselines.py", "core/control.py", "scenarios/generators.py",
            "scenarios/__init__.py"} <= names
    for path in files:
        for name, guarded in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "networkx",
                               "msgpack"), (path, name)
            assert top != "zstandard" or guarded, (path, name)
    assert ("zstandard", True) in set(_imports(port / "checkpoint" / "async_ckpt.py"))
