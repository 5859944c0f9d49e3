"""The port's churn pipeline against the JAX package's: traces made by the
JAX generators and saved by the JAX ``ScenarioTrace.save`` are loaded by
the port's loader and replayed through the port's ``TrainerBackend``.

* Over the membership-only trainer double (``tools/trace_report.py``) the
  port's ledger is byte-identical to the JAX ``TrainerBackend``'s.
* On the port's real ``ElasticTrainer`` (reduced GPT-2 on the CPU, 12
  logical devices whose ids are the topology's node ids) the recovery
  decisions and the span stream equal the JAX simulator's
  (``decision_digest``, ``span_digest``; the latter is the JAX function fed
  the port's ledger, until the ledger analytics are ported).
* The trainer's recovery tiers restore bit for bit, and the reshard and
  recovery layers decide as the JAX ones do.
"""
import importlib.util
import math
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import SimCluster, random_edge_topology
from repro.core import plans as jplans
from repro.core import recovery as jrecovery
from repro.core.engine import ChurnEngine as JaxChurnEngine
from repro.core.engine import ChurnEvent as JaxChurnEvent
from repro.core.engine import run_trace_sim
from repro.core.recovery import decision_digest
from repro.core.telemetry import span_digest
from repro.elastic.trainer import TrainerBackend as JaxTrainerBackend
from repro.models import build_model as jax_build_model
from repro.scenarios import (
    checkpointed_training,
    link_flaps,
    mixed_faults,
    poisson_churn,
    reshard_churn,
    scheduler_churn,
)
from repro.scenarios import ScenarioTrace as JaxScenarioTrace
from repro_torch import tree as T
from repro_torch.checkpoint import AsyncCheckpointer, MemoryReplicaStore
from repro_torch.configs import get_config
from repro_torch.convert import state_from_numpy
from repro_torch.core import plans as tplans
from repro_torch.core import recovery as trecovery
from repro_torch.core.engine import ChurnEngine, ChurnEvent
from repro_torch.core.replication import build_manifest, flatten_state
from repro_torch.elastic import ElasticTrainer, LogicalDevice, TrainerBackend
from repro_torch.models import build_model
from repro_torch.scenarios import ScenarioTrace

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from tools.trace_report import _MembershipTrainer  # noqa: E402

MB = 2 ** 20
SEQ = 16


def _topo():
    return random_edge_topology(12, seed=1)


def _int8_joins(trace):
    for ev in trace.events:
        if ev.kind == "join":
            ev.codec = "int8"
    return trace


#: name -> (trace factory, TrainerBackend kwargs), the JAX generators.
TRACES = {
    "mixed_faults": (lambda: mixed_faults(_topo(), seed=5, horizon_s=120.0), {}),
    "reshard_churn": (lambda: reshard_churn(sorted(_topo().active_nodes()),
                                            seed=4, n_failures=4, n_joins=2),
                      {"reshard": "auto"}),
    "checkpointed_training": (lambda: checkpointed_training(
        sorted(_topo().active_nodes()), seed=3, horizon_s=150.0), {}),
    "scheduler_churn": (lambda: scheduler_churn(_topo(), seed=2, horizon_s=60.0,
                                                n_joins_after=2), {}),
    "link_flaps": (lambda: link_flaps(_topo(), seed=6, horizon_s=60.0,
                                      n_flaps=5), {}),
    "poisson_churn_int8": (lambda: _int8_joins(poisson_churn(
        sorted(_topo().active_nodes()), seed=7, horizon_s=150.0,
        rate_join=0.05, rate_leave=0.05, failure_fraction=0.5)), {}),
}


def _saved_and_loaded(name, tmp_path):
    """The trace saved by the JAX package, loaded by the JAX and the port
    loaders."""
    path = TRACES[name][0]().save(tmp_path / f"{name}.jsonl")
    return JaxScenarioTrace.load(path), ScenarioTrace.load(path)


# ---------------------------------------------------------------------------
# Traces and events.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(TRACES))
def test_trace_file_round_trips_across_packages(name, tmp_path):
    jtrace, ttrace = _saved_and_loaded(name, tmp_path)
    assert (ttrace.name, ttrace.seed, ttrace.meta) == \
        (jtrace.name, jtrace.seed, jtrace.meta)
    assert [e.to_json() for e in ttrace] == [e.to_json() for e in jtrace]
    assert ttrace.kinds() == jtrace.kinds()
    ttrace.save(tmp_path / "again.jsonl")
    jtrace.save(tmp_path / "jax_again.jsonl")
    assert (tmp_path / "again.jsonl").read_bytes() == \
        (tmp_path / "jax_again.jsonl").read_bytes()


@pytest.mark.parametrize("kw", [dict(kind="bogus"),
                                dict(kind="join", reshard="sometimes"),
                                dict(kind="node-failure", recovery="pray")])
def test_churn_event_rejects_unknown_values(kw):
    with pytest.raises(ValueError):
        ChurnEvent(t=0.0, **kw)
    with pytest.raises(ValueError):
        JaxChurnEvent(t=0.0, **kw)


# ---------------------------------------------------------------------------
# The TrainerBackend over the membership double: byte-identical ledgers.
# ---------------------------------------------------------------------------


def _double_ledger(backend_cls, engine_cls, trace, policy, kw):
    tr = _MembershipTrainer(sorted(_topo().active_nodes()))
    backend = backend_cls(tr, min_active=2, policy=policy,
                          state_bytes=32 * MB, tensor_sizes=[MB] * 32, **kw)
    return engine_cls(backend).run(list(trace))


@pytest.mark.parametrize("policy", ["fixed", "adaptive"])
@pytest.mark.parametrize("name", sorted(TRACES))
def test_backend_ledger_byte_identical_to_jax(name, policy, tmp_path):
    jtrace, ttrace = _saved_and_loaded(name, tmp_path)
    kw = TRACES[name][1]
    jledger = _double_ledger(JaxTrainerBackend, JaxChurnEngine, jtrace, policy, kw)
    tledger = _double_ledger(TrainerBackend, ChurnEngine, ttrace, policy, kw)
    assert len(tledger) >= len(ttrace)
    assert tledger.canonical_bytes() == jledger.canonical_bytes()
    assert tledger.digest() == jledger.digest()


# ---------------------------------------------------------------------------
# The reshard and recovery layers.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["never", "auto", "always"])
def test_decide_reshard_matches_jax(mode):
    S, sizes = 64 * MB, [2 * MB] * 31 + [MB + 4]
    jpol = jplans.default_reshard_policy(mode, S)
    tpol = tplans.default_reshard_policy(mode, S)
    jcur = tcur = None
    for devs in ([0, 1, 2, 3, 4, 5, 6, 7], [0, 1, 2, 3, 4, 5], [0, 1, 2, 3],
                 [0, 2, 3], [0, 2, 3, 9]):
        jd, jb = jplans.decide_reshard(jpol, jcur, devs, S, sizes)
        td, tb = tplans.decide_reshard(tpol, tcur, devs, S, sizes)
        assert tb.to_json() == jb.to_json()
        assert (td is None) == (jd is None)
        if jd is not None:
            assert td["plan"].to_json() == jd["plan"].to_json()
            assert {k: v for k, v in td.items() if k != "plan"} == \
                {k: v for k, v in jd.items() if k != "plan"}
            jcur, tcur = jd["plan"], td["plan"]
        assert [p.to_json() for p in tplans.candidate_plans(devs)] == \
            [p.to_json() for p in jplans.candidate_plans(devs)]
    assert tplans.replicated_fraction(sizes, 4) == \
        jplans.replicated_fraction(sizes, 4)
    assert tplans.trim_tensor_sizes(sizes, 5 * MB + 3) == \
        jplans.trim_tensor_sizes(sizes, 5 * MB + 3)


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_reshard_plan_matches_jax(codec):
    """``reshard_plan`` over the JAX topology (the port takes any object
    with its link queries): the same fetches, bytes and routes."""
    topo = _topo()
    devs = tuple(sorted(topo.active_nodes()))[:8]
    S = 64 * MB + 12
    moves = [(None, (2, 4)), ((2, 4), (4, 2)), ((4, 2), (1, 8))]
    for old, new in moves:
        args = []
        for P in (jplans.ParallelismPlan, tplans.ParallelismPlan):
            args.append((P(old, devices=devs) if old else None,
                         P(new, devices=devs)))
        jr = jplans.reshard_plan(*args[0], topo, S, codec=codec)
        tr = tplans.reshard_plan(*args[1], topo, S, codec=codec)
        assert (tr.moved_bytes, tr.lost_bytes) == (jr.moved_bytes, jr.lost_bytes)
        assert tr.moved_bytes == tplans.reshard_moved_bytes(*args[1], S)
        assert sorted(tr.fetches) == sorted(jr.fetches)
        for node, fetch in jr.fetches.items():
            assert tr.fetches[node].summary() == fetch.summary()
            assert tr.fetches[node].routes == fetch.routes


def _contexts(mod):
    plan = mod.ParallelismPlan((2, 2), devices=(0, 1, 2, 3))
    return [
        mod.FaultContext("node-failure", 1.0, (5,), 7, 2, 64 * MB),
        mod.FaultContext("node-failure", 2.0, (5,), 7, 2, 64 * MB,
                         ckpt_available=True, ckpt_age_s=3.0),
        mod.FaultContext("node-failure", 3.0, (5,), 7, 2, 64 * MB,
                         replica_feasible=False, ckpt_available=True,
                         override="park-and-degrade"),
        mod.FaultContext("stream-churn", 4.0, (1, 2), 7, 2, 64 * MB,
                         inflight_credit_bytes=5 * MB, link_mbps=(50.0, 200.0)),
        mod.FaultContext("re-adoption", 5.0, (9,), 7, 2, 64 * MB,
                         replicated=False),
        mod.FaultContext("membership-change", 6.0, (0,), 3, 2, 64 * MB,
                         plan=plan, devices=(0, 1, 3),
                         tensor_sizes=(2 * MB,) * 32),
        mod.FaultContext("membership-change", 7.0, (0,), 8, 2, 64 * MB,
                         reshard_mode="always", devices=tuple(range(8)),
                         tensor_sizes=(2 * MB,) * 32),
    ]


@pytest.mark.parametrize("policy", ["fixed", "fixed-checkpoint", "fixed-park",
                                    "adaptive"])
def test_recovery_decisions_match_jax(policy):
    jpol = jrecovery.make_policy(policy, reshard="auto", state_bytes=64 * MB)
    tpol = trecovery.make_policy(policy, reshard="auto", state_bytes=64 * MB)
    for key, value in (("detection", 3.0), ("handling", 0.4)):
        jpol.observe(key, value)
        tpol.observe(key, value)
    for jctx, tctx in zip(_contexts(jrecovery),
                          _contexts(trecovery)):
        jdec, tdec = jpol.decide(jctx), tpol.decide(tctx)
        assert trecovery.decision_detail(tctx, tdec) == \
            jrecovery.decision_detail(jctx, jdec)
        assert (tdec.reshard is None) == (jdec.reshard is None)
    assert tpol.costs.to_json() == jpol.costs.to_json()
    with pytest.raises(ValueError):
        trecovery.make_policy("sometimes")


# ---------------------------------------------------------------------------
# The real trainer: reduced GPT-2 on the CPU.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gpt2_state():
    """A reduced GPT-2 train state from the JAX init, as numpy."""
    model = jax_build_model(jax_get_config("gpt2").reduced())
    return jax.tree.map(np.asarray, model.init_train_state(jax.random.PRNGKey(0)))


def _trainer(host, node_ids, spare=0, initial=None, **kw):
    """The port's trainer on the CPU: one logical device per trace node id,
    plus ``spare`` free devices for joins."""
    top = max(node_ids) + 1
    ids = list(node_ids) + [top + k for k in range(spare)]
    cpu = torch.device("cpu")
    tr = ElasticTrainer(build_model(get_config("gpt2").reduced(), device="cpu"),
                        devices=[LogicalDevice(i, cpu) for i in ids],
                        initial=len(node_ids) if initial is None else initial,
                        per_device_batch=1, **kw)
    tr.init(state=state_from_numpy(host, "cpu"))
    return tr


def _batch_fn(tr, seed=0):
    rng = np.random.default_rng(seed)
    return lambda: {"tokens": rng.integers(0, 256, size=(tr.global_batch, SEQ + 1))}


def test_real_trainer_decision_digest_matches_simulator(gpt2_state):
    """tests/test_recovery_policy.py's adaptive parity trace, replayed on
    the port's trainer with a step before every event."""
    S, sizes = 64 * MB, [2 * MB] * 32
    topo = _topo()
    nodes = sorted(topo.active_nodes())  # before the simulator fails some
    trace = reshard_churn(nodes, seed=4, n_failures=4, n_joins=0)
    cl = SimCluster(topo, state_bytes=S, tensor_sizes=sizes)
    cl.train(1)
    sim_ledger, _ = run_trace_sim(cl, trace, policy="adaptive", reshard="auto")
    tr = _trainer(gpt2_state, nodes)
    ledger = tr.replay_scenario([ChurnEvent.from_json(e.to_json()) for e in trace],
                                batch_fn=_batch_fn(tr), policy="adaptive",
                                reshard="auto", state_bytes=S, tensor_sizes=sizes)
    n_decided = sum(1 for r in ledger if r.action == "recovery-decided")
    assert n_decided == sum(1 for r in sim_ledger
                            if r.action == "recovery-decided") > 0
    assert decision_digest(ledger) == decision_digest(sim_ledger)
    assert tr.step_count == len(trace) and len(tr.active) == 8
    reshards = [e for e in tr.events if e.kind == "reshard"]
    assert reshards and tr.tp == reshards[-1].plan_summary["shape"][1]


def test_real_trainer_forced_park_matches_simulator(gpt2_state):
    topo = _topo()
    nodes = sorted(topo.active_nodes())
    events = [JaxChurnEvent(5.0, "node-failure", node=5,
                            recovery="park-and-degrade"),
              JaxChurnEvent(20.0, "node-failure", node=7)]
    cl = SimCluster(topo, state_bytes=32 * MB, tensor_sizes=[MB] * 32)
    cl.train(1)
    sim_ledger, _ = run_trace_sim(cl, events, policy="fixed")
    tr = _trainer(gpt2_state, nodes)
    backend = TrainerBackend(tr, batch_fn=_batch_fn(tr), min_active=2,
                             state_bytes=32 * MB, tensor_sizes=[MB] * 32,
                             policy="fixed")
    ledger = ChurnEngine(backend).run(
        [ChurnEvent.from_json(e.to_json()) for e in events])
    assert decision_digest(ledger) == decision_digest(sim_ledger)
    assert [r.subject for r in ledger if r.action == "parked-degraded"] == [(5,)]
    # Unmapped trace nodes shed the newest devices, as in the JAX backend.
    assert backend.degraded and tr.device_ids() == nodes[:10]


def test_real_trainer_span_digest_matches_simulator(gpt2_state):
    """tests/test_telemetry.py's mixed_faults trace: node faults, lossy
    links, a scheduler fault, checkpoint requests and two joins."""
    topo = _topo()
    nodes = sorted(topo.active_nodes())
    trace = mixed_faults(topo, seed=5, horizon_s=120.0)
    cl = SimCluster(topo, state_bytes=32 * MB, tensor_sizes=[MB] * 32)
    cl.train(1)
    sim_ledger, _ = run_trace_sim(cl, list(trace))
    tr = _trainer(gpt2_state, nodes, spare=4)
    ledger = tr.replay_scenario([ChurnEvent.from_json(e.to_json()) for e in trace],
                                batch_fn=_batch_fn(tr), state_bytes=32 * MB,
                                tensor_sizes=[MB] * 32)
    assert span_digest(ledger) == span_digest(sim_ledger)
    assert {r.action for r in ledger} >= {"scale-out", "node-failed",
                                          "failover", "link-lossy",
                                          "ckpt-skipped-no-checkpointer"}
    assert all(math.isfinite(t) for ts in tr._step_times.values() for t in ts)


# -- the recovery tiers (tests/test_checkpoint_churn.py) ---------------------


def test_replica_and_checkpoint_restore_bit_identical(gpt2_state, tmp_path):
    tr = _trainer(gpt2_state, [0, 1])
    ck = AsyncCheckpointer(tmp_path)
    tr.attach_recovery(replica_store=MemoryReplicaStore(), checkpointer=ck,
                       owner=0)
    assert tr.checkpoint(step=7) == {"step": 7, "tiers": ["replica", "checkpoint"]}
    golden = flatten_state(tr.state)[0].clone()
    manifest = build_manifest(tr.state)

    def clobber():
        tr.state = T.tree_map(torch.zeros_like, tr.state)

    clobber()
    assert tr.restore_from("replica") == 7
    from_replica = flatten_state(tr.state)[0]
    tr.step(_batch_fn(tr)())  # in place, on the restored leaves
    clobber()
    assert tr.restore_from("checkpoint") == 7
    from_ckpt = flatten_state(tr.state)[0]
    ck.close()
    assert build_manifest(tr.state).entries == manifest.entries
    assert torch.equal(from_replica, golden)
    assert torch.equal(from_ckpt, golden)  # the A/B acceptance: bit-identical
    assert tr.restore_from("replica") == 7
    assert torch.equal(flatten_state(tr.state)[0], golden)


def test_trainer_backend_checkpoint_event_saves_and_skips(gpt2_state):
    """The trace ``checkpoint`` event: ``ckpt-saved`` with a tier attached,
    the simulator's terminal skip without one."""
    tr = _trainer(gpt2_state, [0, 1])
    ledger = tr.replay_scenario([ChurnEvent(t=1.0, kind="checkpoint")],
                                min_active=1)
    assert ledger.actions() == ["ckpt-skipped-no-checkpointer"]
    store = MemoryReplicaStore()
    tr.attach_recovery(replica_store=store)
    ledger = tr.replay_scenario([ChurnEvent(t=2.0, kind="checkpoint")],
                                min_active=1, batch_fn=_batch_fn(tr))
    assert ledger.actions() == ["ckpt-saved"]
    assert next(iter(ledger)).detail == {"step": 1, "tiers": ["replica"]}
    tree, step = store.restore(0)
    assert step == tr.step_count == 1
    assert torch.equal(flatten_state(tree)[0], flatten_state(tr.state)[0])


def test_restore_without_tier_raises(gpt2_state):
    tr = _trainer(gpt2_state, [0, 1])
    with pytest.raises(RuntimeError):
        tr.checkpoint()
    with pytest.raises(RuntimeError):
        tr.restore_from("replica")
    tr.attach_recovery(replica_store=MemoryReplicaStore())
    with pytest.raises(RuntimeError):
        tr.restore_from("checkpoint")
    with pytest.raises(ValueError):
        tr.restore_from("tape")
    with pytest.raises(KeyError):  # attached, but nothing pushed yet
        tr.restore_from("replica")


def test_restore_from_empty_checkpoint_dir_raises(gpt2_state, tmp_path):
    tr = _trainer(gpt2_state, [0, 1])
    ck = AsyncCheckpointer(tmp_path)
    tr.attach_recovery(checkpointer=ck)
    with pytest.raises(RuntimeError, match="no checkpoint on disk"):
        tr.restore_from("checkpoint")
    ck.close()


def test_apply_reshard_records_the_layout_and_membership_resets_it(gpt2_state):
    tr = _trainer(gpt2_state, [0, 1, 2, 3], spare=2)
    assert tr.tp == 1 and tr.parallelism_plan().to_json() == {
        "shape": [4, 1], "axes": ["data", "model"], "microbatch": 1,
        "devices": [0, 1, 2, 3]}
    before = flatten_state(tr.state)[0].clone()
    ev = tr.apply_reshard(2, microbatch=3)
    assert (ev.kind, ev.plan_summary) == ("reshard", {"shape": [2, 2],
                                                      "microbatch": 3})
    assert tr.parallelism_plan().shape == (2, 2)
    assert torch.equal(flatten_state(tr.state)[0], before)  # nothing moved
    with pytest.raises(ValueError):
        tr.apply_reshard(3)
    with pytest.raises(ValueError):
        tr.apply_reshard(0)
    tr.scale_out()
    assert tr.tp == 1 and tr.parallelism_plan().microbatch == 1
    tr.apply_reshard(5)
    tr.scale_in()
    assert tr.parallelism_plan().shape == (4, 1)


# -- chip_smoke.py's self-healing replay, on the CPU --------------------------


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_self_healing_replay_on_the_cpu(gpt2_state, tmp_path):
    """``chip_smoke.self_healing``'s trace and settings on the reduced model,
    with GPT-2's full state sizes for the policies: the ledger's actions
    are ``SELF_HEALING_ACTIONS``, and both tiers restore the state the
    event-6 checkpoint pushed, bit for bit, so the step after each restore
    repeats the loss of the step after event 6."""
    cs = _chip_smoke()
    full = build_manifest(build_model(get_config("gpt2"), device="meta")
                          .init_train_state(torch.Generator()))
    assert (full.total_bytes, len(full.entries)) == (1_784_835_076, 43)
    tr = _trainer(gpt2_state, [0, 1, 2, 3], initial=2, codec="int8",
                  link_model=cs.link_model)
    ck = AsyncCheckpointer(tmp_path, keep=2)
    tr.attach_recovery(replica_store=MemoryReplicaStore(), checkpointer=ck)
    replay = dict(steps_between=1, policy="adaptive", reshard="auto",
                  state_bytes=full.total_bytes, tensor_sizes=full.tensor_sizes)
    trace = cs.self_healing_trace()
    first = tr.replay_scenario(trace[:6], batch_fn=_batch_fn(tr), **replay)
    at_ckpt = flatten_state(tr.state)[0].clone()
    second = tr.replay_scenario(trace[6:], **replay)
    assert first.actions() + second.actions() == cs.SELF_HEALING_ACTIONS
    assert [r.detail for r in list(first) + list(second)
            if r.action == "ckpt-saved"] == [
        {"step": 1, "tiers": ["replica", "checkpoint"]},
        {"step": 6, "tiers": ["replica", "checkpoint"]}]
    batch = _batch_fn(tr, seed=1)()
    original = tr.step(batch)["loss"]
    for tier in ("replica", "checkpoint"):
        assert tr.restore_from(tier) == 6
        assert torch.equal(flatten_state(tr.state)[0], at_ckpt)
        assert tr.step(batch)["loss"] == original
    ck.close()
    assert tr.step_count == 9 and tr.device_ids() == [0, 1]
    assert [e.kind for e in tr.events].count("scale-out") == 2
