"""The port's ledger analytics (``repro_torch.core.goodput`` and
``repro_torch.core.telemetry``) against the JAX package's.

The inputs are JAX simulator ledgers, copied record by record into the
port's ``EventLedger``: the generator families of
``tests/test_goodput.py`` with and without the checkpoint tier, an int8
codec replay, ``mixed_faults``, a fail-over that re-adopts and rebuilds
in-flight joins and a no-quorum freeze (``tests/test_failover.py``), and a
leave in mid-replication (``tests/test_engine.py``).
Together they reach every GoodPut category. On each, the two packages must
give byte-identical reports, span forests, validation lists, digests,
Chrome traces, markdown and metrics exposition.

Each case also replays through the port's own simulator
(``repro_torch.core.engine.run_trace_goodput``): its ledger must equal the
copy byte for byte, its analytics the JAX package's, and the simulator
collectors (``collect_network``, ``collect_monitor``, ``collect_control``,
``collect_backend``) must scrape the same exposition from both packages'
backends.
"""
import copy
import json
import math
from types import SimpleNamespace

import pytest

from repro.core import ChurnEvent as JaxChurnEvent
from repro.core import SimCluster, random_edge_topology
from repro.core import goodput as jg
from repro.core import telemetry as jt
from repro.core.engine import EventLedger as JaxEventLedger
from repro.core import engine as jengine
from repro.core.engine import run_trace_goodput
from repro.scenarios import mixed_faults
from repro_torch import scenarios as tscenarios
from repro_torch.core import engine as tengine
from repro_torch.core import goodput as tg
from repro_torch.core import negotiation as tnegotiation
from repro_torch.core import telemetry as tt
from repro_torch.core import topology as ttopology
from repro_torch.core.engine import EventLedger
from test_failover import _split_topology
from test_goodput import _cluster, _traces

MB = 2 ** 20
CKPT = {"checkpoint": "adaptive", "policy": "fixed-checkpoint"}


def _port_split_topology(side_a, side_b, cross):
    """tests/test_failover.py's ``_split_topology`` on the port's
    ``Topology``."""
    topo = ttopology.Topology()
    for n in side_a + side_b:
        topo.add_node(n, compute_s=1.0)
    for side in (side_a, side_b):
        for a, b in zip(side, side[1:]):
            topo.add_link(a, b, ttopology.Link(500.0, 0.005))
        if len(side) > 2:
            topo.add_link(side[0], side[-1], ttopology.Link(500.0, 0.005))
    for u, v in cross:
        topo.add_link(u, v, ttopology.Link(300.0, 0.01))
    return topo


def _port_cluster():
    """tests/test_goodput.py's ``_cluster`` on the port."""
    return tnegotiation.SimCluster(ttopology.random_edge_topology(10, seed=3),
                                   state_bytes=16 * MB, tensor_sizes=[MB] * 16)


def _port_traces():
    """tests/test_goodput.py's ``_traces`` through the port's generators."""
    topo = ttopology.random_edge_topology(10, seed=3)
    nodes = topo.active_nodes()
    S = tscenarios
    return {
        "poisson": S.poisson_churn(nodes, seed=7, horizon_s=120.0,
                                   rate_join=0.05, rate_leave=0.04),
        "diurnal": S.diurnal_waves(nodes, seed=7, horizon_s=120.0,
                                   period_s=60.0, peak_rate=0.08),
        "partition": S.regional_partition(topo, seed=7, t_cut=20.0,
                                          heal_after_s=30.0),
        "detector_stress": S.detector_stress(topo, seed=7, horizon_s=60.0),
        "scheduler_churn": S.scheduler_churn(topo, seed=7, horizon_s=60.0),
    }


#: What the case factories take from each package.
JAX_SIM = SimpleNamespace(
    SimCluster=SimCluster, random_edge_topology=random_edge_topology,
    ChurnEvent=JaxChurnEvent, mixed_faults=mixed_faults,
    split_topology=_split_topology, cluster=_cluster, traces=_traces)
PORT_SIM = SimpleNamespace(
    SimCluster=tnegotiation.SimCluster,
    random_edge_topology=ttopology.random_edge_topology,
    ChurnEvent=tengine.ChurnEvent, mixed_faults=tscenarios.mixed_faults,
    split_topology=_port_split_topology, cluster=_port_cluster,
    traces=_port_traces)


def _no_quorum(P=JAX_SIM):
    """tests/test_failover.py's 3 | 3 split: the election gives up and the
    cluster freezes (the ``leaderless`` category)."""
    cross = [(2, 3), (0, 4)]
    cl = P.SimCluster(P.split_topology([0, 1, 2], [3, 4, 5], cross),
                      state_bytes=16 * MB, tensor_sizes=[MB] * 16)
    cl.train(1)
    t0 = cl.sim.now
    events = [P.ChurnEvent(t=t0 + 0.5 + 0.01 * i, kind="link-failure", u=u, v=v)
              for i, (u, v) in enumerate(cross)]
    events += [P.ChurnEvent(t=t0 + 2.0, kind="scheduler-fault"),
               P.ChurnEvent(t=t0 + 5.0, kind="join", node=100,
                            links={1: (200.0, 0.01), 2: (300.0, 0.01)})]
    return cl, events


def _readoption(P=JAX_SIM):
    """tests/test_failover.py's re-adoption story: joins in flight when the
    scheduler dies, one re-adopted and one rebuilt (flows across seqs)."""
    topo = P.random_edge_topology(8, seed=0)
    cl = P.SimCluster(topo, state_bytes=128 * MB, tensor_sizes=[MB] * 128)
    cl.train(1)
    t0 = cl.sim.now
    u, v = [e for e in sorted(cl.topo.g.edges) if cl.scheduler.node not in e][0]
    return cl, [
        P.ChurnEvent(t=t0 + 0.5, kind="link-loss", u=u, v=v, loss_rate=0.0),
        P.ChurnEvent(t=t0 + 1.5, kind="join", node=100,
                     links={1: (50.0, 0.01), 2: (60.0, 0.01)}),
        P.ChurnEvent(t=t0 + 5.0, kind="join", node=101,
                     links={2: (50.0, 0.01), 3: (60.0, 0.01)}),
        P.ChurnEvent(t=t0 + 6.0, kind="scheduler-fault"),
    ]


def _replan(P=JAX_SIM):
    """tests/test_engine.py's leave in mid-replication: the join is
    re-planned from the survivors (``replication``)."""
    topo = P.random_edge_topology(8, seed=0)
    cl = P.SimCluster(topo, state_bytes=200 * MB, tensor_sizes=[4 * MB] * 50)
    cl.train(1)
    t0 = cl.sim.now
    return cl, [
        P.ChurnEvent(t=t0 + 0.1, kind="join", node=100,
                     links={1: (200.0, 0.01), 2: (300.0, 0.01), 3: (150.0, 0.02)}),
        P.ChurnEvent(t=t0 + 1.2, kind="leave", node=2),
    ]


def _from_traces(name, kw):
    def make(P=JAX_SIM):
        cl = P.cluster()
        cl.train(1)
        return cl, list(P.traces()[name])
    return make, kw


def _mixed_faults(P=JAX_SIM):
    cl = P.cluster()
    cl.train(1)
    return cl, list(P.mixed_faults(P.random_edge_topology(10, seed=3), seed=5,
                                   horizon_s=90.0))


#: name -> (cluster and events factory, run_trace_goodput kwargs).
CASES = {
    **{name: _from_traces(name, {}) for name in (
        "poisson", "diurnal", "partition", "detector_stress", "scheduler_churn")},
    **{f"{name}+ckpt": _from_traces(name, CKPT) for name in (
        "poisson", "diurnal", "partition", "detector_stress", "scheduler_churn")},
    "poisson+int8": _from_traces("poisson", {"codec": "int8"}),
    "mixed_faults": (_mixed_faults, {}),
    "readoption": (_readoption, {}),
    "replan": (_replan, {}),
    "no_quorum": (_no_quorum, {}),
}


def _to_port(jledger) -> EventLedger:
    led = EventLedger()
    for r in jledger:
        led.append(r.seq, r.t, r.kind, r.subject, r.action, copy.deepcopy(r.detail))
    return led


@pytest.fixture(scope="module")
def replays():
    """name -> (JAX ledger, the port's copy, JAX report)."""
    out = {}
    for name, (make, kw) in CASES.items():
        cl, events = make()
        jledger, _, report = run_trace_goodput(cl, events, **kw)
        out[name] = (jledger, _to_port(jledger), report)
    return out


def _window(report):
    return dict(t_start=report.t_start, t_end=report.t_end)


def _forest_dump(forest) -> str:
    """Every field of the forest, spans recursively: the dataclass reprs
    tell a tuple from a list and print every float exactly."""
    return repr((forest.t_start, forest.t_end, forest.roots, forest.intervals,
                 forest.flows, forest.rows))


class _FixedTrainer:
    """A trainer whose ``metrics_snapshot`` is one fixed snapshot, so both
    packages scrape the same wall-clock step times."""

    def metrics_snapshot(self):
        return {"n_active": 5, "step_count": 9,
                "step_times": {4: [0.0021, 0.0132, 0.31, 2.5, 12.0],
                               5: [0.004, 0.029999, 0.1, 1.0 / 3.0]}}


class _FixedBackend:
    trainer = _FixedTrainer()
    degraded = True


def test_ledger_copies_are_byte_identical(replays):
    for jledger, tledger, _ in replays.values():
        assert tledger.canonical_bytes() == jledger.canonical_bytes()


def test_cases_reach_every_goodput_category(replays):
    reached = {c for _, _, report in replays.values()
               for c, v in report.components.items() if v > 0}
    assert reached == set(jg.CATEGORIES)
    assert tg.CATEGORIES == jg.CATEGORIES and tg.PRIORITY == jg.PRIORITY


@pytest.mark.parametrize("name", sorted(CASES))
def test_goodput_report_matches_jax(name, replays):
    jledger, tledger, report = replays[name]
    w = _window(report)
    ours = tg.goodput_report(tledger, **w)
    theirs = jg.goodput_report(jledger, **w)
    assert repr(ours.components) == repr(theirs.components) == repr(report.components)
    assert json.dumps(ours.to_json(), sort_keys=True) == \
        json.dumps(theirs.to_json(), sort_keys=True)
    assert (ours.goodput_s, ours.badput_s, ours.goodput_fraction, ours.total_s) == \
        (theirs.goodput_s, theirs.badput_s, theirs.goodput_fraction, theirs.total_s)
    assert tg.ledger_intervals_attributed(tledger, **w) == \
        jg.ledger_intervals_attributed(jledger, **w)
    assert tg.ledger_intervals(tledger, **w) == jg.ledger_intervals(jledger, **w)


@pytest.mark.parametrize("name", sorted(CASES))
def test_spans_and_chrome_trace_match_jax(name, replays, tmp_path):
    jledger, tledger, report = replays[name]
    w = _window(report)
    ours, theirs = tt.build_spans(tledger, **w), jt.build_spans(jledger, **w)
    assert _forest_dump(ours) == _forest_dump(theirs)
    assert _forest_dump(tt.build_spans(tledger)) == _forest_dump(jt.build_spans(jledger))
    assert tt.validate(tledger, ours) == jt.validate(jledger, theirs) == []
    assert tt.span_digest(tledger, ours) == jt.span_digest(jledger, theirs) \
        == jt.span_digest(jledger)
    assert repr(ours.badput_components()) == repr(report.components)
    ivs = [(a, b, c) for a, b, c, _, _ in ours.intervals]
    assert tg.classify(ivs, **w) == tg.goodput_report(tledger, **w).components
    assert tt.detection_rows(tledger) == jt.detection_rows(jledger)
    assert tt.ttr_rows(tledger) == jt.ttr_rows(jledger)
    assert tt.trace_events(ours) == jt.trace_events(theirs)
    assert tt.validate_trace_events(tt.trace_events(ours)) == []
    meta = {"trace": name, "window": (report.t_start, report.t_end)}
    tt.write_chrome_trace(tmp_path / "port.json", ours, metadata=meta)
    jt.write_chrome_trace(tmp_path / "jax.json", theirs, metadata=meta)
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()


@pytest.mark.parametrize("name", sorted(CASES))
def test_markdown_and_exposition_match_jax(name, replays):
    jledger, tledger, report = replays[name]
    w = _window(report)
    ours, theirs = tt.build_spans(tledger, **w), jt.build_spans(jledger, **w)
    treport, jreport = tg.goodput_report(tledger, **w), jg.goodput_report(jledger, **w)
    assert tt.markdown_report(tledger, ours, report=treport, title=name) == \
        jt.markdown_report(jledger, theirs, report=jreport, title=name)
    assert tt.markdown_report(tledger, ours) == jt.markdown_report(jledger, theirs)
    treg, jreg = tt.MetricsRegistry(), jt.MetricsRegistry()
    tt.collect_ledger(treg, tledger)
    tt.collect_goodput(treg, treport)
    jt.collect_ledger(jreg, jledger)
    jt.collect_goodput(jreg, jreport)
    assert treg.exposition().encode() == jreg.exposition().encode()
    treg, jreg = tt.MetricsRegistry(), jt.MetricsRegistry()
    tt.collect_trainer_backend(treg, _FixedBackend(), tledger, report=treport)
    jt.collect_trainer_backend(jreg, _FixedBackend(), jledger, report=jreport)
    assert treg.exposition().encode() == jreg.exposition().encode()


@pytest.fixture(scope="module")
def port_replays():
    """name -> the port's own ``run_trace_goodput`` replay: (ledger,
    report)."""
    out = {}
    for name, (make, kw) in CASES.items():
        cl, events = make(PORT_SIM)
        ledger, _, report = tengine.run_trace_goodput(cl, events, **kw)
        out[name] = (ledger, report)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_simulator_ledger_equals_the_copy(name, replays, port_replays):
    jledger, tcopy, report = replays[name]
    ledger, treport = port_replays[name]
    assert ledger.canonical_bytes() == tcopy.canonical_bytes()
    assert json.dumps(treport.to_json(), sort_keys=True) == \
        json.dumps(report.to_json(), sort_keys=True)
    w = _window(report)
    ours, theirs = tt.build_spans(ledger, **w), jt.build_spans(jledger, **w)
    assert _forest_dump(ours) == _forest_dump(theirs)
    assert tt.validate(ledger, ours) == [] and \
        tt.span_digest(ledger, ours) == jt.span_digest(jledger, theirs)
    assert tt.detection_rows(ledger) == jt.detection_rows(jledger)
    assert tt.ttr_rows(ledger) == jt.ttr_rows(jledger)
    assert tt.trace_events(ours) == jt.trace_events(theirs)
    assert tt.markdown_report(ledger, ours, report=treport, title=name) == \
        jt.markdown_report(jledger, theirs, report=report, title=name)


def _scrapes(mod, engine, make, P, kw):
    """Each simulator collector's exposition after a replay, and all of
    them through ``collect_backend``."""
    cl, events = make(P)
    backend = engine.SimBackend(cl, accounting=True, **kw)
    ledger = engine.ChurnEngine(backend).run(events)
    out = []
    for collect, args, kwargs in (
            (mod.collect_network, (cl.net,), {"now": cl.sim.now}),
            (mod.collect_monitor, (cl.scheduler.monitor,), {"now": cl.sim.now}),
            (mod.collect_control, (backend.control,), {}),
            (mod.collect_backend, (backend, ledger), {"report": backend.goodput})):
        reg = mod.MetricsRegistry()
        collect(reg, *args, **kwargs)
        out.append(reg.exposition().encode())
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_simulator_collectors_match_jax(name):
    make, kw = CASES[name]
    ours = _scrapes(tt, tengine, make, PORT_SIM, kw)
    theirs = _scrapes(jt, jengine, make, JAX_SIM, kw)
    assert ours == theirs
    assert b"chaos_network_bytes_total" in ours[-1]


def test_trainer_exposition_matches_jax():
    treg, jreg = tt.MetricsRegistry(), jt.MetricsRegistry()
    tt.collect_trainer(treg, _FixedTrainer())
    jt.collect_trainer(jreg, _FixedTrainer())
    prom = treg.exposition()
    assert prom.encode() == jreg.exposition().encode()
    assert 'chaos_trainer_step_seconds_bucket{n_active="4",le="0.003"} 1' in prom
    assert "chaos_trainer_steps_total 9" in prom


def test_metrics_primitives_match_jax():
    for mod in (tt, jt):
        assert (mod.TTR_BUCKETS, mod.DETECTION_BUCKETS, mod.STEP_TIME_BUCKETS) == \
            (jt.TTR_BUCKETS, jt.DETECTION_BUCKETS, jt.STEP_TIME_BUCKETS)
    values = [0.0, -0.0, 1.0, 3.0, 0.1, 1 / 3, 1e15, 1e16, 2.5e-7, -4.0,
              float("inf"), float("-inf"), float("nan"), 7, True]
    assert [tt._fmt(v) for v in values] == [jt._fmt(v) for v in values]

    def fill(mod):
        reg = mod.MetricsRegistry()
        reg.counter("m_b", "h", ("k",)).inc(2.5, k='x"y\\z\n')
        reg.gauge("m_a", "").set(1 / 3)
        h = reg.histogram("t_seconds", "hist", ("cls",), buckets=(1.0, 0.1, 10.0))
        for v in (0.05, 0.5, 0.5, 5.0, 50.0):
            h.observe(v, cls="x")
        return reg.exposition()

    assert fill(tt) == fill(jt)
    with pytest.raises(ValueError):
        tt.Counter("0bad name")
    with pytest.raises(ValueError):
        tt.Counter("c").inc(-1.0)
    reg = tt.MetricsRegistry()
    reg.counter("m", "h", ("k",))
    with pytest.raises(ValueError):
        reg.gauge("m", "h", ("k",))


def test_unclosed_started_records_are_flagged_as_in_jax():
    tled, jled = EventLedger(), JaxEventLedger()
    for led in (tled, jled):
        led.append(0, 1.0, "join", 100, "scale-out-started", {})
        led.append(1, 3.0, "reshard", 5, "reshard-started",
                   {"old_shape": (4, 1), "new_shape": (2, 2), "moved_bytes": 0,
                    "step_s": 1.0, "baseline_step_s": 1.0})
        led.append(2, 4.0, "node-fault", 7, "fault-injected", {})
    found = tt.validate(tled)
    assert found == jt.validate(jled) and len(found) == 3
    assert tt.validate_trace_events([{"ph": "Z", "name": "x"}]) == \
        jt.validate_trace_events([{"ph": "Z", "name": "x"}]) != []


# 0 and negative costs or rates, the clamps at both ends, and a grid between.
INTERVAL_GRID = [(c, r) for c in (0.0, -1.0, 1e-9, 0.25, 2.0, 37.5, 1e6)
                 for r in (0.0, -0.5, 1e-9, 0.001, 0.01, 0.5, 1e3)]


@pytest.mark.parametrize("bounds", [{}, {"lo": 1.0, "hi": 600.0},
                                    {"lo": 0.5, "hi": 30.0}])
def test_optimal_interval_matches_jax(bounds):
    assert [tg.optimal_interval(c, r, **bounds) for c, r in INTERVAL_GRID] == \
        [jg.optimal_interval(c, r, **bounds) for c, r in INTERVAL_GRID]
    assert (tg.CKPT_SNAPSHOT_S, tg.CKPT_BASE_INTERVAL_S, tg.CKPT_MIN_INTERVAL_S,
            tg.CKPT_MAX_INTERVAL_S, tg.CKPT_RETRY_S) == \
        (jg.CKPT_SNAPSHOT_S, jg.CKPT_BASE_INTERVAL_S, jg.CKPT_MIN_INTERVAL_S,
         jg.CKPT_MAX_INTERVAL_S, jg.CKPT_RETRY_S)
    assert tg.optimal_interval(2.0, 0.01, lo=1.0, hi=600.0) == math.sqrt(400.0)
    assert tg.optimal_interval(0.0, 0.5, lo=1.0, hi=600.0) == 600.0
    assert tg.optimal_interval(1.0, 0.0, lo=1.0, hi=600.0) == 600.0
    assert tg.optimal_interval(1e-9, 1e3, lo=1.0, hi=600.0) == 1.0
    assert tg.optimal_interval(1e6, 1e-9, lo=1.0, hi=600.0) == 600.0


# -- the classifier's invariants, on the port alone --------------------------


def test_classify_overlap_resolves_by_priority():
    comps = tg.classify([(1.0, 3.0, "detection"), (2.0, 5.0, "handling")],
                        t_start=0.0, t_end=10.0)
    assert comps["detection"] == 2.0
    assert comps["handling"] == 2.0  # 3.0..5.0, the part detection leaves
    assert comps["productive"] == 6.0
    assert math.fsum(comps.values()) == 10.0


def test_classify_clamps_to_window():
    comps = tg.classify([(-5.0, 2.0, "detection"), (8.0, 99.0, "checkpoint"),
                         (20.0, 30.0, "lost")], t_start=0.0, t_end=10.0)
    assert (comps["detection"], comps["checkpoint"], comps["lost"]) == (2.0, 2.0, 0.0)
    assert math.fsum(comps.values()) == 10.0


def test_empty_ledger_is_all_productive():
    report = tg.goodput_report(EventLedger(), t_start=0.0, t_end=5.0)
    assert report.components == {c: (5.0 if c == "productive" else 0.0)
                                 for c in tg.CATEGORIES}
    assert report.goodput_fraction == 1.0 and report.badput_s == 0.0
    assert tg.goodput_report(EventLedger(), t_start=3.0, t_end=1.0).total_s == 0.0
    forest = tt.build_spans(EventLedger())
    assert (forest.roots, forest.intervals, tt.validate(EventLedger(), forest)) == ([], [], [])
