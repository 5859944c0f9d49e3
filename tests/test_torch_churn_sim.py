"""The port's churn backend against the JAX package's.

``repro_torch.core.control``, ``engine.SimBackend`` with ``run_trace_sim``
and ``run_trace_goodput``, ``goodput.SimCheckpointTier``, the simulator
collectors of ``telemetry`` and ``scenarios.generators`` are copies of the
JAX package's modules, plain Python arithmetic on both sides, so every
output is compared with ``==``:

* the two graph functions the control plane's election takes from networkx
  (``subgraph_view``, ``single_source_dijkstra_path_length``) on every
  source of tie-laden, pod and random overlays, with and without dead nodes
  and faulted links;
* every generator family's JSONL at three seeds;
* replays of every family under both recovery policies, and across the
  detectors, checkpoint cadences, codecs, reshard modes and partial credit:
  ledger bytes, per-event results, GoodPut report, the ``collect_backend``
  exposition, the control plane's counters and a fail-over's
  ``FailoverResult``;
* the pinned omniscient-poisson digest, and ``chip_smoke.churn_sweep``'s
  ``CHURN_DIGEST`` through both packages;
* a replay with the checkpoint tier and a scheduler fault in a process
  where networkx, JAX and the JAX package cannot be imported.
"""
import dataclasses
import heapq
import importlib.util
import itertools
import json
import os
import pathlib
import random
import subprocess
import sys
from types import SimpleNamespace

import networkx as nx
import pytest

from repro.core import plans as jplans
from repro_torch.core import graph
from repro_torch.core import plans as tplans

ROOT = pathlib.Path(__file__).resolve().parents[1]
MB = 1024 * 1024


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CS = _chip_smoke()
JAX = CS.churn_modules("repro")
PORT = CS.churn_modules("repro_torch")


# -- the election's graph functions against networkx ----------------------------


def _latency(a, b, d):
    return d["link"].latency_s


def _tie_graphs(seed, n=14, p=0.35):
    """The same random graph in both libraries, with float latencies drawn
    from a few values whose sums round differently by association: equal
    routes everywhere, and last-bit differences between summation orders."""
    rng = random.Random(seed)
    pair = nx.Graph(), graph.Graph()
    for g in pair:
        for i in range(n):
            g.add_node(i)
    for u, v in itertools.combinations(range(n), 2):
        if rng.random() < p:
            link = SimpleNamespace(latency_s=rng.choice((0.1, 0.2, 0.3, 0.7)))
            for g in pair:
                g.add_edge(u, v, link=link)
    return pair


def _graphs(case):
    if case == "pod32":
        return (JAX.topology.pod_topology(32).g,
                PORT.topology.pod_topology(32).g)
    kind, a, b = case.split("-")
    if kind == "ties":
        return _tie_graphs(int(a))
    n, seed = int(a), int(b)
    return (JAX.topology.random_edge_topology(n, seed=seed).g,
            PORT.topology.random_edge_topology(n, seed=seed).g)


GRAPH_CASES = (["pod32"] + [f"ties-{s}-0" for s in range(4)]
               + [f"random-{n}-{s}" for n in (6, 9, 12) for s in (0, 1, 2)])
SUBSTRATE_CASES = [c for c in GRAPH_CASES if not c.startswith("ties")]


def _filters(ng, hide):
    """``_vote_round_s``'s filters: dead or silent nodes hidden, faulted
    links hidden (as ``(min, max)`` keys)."""
    nodes = sorted(ng)
    rng = random.Random(len(nodes))
    dead = set(rng.sample(nodes, 2)) if hide in ("dead", "both") else set()
    edges = sorted((min(a, b), max(a, b)) for a, b in ng.edges)
    bad = set(rng.sample(edges, min(3, len(edges)))) \
        if hide in ("faulted", "both") else set()
    return (lambda n: n not in dead,
            lambda a, b: (min(a, b), max(a, b)) not in bad)


def _lengths(lib, g, source, weight):
    try:
        return list(lib.single_source_dijkstra_path_length(
            g, source, weight=weight).items())
    except (nx.NodeNotFound, graph.NodeNotFound) as e:
        return type(e).__name__


@pytest.mark.parametrize("hide", ["none", "dead", "faulted", "both"])
@pytest.mark.parametrize("case", GRAPH_CASES)
def test_dijkstra_over_subgraph_view_equals_networkx(case, hide):
    """Every source, distances and their settling order with ``==``; a
    hidden source raises ``NodeNotFound`` in both."""
    ng, tg = _graphs(case)
    node_ok, edge_ok = _filters(ng, hide)
    nv = nx.subgraph_view(ng, filter_node=node_ok, filter_edge=edge_ok)
    tv = graph.subgraph_view(tg, filter_node=node_ok, filter_edge=edge_ok)
    assert list(tv) == list(nv.nodes)
    assert list(tv.edges) == list(nv.edges)
    assert {n: list(tv.neighbors(n)) for n in tv} == \
        {n: list(nv.neighbors(n)) for n in nv}
    hidden = 0
    for source in ng:
        want = _lengths(nx, nv, source, _latency)
        got = _lengths(graph, tv, source, _latency)
        if want == "NodeNotFound":
            hidden += 1
            assert got == "NodeNotFound"
        else:
            assert got == want
    assert hidden == (2 if hide in ("dead", "both") else 0)
    for lib, g in ((nx, nv), (graph, tv), (nx, ng), (graph, tg)):
        assert _lengths(lib, g, 999, _latency) == "NodeNotFound"


def _reverse_sum_lengths(g, source, weight):
    """The planted fault: a one-way Dijkstra that finds the same routes but
    sums each route's latencies from its far end."""
    dist, pred, c = {}, {source: None}, itertools.count()
    seen, heap = {source: 0}, [(0, next(c), source)]
    while heap:
        d, _, v = heapq.heappop(heap)
        if v in dist:
            continue
        dist[v] = d
        for u, e in g.nbr_items(v):
            vu = d + weight(v, u, e)
            if u not in dist and (u not in seen or vu < seen[u]):
                seen[u], pred[u] = vu, v
                heapq.heappush(heap, (vu, next(c), u))
    out = []
    for v in dist:
        hops, x = [], v
        while pred[x] is not None:
            hops.append(weight(pred[x], x, g._adj[pred[x]][x]))
            x = pred[x]
        out.append((v, sum(hops)))  # far end first
    return out


def _reverse_sum_mismatches(cases):
    bad = 0
    for case in cases:
        ng, tg = _graphs(case)
        for source in ng:
            bad += _reverse_sum_lengths(tg, source, _latency) != \
                _lengths(nx, ng, source, _latency)
    return bad


def test_reverse_summation_fails_the_distance_check():
    """The substrate's own overlays separate the two summation orders: the
    planted fault differs from networkx from every source of the pod graph
    and from 16 of the 90 sources of the random overlays (48 in all), and
    from 38 of the 56 sources of the float tie graphs."""
    assert _reverse_sum_mismatches(["pod32"]) == 32
    assert _reverse_sum_mismatches(SUBSTRATE_CASES) == 48
    assert _reverse_sum_mismatches([c for c in GRAPH_CASES
                                    if c.startswith("ties")]) == 38


# -- the generators ---------------------------------------------------------------


@pytest.mark.parametrize("topo", [(12, 0), (10, 3)])
@pytest.mark.parametrize("family", sorted(CS.CHURN_FAMILY_ARGS))
def test_generator_jsonl_byte_identical(family, topo, tmp_path):
    n, tseed = topo
    for seed in (3, 5, 7):
        texts = []
        for sim, name in ((JAX, "jax"), (PORT, "port")):
            trace = CS.family_trace(
                sim, family, sim.topology.random_edge_topology(n, seed=tseed),
                seed)
            path = tmp_path / f"{name}-{seed}.jsonl"
            trace.save(path)
            assert CS.trace_jsonl(trace) == path.read_text()
            texts.append(path.read_bytes())
        assert texts[0] == texts[1]
        assert len(texts[0].splitlines()) > 1
    assert sorted(PORT.scenarios.GENERATORS) == sorted(JAX.scenarios.GENERATORS) \
        == sorted(CS.CHURN_FAMILY_ARGS)
    assert sorted(PORT.scenarios.__all__) == sorted(JAX.scenarios.__all__)


# -- replays in both packages -------------------------------------------------


def _cluster(sim, n=10, seed=3, state=16 * MB, tensor=MB):
    cl = sim.baselines.SimCluster(sim.topology.random_edge_topology(n, seed=seed),
                                  state_bytes=state,
                                  tensor_sizes=[tensor] * (state // tensor))
    cl.train(1)
    return cl


def _family_events(sim, family, n=10, seed=3):
    return list(CS.family_trace(
        sim, family, sim.topology.random_edge_topology(n, seed=seed), 7))


def _plain(x):
    """A result as plain data: dataclasses by class name and fields."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, {f.name: _plain(getattr(x, f.name))
                                   for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x).__name__, [_plain(v) for v in x]
    if isinstance(x, (set, frozenset)):
        return "set", sorted(x)
    return x


def _replay(sim, family, kw):
    cl = _cluster(sim)
    events = _family_events(sim, family)
    ledger, backend = CS.churn_replay(sim, cl, events, **kw)
    reg = sim.telemetry.MetricsRegistry()
    sim.telemetry.collect_backend(reg, backend, ledger, report=backend.goodput)
    ledger2, results2, report2 = sim.engine.run_trace_goodput(
        _cluster(sim), _family_events(sim, family), **kw)
    assert ledger2.canonical_bytes() == ledger.canonical_bytes()
    assert report2.to_json() == backend.goodput.to_json()
    assert _plain(results2) == _plain(backend.results)
    return {"ledger": ledger.canonical_bytes(),
            "results": _plain(backend.results),
            "goodput": json.dumps(backend.goodput.to_json(), sort_keys=True),
            "exposition": reg.exposition().encode(),
            "control": backend.control.metrics_snapshot(),
            "backend": backend.metrics_snapshot(),
            "failovers": _plain(backend.control.failovers)}


REPLAY_CASES = (
    [(f, {"policy": p, **CS.CHURN_FAMILY_KW.get(f, {})})
     for f in sorted(CS.CHURN_FAMILY_ARGS) for p in ("fixed", "adaptive")]
    + [(f, {"detector": d}) for f in ("silent-failures", "detector-stress")
       for d in ("phi", "fixed")]
    + [(f, {"checkpoint": c}) for f in ("checkpointed-training", "mixed-faults")
       for c in (None, "fixed", "adaptive")]
    + [(f, {"codec": c}) for f in ("poisson-churn", "bandwidth-degradation")
       for c in ("none", "int8", "auto")]
    + [("reshard-churn", {"reshard": r}) for r in ("never", "auto")]
    + [(f, {"partial_credit": on}) for f in ("adversarial-churn",
                                             "bandwidth-degradation")
       for on in (True, False)]
)


@pytest.mark.parametrize("family, kw", REPLAY_CASES,
                         ids=[f"{f}-{'-'.join(f'{k}={v}' for k, v in kw.items())}"
                              for f, kw in REPLAY_CASES])
def test_replay_equals_jax(family, kw):
    ours, theirs = _replay(PORT, family, kw), _replay(JAX, family, kw)
    assert ours.keys() == theirs.keys()
    for key in ours:
        assert ours[key] == theirs[key], key


def test_the_replay_cases_reach_every_outcome():
    """The cases above run elections and re-adoption, checkpoints and
    restores, reshards, re-plans and detections, so the comparisons are not
    vacuous."""
    actions = set()
    for family, kw in REPLAY_CASES:
        ledger, _ = CS.churn_replay(PORT, _cluster(PORT),
                                    _family_events(PORT, family), **kw)
        actions |= {r.action for r in ledger}
    assert actions >= {"failover", "re-adopted", "deferred-leaderless",
                       "ckpt-complete", "replica-restored", "reshard-ready",
                       "recovery-decided", "ready", "replanned", "node-failed",
                       "link-failed", "link-degraded", "fault-undetected"}


def _failover(sim):
    """tests/test_failover.py's scheduler churn: two joins before the
    scheduler's silent fault, one after, on its 9-node overlay."""
    cl = sim.baselines.SimCluster(sim.topology.random_edge_topology(9, seed=2),
                                  state_bytes=48 * MB, tensor_sizes=[MB] * 48)
    cl.train(1)
    trace = sim.scenarios.scheduler_churn(
        sim.topology.random_edge_topology(9, seed=2), seed=5, horizon_s=40.0,
        t_fault=12.0, n_joins_before=2, n_joins_after=1)
    ledger, backend = CS.churn_replay(sim, cl, list(trace))
    fo = backend.control.failovers
    return (ledger.canonical_bytes(), _plain(fo),
            [(f.detection_s, f.failover_s) for f in fo],
            backend.control.metrics_snapshot(), backend.cluster.scheduler.node)


def test_failover_result_equals_jax():
    ours, theirs = _failover(PORT), _failover(JAX)
    assert ours == theirs
    assert len(ours[1][1]) == 1 and ours[4] != 0  # one election, a new home


def test_defer_leaderless_replaces_the_event_time():
    ev = PORT.engine.ChurnEvent(t=1.0, kind="join", node=7, links={1: (1.0, 0.1)})
    moved = dataclasses.replace(ev, t=2.5)
    assert (moved.t, moved.node, moved.links) == (2.5, 7, {1: (1.0, 0.1)})


# -- the pinned digests -------------------------------------------------------


def test_port_reproduces_the_pre_reshard_digest():
    cl = PORT.baselines.SimCluster(PORT.topology.random_edge_topology(16, seed=0),
                                   state_bytes=32 * MB, tensor_sizes=[MB] * 32)
    cl.train(1)
    trace = PORT.scenarios.poisson_churn(
        sorted(cl.topo.active_nodes()), seed=3, horizon_s=600.0,
        rate_join=0.05, rate_leave=0.04)
    ledger, _ = PORT.engine.run_trace_sim(cl, trace, reshard="never")
    assert ledger.digest() == CS.PRE_RESHARD_DIGEST


def test_churn_digest_is_pinned_to_the_jax_package():
    """The JAX package's sweep gives ``chip_smoke.CHURN_DIGEST``: change
    the sweep and this prints the digest to pin."""
    sweep = CS.churn_sweep(JAX)
    digest = CS.sweep_digest(sweep)
    if digest != CS.CHURN_DIGEST:
        print(f"CHURN_DIGEST = {digest!r}")
    assert digest == CS.CHURN_DIGEST
    assert sweep["omniscient-poisson"]["ledger"] == CS.PRE_RESHARD_DIGEST
    assert all(rec["valid"] for rec in sweep.values())


def test_port_reproduces_the_churn_digest():
    assert CS.sweep_digest(CS.churn_sweep(PORT)) == CS.CHURN_DIGEST


# -- a reference limitation: one-byte reshard shards -------------------------


def test_jax_reshard_plan_cuts_the_gpt2_profile_into_one_byte_shards():
    """The reference's ``reshard_plan`` makes each fetch's shard the gcd of
    its sources' byte counts. From (1, 11) to (5, 2) on the 468 MiB GPT-2
    profile that gcd is 1, so ``begin_reshard_fetch`` would list about 2e8
    shards for one fetch. The port keeps the arithmetic; the churn sweep
    replays reshard-churn on its test's 64 MiB state instead."""
    state = 468 * MB
    devices = tuple(n for n in range(12) if n != 4)
    plans = [P.reshard_plan(P.ParallelismPlan((1, 11), devices=devices),
                            P.ParallelismPlan((5, 2), devices=devices[:10]),
                            sim.topology.random_edge_topology(12, seed=0), state)
             for P, sim in ((jplans, JAX), (tplans, PORT))]
    fetch = plans[0].fetches[0]
    assert fetch.shard_size == 1
    assert sum(fetch.sources.values()) // fetch.shard_size > 10 ** 8
    assert _plain(plans[1]) == _plain(plans[0])


# -- the port alone, with networkx, JAX and the JAX package blocked ----------

NO_REFERENCE = """
import sys
for name in ("networkx", "jax", "repro", "msgpack"):
    sys.modules[name] = None
from repro_torch.core import engine, negotiation, topology
from repro_torch.scenarios import mixed_faults
topo = topology.random_edge_topology(10, seed=3)
cl = negotiation.SimCluster(topo, state_bytes=16 << 20, tensor_sizes=[1 << 20] * 16)
cl.train(1)
trace = mixed_faults(topology.random_edge_topology(10, seed=3), seed=5,
                     horizon_s=90.0)
assert trace.kinds()["scheduler-fault"] == 1
ledger, results, report = engine.run_trace_goodput(
    cl, list(trace), checkpoint="adaptive", policy="adaptive")
actions = {r.action for r in ledger}
assert {"failover", "ckpt-complete", "node-failed"} <= actions, actions
assert 0.0 < report.goodput_fraction < 1.0
assert not any(m.split(".")[0] in ("networkx", "jax", "repro", "msgpack")
               for m, v in sys.modules.items() if v is not None)
print("CHURN_BACKEND_OK", ledger.digest())
"""


def test_churn_backend_runs_without_networkx_or_jax():
    out = subprocess.run([sys.executable, "-c", NO_REFERENCE], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "CHURN_BACKEND_OK" in out.stdout
