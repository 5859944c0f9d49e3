"""The port's stdlib graph (``repro_torch.core.graph``) against networkx.

The simulator's routes, heartbeat paths and per-edge RNG draws depend on
networkx's answers *and* its orders, so each is held to networkx on the
same graphs: routes for every ordered pair (ties included), node, edge and
neighbour order after the substrate's mutations, ``restricted_view``,
``has_path`` and the two exceptions. A one-way Dijkstra, planted in place
of the bidirectional search, must fail the route check. The port itself
never imports networkx (a subprocess with networkx and JAX blocked runs a
scale-out).
"""
import heapq
import itertools
import os
import pathlib
import random
import subprocess
import sys

import networkx as nx
import pytest

from repro.core import topology as jtopology
from repro_torch.core import graph
from repro_torch.core import topology as ttopology

ROOT = pathlib.Path(__file__).resolve().parents[1]
MB = 1024 * 1024


def _weight(nbytes):
    return lambda a, b, d: d["link"].transfer_time(nbytes)


def _tie_graphs(seed, n=14, p=0.3):
    """The same random graph in both libraries, with weights drawn from
    {1, 2, 3}: equal-weight routes everywhere."""
    rng = random.Random(seed)
    pair = nx.Graph(), graph.Graph()
    for g in pair:
        for i in range(n):
            g.add_node(i)
    for u, v in itertools.combinations(range(n), 2):
        if rng.random() < p:
            w = rng.choice((1, 2, 3))
            for g in pair:
                g.add_edge(u, v, w=w)
    return pair


def _int_weight(a, b, d):
    return d["w"]


def _topologies(case):
    """(networkx graph, port graph, weight) for one route case."""
    if case == "pod32":
        return (jtopology.pod_topology(32).g, ttopology.pod_topology(32).g,
                _weight(4 * MB))
    kind, a, b = case.split("-")
    if kind == "ties":
        return (*_tie_graphs(int(a)), _int_weight)
    n, seed = int(a), int(b)
    return (jtopology.random_edge_topology(n, seed=seed).g,
            ttopology.random_edge_topology(n, seed=seed).g, _weight(4 * MB))


ROUTE_CASES = (["pod32"] + [f"ties-{s}-0" for s in range(6)]
               + [f"random-{n}-{s}" for n in (6, 8, 10, 12) for s in (0, 1)])


def _route_mismatches(shortest_path, case):
    ng, tg, w = _topologies(case)
    bad = 0
    for u in ng:
        for v in ng:
            if u == v:
                continue
            try:
                want = nx.shortest_path(ng, u, v, weight=w)
            except nx.NetworkXNoPath:
                want = None
            try:
                got = shortest_path(tg, u, v, weight=w)
            except graph.NoPath:
                got = None
            bad += got != want
    return bad


@pytest.mark.parametrize("case", ROUTE_CASES)
def test_shortest_path_equals_networkx_for_every_pair(case):
    assert _route_mismatches(graph.shortest_path, case) == 0


def _one_way_dijkstra(g, source, target, weight):
    """A plain single-ended Dijkstra: the same distances, another choice
    among equal routes."""
    dist, pred, c = {source: 0}, {source: None}, itertools.count()
    heap, done = [(0, next(c), source)], set()
    while heap:
        d, _, v = heapq.heappop(heap)
        if v in done:
            continue
        done.add(v)
        if v == target:
            path = []
            while v is not None:
                path.append(v)
                v = pred[v]
            return path[::-1]
        for w, data in g.nbr_items(v):
            nd = d + weight(v, w, data)
            if w not in dist or nd < dist[w]:
                dist[w], pred[w] = nd, v
                heapq.heappush(heap, (nd, next(c), w))
    raise graph.NoPath(f"No path between {source} and {target}.")


def test_one_way_dijkstra_fails_the_route_check():
    """The planted fault: on the pod graph a one-way Dijkstra picks another
    of the equal routes for 224 of the 992 ordered pairs."""
    assert _route_mismatches(_one_way_dijkstra, "pod32") == 224


def _mutate(g, seed):
    """The substrate's mutations in a seeded order: remove and re-add a
    node (``register_leave``), remove and re-add edges, ``add_edge`` on an
    existing edge with new data."""
    rng = random.Random(seed)
    for i in range(10):
        g.add_node(i)
    edges = [e for e in itertools.combinations(range(10), 2)
             if rng.random() < 0.4]
    for u, v in edges:
        g.add_edge(u, v, link=(u, v))
    for _ in range(12):
        op = rng.randrange(3)
        if op == 0:
            n = rng.randrange(10)
            g.remove_node(n)
            g.add_node(n)
        elif op == 1 and edges:
            u, v = edges[rng.randrange(len(edges))]
            if g.has_edge(u, v):
                g.remove_edge(u, v)
            g.add_edge(v, u, link=("again", u, v))
        else:
            u, v = rng.sample(range(10), 2)
            g.add_edge(u, v, link=("updated", u, v))


def _shape(g):
    return (list(g), list(g.edges), {n: list(g.neighbors(n)) for n in g},
            [g.edges[u, v] for u, v in g.edges], g.number_of_edges())


@pytest.mark.parametrize("seed", range(6))
def test_orders_after_mutations_equal_networkx(seed):
    ng, tg = nx.Graph(), graph.Graph()
    _mutate(ng, seed)
    _mutate(tg, seed)
    assert _shape(tg) == _shape(ng)


@pytest.mark.parametrize("hide", ["relays", "direct"])
@pytest.mark.parametrize("seed", range(3))
def test_restricted_view_equals_networkx(hide, seed):
    """Relays of a primary route hidden, or (no relays) the direct edge in
    both directions, as the monitor's disjoint heartbeat route does."""
    jt = jtopology.random_edge_topology(10, seed=seed)
    tt = ttopology.random_edge_topology(10, seed=seed)
    w = _weight(256.0)
    for home in (0, 5):
        for node in jt.g:
            if node == home:
                continue
            primary = nx.shortest_path(jt.g, node, home, weight=w)
            relays = primary[1:-1]
            if hide == "relays":
                nodes, edges = relays, [] if relays else [(node, home)]
            else:
                nodes, edges = [], [(home, node)]
            nv = nx.restricted_view(jt.g, nodes, edges)
            tv = graph.restricted_view(tt.g, nodes, edges)
            assert list(tv) == list(nv.nodes)
            assert list(tv.edges) == list(nv.edges)
            assert {n: list(tv.neighbors(n)) for n in tv} == \
                {n: list(nv.neighbors(n)) for n in nv}
            for a in nv:
                for b in nv:
                    try:
                        want = nx.shortest_path(nv, a, b, weight=w)
                    except nx.NetworkXNoPath:
                        want = None
                    try:
                        got = graph.shortest_path(tv, a, b, weight=w)
                    except graph.NoPath:
                        got = None
                    assert got == want


def _split_pair():
    """Two components, {0, 1, 2} and {3, 4}, and an isolated node 5."""
    pair = nx.Graph(), graph.Graph()
    for g in pair:
        for n in range(6):
            g.add_node(n)
        for u, v in ((0, 1), (1, 2), (3, 4)):
            g.add_edge(u, v, w=1)
    return pair


@pytest.mark.parametrize("u, v", [(0, 2), (0, 3), (3, 4), (5, 0), (5, 5), (2, 2)])
def test_has_path_and_no_path_agree(u, v):
    ng, tg = _split_pair()
    assert graph.has_path(tg, u, v) == nx.has_path(ng, u, v)
    if nx.has_path(ng, u, v):
        assert graph.shortest_path(tg, u, v, weight=_int_weight) == \
            nx.shortest_path(ng, u, v, weight=_int_weight)
    else:
        with pytest.raises(nx.NetworkXNoPath):
            nx.shortest_path(ng, u, v, weight=_int_weight)
        with pytest.raises(graph.NoPath):
            graph.shortest_path(tg, u, v, weight=_int_weight)


@pytest.mark.parametrize("u, v", [(9, 0), (0, 9), (9, 9)])
@pytest.mark.parametrize("fn", ["shortest_path", "has_path"])
def test_node_not_found_where_networkx_raises_it(fn, u, v):
    """Raised for a missing endpoint before the ``source == target``
    shortcut, by both functions, on a graph and on a view."""
    ng, tg = _split_pair()
    for g, mod, exc in ((ng, nx, nx.NodeNotFound), (tg, graph, graph.NodeNotFound),
                        (nx.restricted_view(ng, [9], []), nx, nx.NodeNotFound),
                        (graph.restricted_view(tg, [9], []), graph,
                         graph.NodeNotFound)):
        with pytest.raises(exc):
            if fn == "has_path":
                mod.has_path(g, u, v)
            else:
                mod.shortest_path(g, u, v, weight=_int_weight)
    # A node hidden by the view is not found either.
    for view, exc in ((nx.restricted_view(ng, [1], []), nx.NodeNotFound),
                      (graph.restricted_view(tg, [1], []), graph.NodeNotFound)):
        with pytest.raises(exc):
            (nx if exc is nx.NodeNotFound else graph).shortest_path(
                view, 1, 0, weight=_int_weight)


NO_NETWORKX = """
import sys
sys.modules["networkx"] = None
sys.modules["jax"] = None
from repro_torch.core import (baselines, codec, engine, graph, monitor,
                              negotiation, plans, sharding_alg, simulator,
                              topology)
topo = topology.random_edge_topology(6, seed=0)
cl = baselines.make_cluster(topo, state_bytes=64 << 20,
                            tensor_sizes=[4 << 20] * 16, strategy="chaos")
cl.train(1)
res = cl.scale_out(100, {0: topology.Link(500, 0.005), 3: topology.Link(300, 0.01)})
assert res.delay_s > 0 and res.plan.sources and 100 in topo.active_nodes()
assert not any(m.split(".")[0] in ("networkx", "jax", "repro")
               for m, v in sys.modules.items() if v is not None)
print("SUBSTRATE_OK")
"""


def test_substrate_runs_without_networkx_or_jax():
    out = subprocess.run([sys.executable, "-c", NO_NETWORKX], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "SUBSTRATE_OK" in out.stdout
