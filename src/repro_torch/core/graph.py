"""The part of networkx that the simulator substrate uses, in the standard
library.

``repro/core/topology.py`` and ``repro/core/monitor.py`` build the overlay
on ``networkx.Graph``; the port cannot (the GPU machine has no networkx),
and a graph of its own must give the same answers in the same order,
because the simulator's timelines depend on them:

* ``Graph`` keeps a dict-of-dicts adjacency in insertion order, as
  networkx's does. Removing and re-adding a node moves it to the end;
  ``add_edge`` on an existing edge updates its attribute dict in place
  without reordering; ``edges`` yields ``(n, nbr)`` with ``n`` the endpoint
  met first in node order, and ``edges[u, v]`` is the shared attribute dict.
* ``shortest_path`` is networkx 3.6.1's ``bidirectional_dijkstra``, which is
  what ``nx.shortest_path(g, u, v, weight=callable)`` runs. Among routes of
  equal weight it returns the one where the two searches first meet, which
  a one-way Dijkstra does not: on ``pod_topology(32)`` with the heartbeat
  weight the two differ on 224 of 992 ordered pairs. Routes decide which
  links carry the multi-source baseline's streams and the monitor's
  heartbeats, so the copy keeps the two heaps, the shared tie counter and
  the strictly-shorter rule for the meeting node.
* ``restricted_view`` hides nodes and undirected edges without copying; its
  neighbour order is the base graph's.
* ``NoPath`` and ``NodeNotFound`` are raised where networkx raises
  ``NetworkXNoPath`` and ``NodeNotFound``.
"""
from __future__ import annotations

from heapq import heappop, heappush
from itertools import count


class NoPath(Exception):
    """No route joins the two nodes (networkx's ``NetworkXNoPath``)."""


class NodeNotFound(Exception):
    """A route's endpoint is not in the graph (networkx's ``NodeNotFound``)."""


class _EdgeView:
    """``g.edges``: iterates each undirected edge once; ``g.edges[u, v]``
    (a ``Graph``'s) is the edge's attribute dict."""

    __slots__ = ("_g",)

    def __init__(self, g):
        self._g = g

    def __iter__(self):
        seen = set()
        for n, nbrs in self._g._items():
            for nbr in nbrs:
                if nbr not in seen:
                    yield (n, nbr)
            seen.add(n)

    def __getitem__(self, e):
        u, v = e
        return self._g._adj[u][v]


class Graph:
    """Undirected graph with one attribute dict per edge, shared by both
    directions."""

    def __init__(self):
        self._adj = {}

    def _items(self):
        return self._adj.items()

    def add_node(self, n):
        if n not in self._adj:
            self._adj[n] = {}

    def remove_node(self, n):
        for u in list(self._adj[n]):
            del self._adj[u][n]
        del self._adj[n]

    def add_edge(self, u, v, **attr):
        self.add_node(u)
        self.add_node(v)
        data = self._adj[u].get(v, {})
        data.update(attr)
        self._adj[u][v] = data
        self._adj[v][u] = data

    def remove_edge(self, u, v):
        del self._adj[u][v]
        if u != v:
            del self._adj[v][u]

    def has_edge(self, u, v):
        return u in self._adj and v in self._adj[u]

    def neighbors(self, n):
        return iter(self._adj[n])

    def nbr_items(self, n):
        return self._adj[n].items()

    def number_of_edges(self):
        return sum(len(nbrs) + (n in nbrs)
                   for n, nbrs in self._adj.items()) // 2

    @property
    def edges(self):
        return _EdgeView(self)

    def __contains__(self, n):
        return n in self._adj

    def __iter__(self):
        return iter(self._adj)


class _RestrictedView:
    """``g`` with some nodes and undirected edges hidden; reads through."""

    def __init__(self, g, nodes, edges):
        self._base = g
        self._hidden = set(nodes)
        self._hidden_edges = set(edges) | {(v, u) for (u, v) in edges}

    def _ok(self, u, v):
        return v not in self._hidden and (u, v) not in self._hidden_edges

    def _items(self):
        return ((n, [v for v in nbrs if self._ok(n, v)])
                for n, nbrs in self._base._adj.items()
                if n not in self._hidden)

    def neighbors(self, n):
        if n not in self:
            raise KeyError(n)
        return (v for v in self._base._adj[n] if self._ok(n, v))

    def nbr_items(self, n):
        return ((v, d) for v, d in self._base._adj[n].items()
                if self._ok(n, v))

    @property
    def edges(self):
        return _EdgeView(self)

    def __contains__(self, n):
        return n in self._base._adj and n not in self._hidden

    def __iter__(self):
        return (n for n in self._base._adj if n not in self._hidden)


def restricted_view(g, nodes, edges):
    """``g`` without ``nodes`` and the undirected ``edges`` (either
    orientation), as ``nx.restricted_view``."""
    return _RestrictedView(g, nodes, edges)


def shortest_path(g, source, target, weight):
    """Least-weight route from ``source`` to ``target``: networkx 3.6.1's
    ``bidirectional_dijkstra`` operation for operation, ties included (see
    the module docstring). ``weight(u, v, data)`` gives an edge's cost,
    ``None`` hides the edge."""
    if source not in g:
        raise NodeNotFound(f"Source {source} is not in G")
    if target not in g:
        raise NodeNotFound(f"Target {target} is not in G")
    if source == target:
        return [source]
    dists = [{}, {}]  # settled distances, forward and backward
    preds = [{source: None}, {target: None}]

    def path(curr, direction):
        ret = []
        while curr is not None:
            ret.append(curr)
            curr = preds[direction][curr]
        return list(reversed(ret)) if direction == 0 else ret

    fringe = [[], []]  # heaps of (distance, tie counter, node)
    seen = [{source: 0}, {target: 0}]
    c = count()
    heappush(fringe[0], (0, next(c), source))
    heappush(fringe[1], (0, next(c), target))
    finaldist = None
    meetnode = None
    direction = 1
    while fringe[0] and fringe[1]:
        direction = 1 - direction
        dist, _, v = heappop(fringe[direction])
        if v in dists[direction]:
            continue
        dists[direction][v] = dist
        if v in dists[1 - direction]:
            return path(meetnode, 0) + path(preds[1][meetnode], 1)
        for w, d in g.nbr_items(v):
            cost = weight(v, w, d) if direction == 0 else weight(w, v, d)
            if cost is None:
                continue
            vw_length = dist + cost
            if w in dists[direction]:
                if vw_length < dists[direction][w]:
                    raise ValueError("Contradictory paths found: negative weights?")
            elif w not in seen[direction] or vw_length < seen[direction][w]:
                seen[direction][w] = vw_length
                heappush(fringe[direction], (vw_length, next(c), w))
                preds[direction][w] = v
                if w in seen[1 - direction]:
                    finaldist_w = vw_length + seen[1 - direction][w]
                    if finaldist is None or finaldist > finaldist_w:
                        finaldist, meetnode = finaldist_w, w
    raise NoPath(f"No path between {source} and {target}.")


def has_path(g, source, target):
    """True when a route joins the two nodes; ``NodeNotFound`` when either
    is not in ``g``, as ``nx.has_path``."""
    if source not in g:
        raise NodeNotFound(f"Source {source} is not in G")
    if target not in g:
        raise NodeNotFound(f"Target {target} is not in G")
    frontier, reached = [source], {source}
    while frontier:
        if target in reached:
            return True
        nxt = []
        for u in frontier:
            for v in g.neighbors(u):
                if v not in reached:
                    reached.add(v)
                    nxt.append(v)
        frontier = nxt
    return target in reached
