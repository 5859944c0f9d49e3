"""Overlay network topology for Chaos (paper §III Fig 1, §IV-A), copied
from ``repro/core/topology.py`` onto the stdlib graph of
``repro_torch.core.graph`` (same node, neighbour and edge order, same
routes, ties included).

Nodes are edge devices (or, on the deployment target, TPU hosts/slices);
weighted edges carry (propagation delay, per-byte transmission delay). The
same structure models the paper's 6–12-VM edge overlays (random 100–1000
Mbit/s links, re-randomized every 3 simulated minutes, as in §VI-A) and
pod/torus graphs for the TPU mapping (DESIGN.md §3).
"""
from __future__ import annotations

import dataclasses
import math
import random
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.core import graph

MBPS = 1e6 / 8.0  # bytes per second per Mbit/s


@dataclass
class Link:
    bandwidth_mbps: float
    latency_s: float

    @property
    def bytes_per_s(self) -> float:
        return self.bandwidth_mbps * MBPS

    @property
    def trans_delay_per_byte(self) -> float:
        return 1.0 / self.bytes_per_s

    def transfer_time(self, nbytes: float) -> float:
        return self.latency_s + nbytes * self.trans_delay_per_byte


@dataclass
class NodeInfo:
    node_id: int
    state: str = "active"  # active | standby | failed | left
    join_time: float = 0.0
    compute_s: float = 1.0  # per-minibatch gradient computation time
    addr: str = ""


class Topology:
    """Mutable overlay graph with per-link properties."""

    def __init__(self):
        self.g = graph.Graph()
        self.nodes: Dict[int, NodeInfo] = {}
        #: bumped on every structural or link-parameter change; cheap
        #: cache-invalidation key for route caches (monitor heartbeats).
        self.version = 0

    def touch(self):
        """Record an in-place mutation (e.g. link-degrade rewriting a
        Link's rate/latency) that route caches must notice."""
        self.version += 1

    # -- construction -------------------------------------------------------

    def add_node(self, node_id: int, **kw) -> NodeInfo:
        info = NodeInfo(node_id, **kw)
        self.nodes[node_id] = info
        self.g.add_node(node_id)
        self.version += 1
        return info

    def remove_node(self, node_id: int):
        self.g.remove_node(node_id)
        self.nodes.pop(node_id, None)
        self.version += 1

    def add_link(self, u: int, v: int, link: Link):
        self.g.add_edge(u, v, link=link)
        self.version += 1

    def remove_link(self, u: int, v: int):
        if self.g.has_edge(u, v):
            self.g.remove_edge(u, v)
            self.version += 1

    def has_link(self, u, v) -> bool:
        return self.g.has_edge(u, v)

    def link(self, u: int, v: int) -> Link:
        return self.g.edges[u, v]["link"]

    def neighbors(self, u: int) -> List[int]:
        return [v for v in self.g.neighbors(u)
                if self.nodes.get(v, NodeInfo(v, state="failed")).state == "active"]

    def active_nodes(self) -> List[int]:
        return [n for n, i in self.nodes.items() if i.state == "active"]

    # -- path queries (multi-source baseline routing) -----------------------

    def path_delay_per_byte(self, path: List[int]) -> Tuple[float, float]:
        """(total propagation, total per-byte transmission over all hops)."""
        prop = trans = 0.0
        for a, b in zip(path, path[1:]):
            l = self.link(a, b)
            prop += l.latency_s
            trans += l.trans_delay_per_byte
        return prop, trans

    def shortest_path(self, u: int, v: int, nbytes: float) -> List[int]:
        """Shortest route by transfer time for ``nbytes`` (Autoscaling [18])."""
        def w(a, b, d):
            return d["link"].transfer_time(nbytes)

        return graph.shortest_path(self.g, u, v, weight=w)

    def has_path(self, u: int, v: int) -> bool:
        """True when a control route exists (churn can fragment the overlay)."""
        if u not in self.g or v not in self.g:
            return False
        return graph.has_path(self.g, u, v)

    def snapshot(self) -> dict:
        return {
            "nodes": {n: dataclasses.asdict(i) for n, i in self.nodes.items()},
            "links": {f"{u}-{v}": dataclasses.asdict(self.g.edges[u, v]["link"])
                      for u, v in self.g.edges},
        }


# ---------------------------------------------------------------------------
# Generators.
# ---------------------------------------------------------------------------


def random_edge_topology(
    n_nodes: int,
    *,
    seed: int = 0,
    degree: int = 3,
    bw_range=(100.0, 1000.0),
    lat_range=(0.001, 0.02),
    compute_range=(0.5, 2.0),
) -> Topology:
    """Paper §VI-A: Docker VMs with tc-shaped random 100–1000 Mbit/s links."""
    rng = random.Random(seed)
    topo = Topology()
    for i in range(n_nodes):
        topo.add_node(i, compute_s=rng.uniform(*compute_range))
    # Connected backbone (random spanning tree) + extra random edges.
    order = list(range(n_nodes))
    rng.shuffle(order)
    for a, b in zip(order, order[1:]):
        topo.add_link(a, b, _rand_link(rng, bw_range, lat_range))
    target_edges = max(n_nodes - 1, n_nodes * degree // 2)
    while topo.g.number_of_edges() < target_edges:
        u, v = rng.sample(range(n_nodes), 2)
        if not topo.g.has_edge(u, v):
            topo.add_link(u, v, _rand_link(rng, bw_range, lat_range))
    return topo


def _rand_link(rng, bw_range, lat_range) -> Link:
    return Link(rng.uniform(*bw_range), rng.uniform(*lat_range))


def reshuffle_bandwidths(topo: Topology, *, seed: int,
                         bw_range=(100.0, 1000.0)):
    """The paper re-randomizes tc bandwidth every 3 minutes; same here."""
    rng = random.Random(seed)
    for u, v in topo.g.edges:
        topo.g.edges[u, v]["link"].bandwidth_mbps = rng.uniform(*bw_range)
    topo.touch()


def pod_topology(
    n_hosts: int,
    *,
    ici_gbps: float = 50.0 * 8,  # ~50 GB/s per ICI link
    dcn_gbps: float = 6.0 * 8,  # ~6 GB/s effective DCN per host pair
    hosts_per_pod: int = 16,
    ici_lat_s: float = 1e-6,
    dcn_lat_s: float = 50e-6,
) -> Topology:
    """TPU deployment graph: dense fast ICI within a pod, slower DCN across
    pods (DESIGN.md §3 hardware adaptation — the asymmetric-link case the
    paper's shard scheduler targets).

    The rates and latencies are the reference's *modelled* TPU network
    (ICI and DCN), kept as model parameters so plans and routes equal the
    JAX package's; they are not a measurement, and not this port's card or
    its links."""
    topo = Topology()
    for i in range(n_hosts):
        topo.add_node(i, compute_s=0.2)
    for i in range(n_hosts):
        for j in range(i + 1, n_hosts):
            same_pod = (i // hosts_per_pod) == (j // hosts_per_pod)
            if same_pod and (j - i in (1, 4) or abs(j - i) == hosts_per_pod - 1):
                topo.add_link(i, j, Link(ici_gbps * 1000, ici_lat_s))
            elif not same_pod and i % hosts_per_pod == j % hosts_per_pod:
                topo.add_link(i, j, Link(dcn_gbps * 1000, dcn_lat_s))
    return topo
