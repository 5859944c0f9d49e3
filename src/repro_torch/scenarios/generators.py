"""Seeded churn-scenario generators (paper §VI-A's "continuous chaos", made
reproducible), copied from ``repro/scenarios/generators.py``: every
``random.Random`` draw and every set iteration in the reference's order, so
the same call writes the same JSONL in both packages.

Every generator is a pure function of its arguments + seed and returns a
:class:`ScenarioTrace`; the same call produces the same trace forever, which
is what the engine's byte-identical-ledger guarantee builds on.

Catalog:
* ``poisson_churn``      — memoryless independent joins/leaves (the classic
  P2P churn model; rates in events/second).
* ``diurnal_waves``      — joins peak in the "day", leaves in the "night"
  (sinusoidal intensity, thinning sampler) — volunteer-compute behavior.
* ``regional_partition`` — every link crossing a region boundary fails at
  once (backbone cut), optionally healing later.
* ``flash_crowd``        — a burst of joins within a short window (a newly
  announced training run attracting participants).
* ``link_flaps``         — correlated link-failure/link-join pairs clustered
  on one focal node's links (a flaky NIC/ToR switch).
* ``adversarial_churn``  — targeted strikes: each join's best-bandwidth peer
  (the likely largest replication-plan source) fails mid-replication, the
  worst case for the engine's partial-transfer credit path.
* ``bandwidth_degradation`` — mid-replication link-rate drops: each join's
  fastest link collapses to a fraction of its bandwidth while the shard
  streams are in flight (``link-degrade`` events), forcing credit-aware
  reshuffles; optionally the rate restores later.
* ``silent_failures``    — *fault* injection (``node-fault`` / ``link-fault``
  / ``link-loss``): subjects go bad without any churn event, so the cluster
  monitor's heartbeat/probe sweeps must detect them — the trace that turns
  handling-only benchmarks into detection + handling end-to-end numbers.
* ``detector_stress``    — the suspicion detector's worst week on call:
  partial-loss links across a whole spectrum of ``loss_levels`` (some below
  and some above the consecutive-probe-failure threshold's practical reach),
  blackhole flaps (``link-fault`` then a restoring ``link-join``), silent
  node faults, and concurrent joins generating data-plane traffic that
  congests the very paths heartbeats and probes ride.
* ``scheduler_churn``    — the scheduler node itself fails silently
  (``scheduler-fault``) mid-scale-out: deputies must detect the missing
  heartbeat acks, elect a successor, re-adopt the in-flight replications
  from the replicated ledger, and serve the joins that arrived leaderless.
* ``reshard_churn``      — membership walks down a divisor-rich chain
  (spaced crashes) and back up (spaced joins), every event annotated with a
  ``reshard`` policy: the trace that exercises parallelism-plan resharding
  (dp/tp reshapes) rather than placement-only recovery. Events are spaced
  far enough apart that each reshard completes before the next membership
  change, so the simulator and the trainer backend reach the same plan
  after every event (the cross-substrate parity trace).
* ``checkpointed_training`` — poisson crash churn plus trace-borne periodic
  ``checkpoint`` push requests: the GoodPut A/B trace where fixed-cadence
  pushes ride the same contended network as the failures they insure
  against (checkpoint events are no-ops unless the engine runs with a
  checkpoint tier attached).
* ``mixed_faults``       — every fault class in one trace: silent node
  faults, lossy links, a scheduler fault, periodic checkpoint pushes, and
  interleaved joins — the recovery-policy A/B workload where no single
  standing action choice is right for every event.
"""
from __future__ import annotations

import math
import random
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.core.engine import ChurnEvent
from repro_torch.core.topology import Topology
from repro_torch.scenarios.trace import ScenarioTrace

DEFAULT_BW_RANGE = (100.0, 1000.0)  # Mbit/s, the paper's tc range
DEFAULT_LAT_RANGE = (0.001, 0.02)
DEFAULT_COMPUTE_RANGE = (0.5, 2.0)


class _Membership:
    """Tracks who a generator believes is in the cluster while it emits
    events, so leaves target plausible members and joins pick live peers.
    The engine re-validates everything at replay time anyway."""

    def __init__(self, base_nodes: Sequence[int], rng: random.Random,
                 next_id: int = 1000):
        self.alive: List[int] = sorted(base_nodes)
        self.protected = min(self.alive) if self.alive else None  # scheduler
        self.rng = rng
        self.next_id = next_id

    def new_node(self) -> int:
        n = self.next_id
        self.next_id += 1
        return n

    def pick_peers(self, k: int) -> List[int]:
        k = min(k, len(self.alive))
        return sorted(self.rng.sample(self.alive, k))

    def pick_victim(self) -> Optional[int]:
        victims = [n for n in self.alive if n != self.protected]
        if len(victims) <= 1:  # keep a cluster worth scaling
            return None
        return self.rng.choice(victims)

    def join(self, node: int):
        self.alive.append(node)
        self.alive.sort()

    def leave(self, node: int):
        if node in self.alive:
            self.alive.remove(node)


def _join_event(t: float, m: _Membership, rng: random.Random, *,
                max_links: int, bw_range, lat_range, compute_range,
                min_links: int = 1) -> ChurnEvent:
    node = m.new_node()
    peers = m.pick_peers(rng.randint(min(min_links, max_links), max_links))
    links = {p: (rng.uniform(*bw_range), rng.uniform(*lat_range))
             for p in peers}
    ev = ChurnEvent(t=t, kind="join", node=node, links=links,
                    compute_s=rng.uniform(*compute_range))
    m.join(node)
    return ev


def poisson_churn(
    base_nodes: Sequence[int], *, seed: int, horizon_s: float,
    rate_join: float = 0.05, rate_leave: float = 0.04,
    failure_fraction: float = 0.25, max_links: int = 3,
    bw_range=DEFAULT_BW_RANGE, lat_range=DEFAULT_LAT_RANGE,
    compute_range=DEFAULT_COMPUTE_RANGE, t_start: float = 0.0,
) -> ScenarioTrace:
    """Seeded Poisson joins/leaves; ``failure_fraction`` of departures are
    crashes (node-failure) rather than graceful leaves."""
    rng = random.Random(seed)
    m = _Membership(base_nodes, rng)
    events: List[ChurnEvent] = []
    total = rate_join + rate_leave
    t = t_start
    while True:
        t += rng.expovariate(total)
        if t >= t_start + horizon_s:
            break
        if rng.random() < rate_join / total:
            events.append(_join_event(t, m, rng, max_links=max_links,
                                      bw_range=bw_range, lat_range=lat_range,
                                      compute_range=compute_range))
        else:
            victim = m.pick_victim()
            if victim is None:
                continue
            kind = ("node-failure" if rng.random() < failure_fraction
                    else "leave")
            events.append(ChurnEvent(t=t, kind=kind, node=victim))
            m.leave(victim)
    return ScenarioTrace("poisson-churn", seed, events, {
        "rate_join": rate_join, "rate_leave": rate_leave,
        "horizon_s": horizon_s, "base_nodes": len(base_nodes),
    })


def diurnal_waves(
    base_nodes: Sequence[int], *, seed: int, horizon_s: float,
    period_s: float, peak_rate: float = 0.1, amplitude: float = 0.9,
    max_links: int = 3, bw_range=DEFAULT_BW_RANGE,
    lat_range=DEFAULT_LAT_RANGE, compute_range=DEFAULT_COMPUTE_RANGE,
) -> ScenarioTrace:
    """Volunteer-compute pattern: join intensity peaks at phase 0 ("day"),
    leave intensity half a period later ("night"). Sampled by thinning a
    ``peak_rate`` Poisson process with sinusoidal acceptance."""
    rng = random.Random(seed)
    m = _Membership(base_nodes, rng)
    events: List[ChurnEvent] = []

    def intensity(t: float, phase: float) -> float:
        return 0.5 * peak_rate * (1.0 + amplitude
                                  * math.sin(2 * math.pi * t / period_s + phase))

    t = 0.0
    while True:
        t += rng.expovariate(2 * peak_rate)  # envelope for join + leave
        if t >= horizon_s:
            break
        lam_join = intensity(t, 0.0)
        lam_leave = intensity(t, math.pi)
        accept = rng.random() * 2 * peak_rate
        if accept < lam_join:
            events.append(_join_event(t, m, rng, max_links=max_links,
                                      bw_range=bw_range, lat_range=lat_range,
                                      compute_range=compute_range))
        elif accept < lam_join + lam_leave:
            victim = m.pick_victim()
            if victim is not None:
                events.append(ChurnEvent(t=t, kind="leave", node=victim))
                m.leave(victim)
    return ScenarioTrace("diurnal-waves", seed, events, {
        "period_s": period_s, "peak_rate": peak_rate,
        "amplitude": amplitude, "horizon_s": horizon_s,
    })


def regional_partition(
    topo: Topology, *, seed: int, t_cut: float,
    region_fraction: float = 0.4, heal_after_s: Optional[float] = None,
    stagger_s: float = 0.05,
) -> ScenarioTrace:
    """Cut every link crossing a random region boundary (a WAN backbone
    failure isolating ``region_fraction`` of the cluster); if
    ``heal_after_s`` is set the same links come back with their original
    bandwidth/latency."""
    rng = random.Random(seed)
    nodes = sorted(topo.active_nodes())
    k = max(1, int(len(nodes) * region_fraction))
    region: Set[int] = set(rng.sample(nodes, k))
    events: List[ChurnEvent] = []
    cut = []
    for u, v in sorted(topo.g.edges):
        if (u in region) != (v in region):
            cut.append((u, v, topo.link(u, v)))
    for i, (u, v, link) in enumerate(cut):
        jitter = rng.uniform(0, stagger_s)
        events.append(ChurnEvent(t=t_cut + jitter, kind="link-failure",
                                 u=u, v=v))
        if heal_after_s is not None:
            events.append(ChurnEvent(t=t_cut + heal_after_s + jitter,
                                     kind="link-join", u=u, v=v,
                                     bandwidth_mbps=link.bandwidth_mbps,
                                     latency_s=link.latency_s))
    return ScenarioTrace("regional-partition", seed, sorted(events, key=lambda e: e.t), {
        "region": sorted(region), "links_cut": len(cut),
        "healed": heal_after_s is not None,
    })


def flash_crowd(
    base_nodes: Sequence[int], *, seed: int, t_start: float,
    n_joins: int, window_s: float = 5.0, max_links: int = 3,
    bw_range=DEFAULT_BW_RANGE, lat_range=DEFAULT_LAT_RANGE,
    compute_range=DEFAULT_COMPUTE_RANGE,
) -> ScenarioTrace:
    """A burst of ``n_joins`` join requests within ``window_s`` — the
    stress case for overlapping replications sharing source links."""
    rng = random.Random(seed)
    m = _Membership(base_nodes, rng)
    offsets = sorted(rng.uniform(0, window_s) for _ in range(n_joins))
    events = [_join_event(t_start + off, m, rng, max_links=max_links,
                          bw_range=bw_range, lat_range=lat_range,
                          compute_range=compute_range)
              for off in offsets]
    return ScenarioTrace("flash-crowd", seed, events, {
        "n_joins": n_joins, "window_s": window_s,
    })


def link_flaps(
    topo: Topology, *, seed: int, horizon_s: float, n_flaps: int,
    flap_len_s: float = 2.0, correlation: float = 0.7,
) -> ScenarioTrace:
    """Correlated link flapping: with probability ``correlation`` each flap
    hits a link incident to one focal node (a flaky NIC / ToR switch);
    otherwise a uniformly random link. Each flap is a link-failure followed
    by a link-join restoring the original link parameters."""
    rng = random.Random(seed)
    edges = sorted(topo.g.edges)
    if not edges:
        return ScenarioTrace("link-flaps", seed, [], {"n_flaps": 0})
    focal = rng.choice(sorted(topo.active_nodes()))
    focal_edges = [e for e in edges if focal in e]
    events: List[ChurnEvent] = []
    for _ in range(n_flaps):
        t = rng.uniform(0, max(horizon_s - flap_len_s, 0.0))
        pool = focal_edges if (focal_edges and rng.random() < correlation) else edges
        u, v = pool[rng.randrange(len(pool))]
        link = topo.link(u, v)
        events.append(ChurnEvent(t=t, kind="link-failure", u=u, v=v))
        events.append(ChurnEvent(t=t + flap_len_s, kind="link-join", u=u, v=v,
                                 bandwidth_mbps=link.bandwidth_mbps,
                                 latency_s=link.latency_s))
    return ScenarioTrace("link-flaps", seed, sorted(events, key=lambda e: e.t), {
        "focal": focal, "n_flaps": n_flaps, "correlation": correlation,
    })


def _best_peer(links: Dict[int, Tuple[float, float]],
               exclude: Optional[int]) -> Optional[int]:
    """The join's highest-bandwidth peer — the neighbor Algorithm 2 loads
    heaviest, hence the adversary's (or congestion's) natural target."""
    cands = [(bw, p) for p, (bw, _lat) in links.items() if p != exclude]
    if not cands:
        return None
    return max(cands)[1]


def adversarial_churn(
    base_nodes: Sequence[int], *, seed: int, horizon_s: float,
    n_joins: int = 6, strike_delay_s: float = 1.5,
    failure_fraction: float = 1.0, max_links: int = 3,
    bw_range=DEFAULT_BW_RANGE, lat_range=DEFAULT_LAT_RANGE,
    compute_range=DEFAULT_COMPUTE_RANGE,
) -> ScenarioTrace:
    """Targeted leaves of plan-source nodes mid-replication.

    For every join, an adversary watching the overlay strikes the join's
    best-bandwidth peer — the node Algorithm 2 assigns the most shards —
    ``strike_delay_s`` after the join request, i.e. while that peer's shard
    stream is still on the wire. ``failure_fraction`` of strikes are crashes
    (node-failure), the rest graceful leaves. This is the stress case for
    partial-transfer credit: every replication loses its largest source and
    must re-plan, keeping only delivered/credited shards. Joins bring at
    least two links so a strike forces a re-plan, not an abort."""
    rng = random.Random(seed)
    m = _Membership(base_nodes, rng)
    events: List[ChurnEvent] = []
    span = max(horizon_s - strike_delay_s, 0.0)
    times = sorted(rng.uniform(0, span) for _ in range(n_joins))
    strikes = 0
    for t in times:
        ev = _join_event(t, m, rng, max_links=max_links, min_links=2,
                         bw_range=bw_range, lat_range=lat_range,
                         compute_range=compute_range)
        events.append(ev)
        victim = _best_peer(ev.links, exclude=m.protected)
        if victim is None or victim not in m.alive:
            continue
        kind = ("node-failure" if rng.random() < failure_fraction else "leave")
        events.append(ChurnEvent(t=t + strike_delay_s, kind=kind, node=victim))
        m.leave(victim)
        strikes += 1
    return ScenarioTrace("adversarial-churn", seed,
                         sorted(events, key=lambda e: e.t), {
                             "n_joins": n_joins, "strikes": strikes,
                             "strike_delay_s": strike_delay_s,
                             "failure_fraction": failure_fraction,
                             "horizon_s": horizon_s,
                         })


def bandwidth_degradation(
    base_nodes: Sequence[int], *, seed: int, horizon_s: float,
    n_joins: int = 4, drop_after_s: float = 1.5,
    drop_factor: float = 0.1, restore_after_s: Optional[float] = None,
    max_links: int = 3, bw_range=DEFAULT_BW_RANGE,
    lat_range=DEFAULT_LAT_RANGE, compute_range=DEFAULT_COMPUTE_RANGE,
) -> ScenarioTrace:
    """Mid-replication link-rate drops (congestion / tc reshaping).

    Each join's fastest link — carrying the largest planned shard stream —
    collapses to ``drop_factor`` of its bandwidth ``drop_after_s`` after the
    join request, as a ``link-degrade`` event. The engine credits the shards
    already delivered at the old rate and reshuffles the missing bytes over
    the degraded topology. With ``restore_after_s`` the link later degrades
    *back* to its original rate (another ``link-degrade``), so long traces
    exercise both directions of rate change."""
    rng = random.Random(seed)
    m = _Membership(base_nodes, rng)
    events: List[ChurnEvent] = []
    span = max(horizon_s - drop_after_s - (restore_after_s or 0.0), 0.0)
    times = sorted(rng.uniform(0, span) for _ in range(n_joins))
    drops = 0
    for t in times:
        ev = _join_event(t, m, rng, max_links=max_links, min_links=2,
                         bw_range=bw_range, lat_range=lat_range,
                         compute_range=compute_range)
        events.append(ev)
        peer = _best_peer(ev.links, exclude=None)
        if peer is None:
            continue
        bw, lat = ev.links[peer]
        events.append(ChurnEvent(t=t + drop_after_s, kind="link-degrade",
                                 u=peer, v=ev.node,
                                 bandwidth_mbps=bw * drop_factor,
                                 latency_s=lat))
        if restore_after_s is not None:
            events.append(ChurnEvent(
                t=t + drop_after_s + restore_after_s, kind="link-degrade",
                u=peer, v=ev.node, bandwidth_mbps=bw, latency_s=lat))
        drops += 1
    return ScenarioTrace("bandwidth-degradation", seed,
                         sorted(events, key=lambda e: e.t), {
                             "n_joins": n_joins, "drops": drops,
                             "drop_after_s": drop_after_s,
                             "drop_factor": drop_factor,
                             "restored": restore_after_s is not None,
                             "horizon_s": horizon_s,
                         })


def silent_failures(
    topo: Topology, *, seed: int, horizon_s: float,
    n_node_faults: int = 2, n_link_faults: int = 2, n_lossy_links: int = 1,
    loss_rate: float = 0.6, n_joins: int = 1, max_links: int = 3,
    bw_range=DEFAULT_BW_RANGE, lat_range=DEFAULT_LAT_RANGE,
    compute_range=DEFAULT_COMPUTE_RANGE,
) -> ScenarioTrace:
    """Silent faults the monitor must *detect* — no omniscient churn events.

    ``n_node_faults`` nodes go silent (stop heartbeating) and
    ``n_link_faults`` links start blackholing probes at seeded times within
    the horizon; ``n_lossy_links`` more drop probes with probability
    ``loss_rate`` (which may or may not trip the consecutive-failure
    threshold — lossy links are the false-negative/false-positive study).
    Optional ``n_joins`` interleave scale-outs so some faults land
    mid-replication, exercising detection-triggered re-plans. Faulted
    subjects are disjoint (no link fault incident to a silent node): a
    probe that dies with its endpoint is the heartbeat path's detection,
    not the link's.
    """
    rng = random.Random(seed)
    nodes = sorted(topo.active_nodes())
    protected = min(nodes) if nodes else None  # scheduler node
    events: List[ChurnEvent] = []
    pool = [n for n in nodes if n != protected]
    victims = rng.sample(pool, min(n_node_faults, max(len(pool) - 1, 0)))
    for n in sorted(victims):
        events.append(ChurnEvent(t=rng.uniform(0, horizon_s),
                                 kind="node-fault", node=n))
    victim_set = set(victims)
    edges = [(min(u, v), max(u, v)) for u, v in sorted(topo.g.edges)
             if not ({u, v} & victim_set)]
    rng.shuffle(edges)
    k = min(n_link_faults, len(edges))
    for u, v in edges[:k]:
        events.append(ChurnEvent(t=rng.uniform(0, horizon_s),
                                 kind="link-fault", u=u, v=v))
    for u, v in edges[k:k + n_lossy_links]:
        events.append(ChurnEvent(t=rng.uniform(0, horizon_s),
                                 kind="link-loss", u=u, v=v,
                                 loss_rate=loss_rate))
    m = _Membership(nodes, rng)
    for _ in range(n_joins):
        events.append(_join_event(rng.uniform(0, horizon_s), m, rng,
                                  max_links=max_links, min_links=2,
                                  bw_range=bw_range, lat_range=lat_range,
                                  compute_range=compute_range))
    return ScenarioTrace("silent-failures", seed,
                         sorted(events, key=lambda e: e.t), {
                             "n_node_faults": len(victims),
                             "n_link_faults": k,
                             "n_lossy_links": min(n_lossy_links,
                                                  max(len(edges) - k, 0)),
                             "loss_rate": loss_rate, "n_joins": n_joins,
                             "horizon_s": horizon_s,
                         })


def detector_stress(
    topo: Topology, *, seed: int, horizon_s: float,
    loss_levels: Sequence[float] = (0.1, 0.3, 0.6, 0.9, 1.0),
    n_node_faults: int = 1, n_flaps: int = 2, flap_len_s: float = 8.0,
    n_joins: int = 2, max_links: int = 3,
    bw_range=DEFAULT_BW_RANGE, lat_range=DEFAULT_LAT_RANGE,
    compute_range=DEFAULT_COMPUTE_RANGE,
) -> ScenarioTrace:
    """Mixed-severity detection workload for the phi-accrual/adaptive layer.

    One link per entry of ``loss_levels`` starts dropping probes (and, for
    partial rates, inflating data-plane per-byte time by the goodput
    factor); the lowest rates rarely produce the consecutive failures the
    threshold needs (``fault-undetected`` candidates), the highest are
    blackholes. ``n_flaps`` more links hard-fault and are restored by a
    ``link-join`` ``flap_len_s`` later — if detection wins the race the
    link is severed and re-connected, if restoration wins the fault is
    cleared under the sweeps' nose. ``n_node_faults`` nodes go silent, and
    ``n_joins`` scale-outs keep replication traffic on the wire so
    heartbeats and probes contend with real bytes. Node-fault victims
    exclude the scheduler node and faulted links avoid the victims (a
    probe dying with its endpoint is the heartbeat path's detection, not
    the link's); lossy and flapped links may share endpoints with each
    other — interacting link faults are part of the stress."""
    rng = random.Random(seed)
    nodes = sorted(topo.active_nodes())
    protected = min(nodes) if nodes else None  # scheduler node
    events: List[ChurnEvent] = []
    pool = [n for n in nodes if n != protected]
    victims = rng.sample(pool, min(n_node_faults, max(len(pool) - 1, 0)))
    for n in sorted(victims):
        events.append(ChurnEvent(t=rng.uniform(0, horizon_s),
                                 kind="node-fault", node=n))
    victim_set = set(victims)
    edges = [(min(u, v), max(u, v)) for u, v in sorted(topo.g.edges)
             if not ({u, v} & victim_set)]
    rng.shuffle(edges)
    k = min(len(loss_levels), len(edges))
    for rate, (u, v) in zip(loss_levels[:k], edges[:k]):
        events.append(ChurnEvent(t=rng.uniform(0, horizon_s),
                                 kind="link-loss", u=u, v=v,
                                 loss_rate=float(rate)))
    flaps = 0
    for u, v in edges[k:k + n_flaps]:
        t = rng.uniform(0, max(horizon_s - flap_len_s, 0.0))
        link = topo.link(u, v)
        events.append(ChurnEvent(t=t, kind="link-fault", u=u, v=v))
        events.append(ChurnEvent(t=t + flap_len_s, kind="link-join", u=u, v=v,
                                 bandwidth_mbps=link.bandwidth_mbps,
                                 latency_s=link.latency_s))
        flaps += 1
    m = _Membership(nodes, rng)
    for _ in range(n_joins):
        events.append(_join_event(rng.uniform(0, horizon_s), m, rng,
                                  max_links=max_links, min_links=2,
                                  bw_range=bw_range, lat_range=lat_range,
                                  compute_range=compute_range))
    return ScenarioTrace("detector-stress", seed,
                         sorted(events, key=lambda e: e.t), {
                             "loss_levels": [float(r) for r in
                                             loss_levels[:k]],
                             "n_node_faults": len(victims),
                             "n_flaps": flaps, "flap_len_s": flap_len_s,
                             "n_joins": n_joins, "horizon_s": horizon_s,
                         })


def scheduler_churn(
    topo: Topology, *, seed: int, horizon_s: float,
    t_fault: Optional[float] = None, n_joins_before: int = 1,
    n_joins_after: int = 1, lead_s: float = 5.0, max_links: int = 3,
    new_home: Optional[int] = None,
    bw_range=DEFAULT_BW_RANGE, lat_range=DEFAULT_LAT_RANGE,
    compute_range=DEFAULT_COMPUTE_RANGE,
) -> ScenarioTrace:
    """The control plane's own failure mode: the scheduler node dies
    silently mid-scale-out.

    ``n_joins_before`` joins land within ``lead_s`` of the fault, so their
    replications are still on the wire when the scheduler goes dark at
    ``t_fault`` (default: 40% into the horizon) — the stress case for
    deputy re-adoption: scale-outs synced to the deputies before the fault
    are re-adopted with their delivered bytes credited, ones that began
    inside the last sync window are rebuilt. ``n_joins_after`` more joins
    arrive during/after the leaderless window: they park until the peer
    election installs a successor and must complete under the new leader
    (the acceptance check for fail-over actually working). ``new_home``
    optionally pins the preferred successor (honored when it is a live
    deputy). Joins bring at least two links so losing the old scheduler as
    a source forces a re-plan, not an abort."""
    rng = random.Random(seed)
    nodes = sorted(topo.active_nodes())
    home = min(nodes) if nodes else None
    if t_fault is None:
        t_fault = 0.4 * horizon_s
    events: List[ChurnEvent] = []
    m = _Membership(nodes, rng)
    for _ in range(n_joins_before):
        t = t_fault - rng.uniform(0.3, max(lead_s, 0.4))
        events.append(_join_event(max(t, 0.0), m, rng, max_links=max_links,
                                  min_links=2, bw_range=bw_range,
                                  lat_range=lat_range,
                                  compute_range=compute_range))
    events.append(ChurnEvent(t=t_fault, kind="scheduler-fault", node=home,
                             new_home=new_home))
    span = max(horizon_s - t_fault, 1.0)
    for _ in range(n_joins_after):
        t = t_fault + rng.uniform(0.1 * span, span)
        events.append(_join_event(t, m, rng, max_links=max_links,
                                  min_links=2, bw_range=bw_range,
                                  lat_range=lat_range,
                                  compute_range=compute_range))
    return ScenarioTrace("scheduler-churn", seed,
                         sorted(events, key=lambda e: e.t), {
                             "home": home, "t_fault": t_fault,
                             "n_joins_before": n_joins_before,
                             "n_joins_after": n_joins_after,
                             "horizon_s": horizon_s,
                         })


def reshard_churn(
    base_nodes: Sequence[int], *, seed: int, n_failures: int = 3,
    n_joins: int = 2, spacing_s: float = 60.0, reshard: str = "auto",
    failure_fraction: float = 1.0, t_start: float = 10.0,
    max_links: int = 3, bw_range=DEFAULT_BW_RANGE,
    lat_range=DEFAULT_LAT_RANGE, compute_range=DEFAULT_COMPUTE_RANGE,
) -> ScenarioTrace:
    """Membership steps down a divisor-rich chain, then grows back — the
    parallelism-plan resharding trace.

    ``n_failures`` spaced departures (crashes with probability
    ``failure_fraction``) shrink the cluster one node at a time, then
    ``n_joins`` spaced joins grow it back; every event carries the
    ``reshard`` annotation (default ``"auto"``), so each membership change
    re-evaluates the (dp, tp) divisor chain through ``decide_reshard``.
    Events are ``spacing_s`` apart (jitter bounded to a quarter of the
    spacing), wide enough for each reshard's interval-delta fetches to
    drain before the next change: the simulator never cancels a reshard
    mid-flight, so it lands on the same plan sequence as the trainer
    backend, which applies decisions instantly — the property the
    cross-substrate parity tests replay this trace to check. Joins bring
    at least two links so reshard fetches survive a single source loss."""
    rng = random.Random(seed)
    m = _Membership(base_nodes, rng)
    events: List[ChurnEvent] = []
    t = t_start
    fails = 0
    for _ in range(n_failures):
        victim = m.pick_victim()
        if victim is None:
            break
        kind = ("node-failure" if rng.random() < failure_fraction
                else "leave")
        ev = ChurnEvent(t=t + rng.uniform(0, spacing_s / 4), kind=kind,
                        node=victim, reshard=reshard)
        events.append(ev)
        m.leave(victim)
        fails += 1
        t += spacing_s
    for _ in range(n_joins):
        ev = _join_event(t + rng.uniform(0, spacing_s / 4), m, rng,
                         max_links=max_links, min_links=2,
                         bw_range=bw_range, lat_range=lat_range,
                         compute_range=compute_range)
        ev.reshard = reshard
        events.append(ev)
        t += spacing_s
    return ScenarioTrace("reshard-churn", seed,
                         sorted(events, key=lambda e: e.t), {
                             "n_failures": fails, "n_joins": n_joins,
                             "spacing_s": spacing_s, "reshard": reshard,
                             "failure_fraction": failure_fraction,
                             "base_nodes": len(base_nodes),
                         })


def checkpointed_training(
    base_nodes: Sequence[int], *, seed: int, horizon_s: float,
    ckpt_every_s: float = 20.0, rate_leave: float = 0.03,
    failure_fraction: float = 1.0, rate_join: float = 0.02,
    jitter_s: float = 0.5, max_links: int = 3,
    bw_range=DEFAULT_BW_RANGE, lat_range=DEFAULT_LAT_RANGE,
    compute_range=DEFAULT_COMPUTE_RANGE,
) -> ScenarioTrace:
    """Poisson crash churn with trace-borne periodic ``checkpoint`` events.

    Every ``ckpt_every_s`` (± uniform ``jitter_s``) the trace requests a
    checkpoint push: with a checkpoint tier attached the engine forwards it
    to :meth:`SimCheckpointTier.force_push`, so the snapshot rides the same
    contended links as the replications and failures around it; without a
    tier each push request just ledgers ``ckpt-skipped-no-checkpointer``
    and leaves the replay's behavior untouched. ``rate_leave``
    departures are crashes with probability ``failure_fraction`` — the
    events the checkpoints insure against."""
    rng = random.Random(seed)
    m = _Membership(base_nodes, rng)
    events: List[ChurnEvent] = []
    total = rate_join + rate_leave
    t = 0.0
    while total > 0:
        t += rng.expovariate(total)
        if t >= horizon_s:
            break
        if rng.random() < rate_join / total:
            events.append(_join_event(t, m, rng, max_links=max_links,
                                      bw_range=bw_range, lat_range=lat_range,
                                      compute_range=compute_range))
        else:
            victim = m.pick_victim()
            if victim is None:
                continue
            kind = ("node-failure" if rng.random() < failure_fraction
                    else "leave")
            events.append(ChurnEvent(t=t, kind=kind, node=victim))
            m.leave(victim)
    n_ckpts = 0
    tc = ckpt_every_s
    while tc < horizon_s:
        events.append(ChurnEvent(t=tc + rng.uniform(-jitter_s, jitter_s),
                                 kind="checkpoint"))
        n_ckpts += 1
        tc += ckpt_every_s
    return ScenarioTrace("checkpointed-training", seed,
                         sorted(events, key=lambda e: e.t), {
                             "ckpt_every_s": ckpt_every_s,
                             "n_ckpts": n_ckpts, "rate_join": rate_join,
                             "rate_leave": rate_leave,
                             "failure_fraction": failure_fraction,
                             "horizon_s": horizon_s,
                         })


def mixed_faults(
    topo: Topology, *, seed: int, horizon_s: float,
    n_node_faults: int = 2, n_link_loss: int = 2, loss_rate: float = 0.5,
    n_scheduler_faults: int = 1, ckpt_every_s: float = 25.0,
    jitter_s: float = 0.5, n_joins: int = 2,
    recovery: Optional[str] = None, max_links: int = 3,
    bw_range=DEFAULT_BW_RANGE, lat_range=DEFAULT_LAT_RANGE,
    compute_range=DEFAULT_COMPUTE_RANGE,
) -> ScenarioTrace:
    """Every fault class in one trace — the recovery-policy A/B workload.

    Interleaves ``n_node_faults`` silent node faults (detection + node
    recovery), ``n_link_loss`` lossy links at ``loss_rate`` (stream churn
    and credit re-plans), one scheduler fault ~55% into the horizon
    (election + re-adoption), periodic trace-borne ``checkpoint`` pushes
    every ``ckpt_every_s`` (the cold tier's insurance premium), and
    ``n_joins`` scale-outs keeping replication traffic on the contended
    wire. No single standing recovery action is right for all of these:
    the trace exists so fixed policies and the adaptive selector can be
    A/B'd head-to-head (``benchmarks/recovery_policy.py``).

    ``recovery`` optionally annotates every node-fault with a forced
    per-event action (e.g. ``"park-and-degrade"``) — the per-event
    override mirror of the ``reshard`` annotation. Node-fault victims
    exclude the scheduler node (its failure mode is the scheduler-fault)
    and lossy links avoid the victims, same as ``silent_failures``."""
    rng = random.Random(seed)
    nodes = sorted(topo.active_nodes())
    home = min(nodes) if nodes else None
    events: List[ChurnEvent] = []
    pool = [n for n in nodes if n != home]
    victims = rng.sample(pool, min(n_node_faults, max(len(pool) - 1, 0)))
    for n in sorted(victims):
        events.append(ChurnEvent(t=rng.uniform(0, horizon_s),
                                 kind="node-fault", node=n,
                                 recovery=recovery))
    victim_set = set(victims)
    edges = [(min(u, v), max(u, v)) for u, v in sorted(topo.g.edges)
             if not ({u, v} & victim_set)]
    rng.shuffle(edges)
    k = min(n_link_loss, len(edges))
    for u, v in edges[:k]:
        events.append(ChurnEvent(t=rng.uniform(0, horizon_s),
                                 kind="link-loss", u=u, v=v,
                                 loss_rate=loss_rate))
    for i in range(n_scheduler_faults):
        events.append(ChurnEvent(t=(0.55 + 0.2 * i) * horizon_s,
                                 kind="scheduler-fault", node=home))
    n_ckpts = 0
    tc = ckpt_every_s
    while tc < horizon_s:
        events.append(ChurnEvent(t=tc + rng.uniform(-jitter_s, jitter_s),
                                 kind="checkpoint"))
        n_ckpts += 1
        tc += ckpt_every_s
    m = _Membership(nodes, rng)
    for _ in range(n_joins):
        events.append(_join_event(rng.uniform(0, horizon_s), m, rng,
                                  max_links=max_links, min_links=2,
                                  bw_range=bw_range, lat_range=lat_range,
                                  compute_range=compute_range))
    return ScenarioTrace("mixed-faults", seed,
                         sorted(events, key=lambda e: e.t), {
                             "n_node_faults": len(victims),
                             "n_link_loss": k, "loss_rate": loss_rate,
                             "n_scheduler_faults": n_scheduler_faults,
                             "ckpt_every_s": ckpt_every_s,
                             "n_ckpts": n_ckpts, "n_joins": n_joins,
                             "recovery": recovery, "horizon_s": horizon_s,
                         })


GENERATORS = {
    "poisson-churn": poisson_churn,
    "diurnal-waves": diurnal_waves,
    "regional-partition": regional_partition,
    "flash-crowd": flash_crowd,
    "link-flaps": link_flaps,
    "adversarial-churn": adversarial_churn,
    "bandwidth-degradation": bandwidth_degradation,
    "silent-failures": silent_failures,
    "detector-stress": detector_stress,
    "scheduler-churn": scheduler_churn,
    "reshard-churn": reshard_churn,
    "checkpointed-training": checkpointed_training,
    "mixed-faults": mixed_faults,
}
