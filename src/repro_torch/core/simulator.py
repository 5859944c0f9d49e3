"""Discrete-event simulator for the Chaos control plane, copied from
``repro/core/simulator.py``.

Replaces the paper's Docker/tc testbed (§VI-A): virtual-clock event kernel, a
network with per-link store-and-forward FIFO occupancy (multi-hop routes pay
per-hop latency AND contend for links — the Fig 1c pathology emerges
naturally), and synchronous-training iterations with per-node compute times
and all-reduce barriers. The peer-negotiation protocols (negotiation.py) and
the cluster monitor (monitor.py) run *inside* this simulator exchanging real
control messages, so the measured scale-out / scale-in / connect-link /
disconnect-link delays are produced by protocol execution, not closed-form
formulas.
"""
from __future__ import annotations

import heapq
import itertools
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.topology import Link, Topology

CONTROL_MSG_BYTES = 1024.0  # small JSON-ish control messages
#: worst-case queueing a tiny control datagram (heartbeat / probe) suffers
#: behind bulk traffic on a link. Small packets interleave with a bulk
#: stream's packets instead of waiting for the whole transfer, but deep
#: buffers still delay them — this caps that delay, so congestion shows up
#: in control-plane latencies without starving them for a whole transfer.
CONTROL_QUEUE_CAP_S = 0.05


class Sim:
    """Minimal event kernel with daemon (periodic-activity) events.

    A *daemon* event — like the cluster monitor's self-rescheduling heartbeat
    and probe sweeps — runs whenever the clock passes its time but never keeps
    the simulation alive on its own: ``run()`` without ``until`` stops once
    only daemon events remain, exactly like daemon threads not blocking
    process exit. Without this, a periodic sweep would make every
    drain-the-world ``run()`` loop forever.
    """

    def __init__(self):
        self.now = 0.0
        self._heap: list = []
        self._seq = itertools.count()
        self._live = 0  # scheduled non-daemon events not yet executed

    def at(self, t: float, fn: Callable[[], None], daemon: bool = False):
        if not daemon:
            self._live += 1
        heapq.heappush(self._heap, (max(t, self.now), next(self._seq), fn,
                                    daemon))

    def after(self, dt: float, fn: Callable[[], None], daemon: bool = False):
        self.at(self.now + dt, fn, daemon=daemon)

    def run(self, until: Optional[float] = None):
        while self._heap:
            t, _, fn, daemon = self._heap[0]
            if until is None and self._live == 0:
                break  # only daemons left: nothing real to wait for
            if until is not None and t > until:
                break
            heapq.heappop(self._heap)
            if not daemon:
                self._live -= 1
            self.now = t
            fn()
        if until is not None:
            self.now = max(self.now, until)


class TransferHandle:
    """Cancellation token + byte-progress meter for an in-flight transfer.

    Cancelling before the scheduled delivery suppresses the completion
    callback; bandwidth already reserved on the links stays reserved (the
    bytes were on the wire when the event interrupted them — matching what a
    real socket teardown can and cannot reclaim).

    The handle also tracks *delivery progress*: once :meth:`Network.transfer`
    has scheduled the stream, ``progress(now)`` reports how many bytes have
    landed at the destination by virtual time ``now`` (the receiver drains
    the final hop linearly at its link rate). ``cancel(now)`` snapshots that
    value into ``cancelled_delivered`` so the churn engine can credit the
    partial stream instead of forfeiting it — the delta-recovery idea behind
    sub-restart self-healing (paper §IV-C taken to byte granularity)."""

    __slots__ = ("cancelled", "done_t", "nbytes", "t_first_byte",
                 "byte_rate", "cancelled_delivered", "stalled_t")

    def __init__(self):
        self.cancelled = False
        self.done_t: Optional[float] = None
        self.nbytes = 0.0  # payload size, set when the stream is scheduled
        self.t_first_byte: Optional[float] = None  # first byte at destination
        self.byte_rate = 0.0  # destination drain rate (bytes/s, final hop)
        self.cancelled_delivered = 0.0  # bytes landed when cancel() fired
        self.stalled_t: Optional[float] = None  # silent fault froze the stream

    @property
    def done(self) -> bool:
        return self.done_t is not None

    @property
    def stalled(self) -> bool:
        return self.stalled_t is not None

    def progress(self, now: float) -> float:
        """Bytes delivered to the destination by virtual time ``now``."""
        if self.done:
            return float(self.nbytes)
        if self.t_first_byte is None:  # cancelled before the bytes moved
            return 0.0
        if self.stalled_t is not None:  # no byte moved after the silent fault
            now = min(now, self.stalled_t)
        return float(min(self.nbytes,
                         max(0.0, (now - self.t_first_byte) * self.byte_rate)))

    def stall(self, now: float):
        """A silent fault (dead source node, blackholed link) froze the
        stream: delivery never completes and progress stops accruing at
        ``now`` — but the stream stays *pending* (not cancelled) because
        nobody has detected the fault yet. The eventual detection-triggered
        re-plan cancels it and credits the pre-stall prefix."""
        if not self.done and not self.cancelled and self.stalled_t is None:
            self.stalled_t = now

    def cancel(self, now: Optional[float] = None):
        """Cancel the stream; with ``now`` given, snapshot delivery progress
        so the caller can credit the already-delivered prefix."""
        if not self.cancelled and not self.done and now is not None:
            self.cancelled_delivered = self.progress(now)
        self.cancelled = True


class Network:
    """Store-and-forward transfers with per-link FIFO occupancy.

    Two refinements serve the detection layer:

    * **Per-link loss goodput** — :meth:`set_link_loss` records a partial
      packet-loss rate on a link; every transfer scheduled afterwards pays
      a ``1/(1-loss)`` inflation of that hop's per-byte time (the
      retransmission goodput model — the same factor the trainer backend
      applies). Streams already on the wire keep their schedule: their
      packets were sent at the pre-loss rate. Total loss (``rate >= 1``)
      is a blackhole and is modelled by stalling streams, not here.
    * **Non-contending control datagrams** — ``transfer(contend=False)``
      sends a tiny packet (heartbeat, probe) that interleaves with bulk
      traffic instead of queueing behind whole transfers: it never
      reserves link occupancy and waits at most ``CONTROL_QUEUE_CAP_S``
      behind the current backlog, so congestion delays the control plane
      organically without starving it for a replication's duration.
    """

    def __init__(self, sim: Sim, topo: Topology):
        self.sim = sim
        self.topo = topo
        self._link_free: Dict[Tuple[int, int], float] = {}
        self._link_loss: Dict[Tuple[int, int], float] = {}
        self.bytes_on_wire = 0.0
        #: wire bytes of bulk (contending) transfers, counted once per
        #: transfer (not per hop) — callers pass codec *wire* byte counts
        #: (repro_torch.core.codec), so this is the codec A/B's numerator: what
        #: state replication actually put on the network.
        self.data_wire_bytes = 0.0
        #: wire bytes of non-contending control datagrams (heartbeats,
        #: probes, deputy syncs/acks), same once-per-transfer convention.
        self.control_wire_bytes = 0.0
        self.control_messages = 0
        #: completed *bulk* deliveries are reported here as (route, t) — the
        #: cluster monitor subscribes to piggyback probe/heartbeat evidence
        #: on data-plane traffic (a finished transfer proves its links and
        #: endpoints work; the next redundant control datagram is skipped).
        self.on_delivery: Optional[Callable[[List[int], float], None]] = None

    def _key(self, u, v):
        return (min(u, v), max(u, v))

    # -- partial-loss goodput ------------------------------------------------

    def set_link_loss(self, u: int, v: int, rate: float):
        """Start charging the ``1/(1-rate)`` goodput factor on (u, v).

        ``rate`` is clamped to [0, 0.99]: a rate that high is economically
        severed already, and 1.0 would zero the divisor — total loss is the
        stall/blackhole path's job, not a rate inflation."""
        key = self._key(u, v)
        rate = min(max(float(rate), 0.0), 0.99)
        if rate <= 0.0:
            self._link_loss.pop(key, None)
        else:
            self._link_loss[key] = rate

    def clear_link_loss(self, u: int, v: int):
        self._link_loss.pop(self._key(u, v), None)

    def _eff_per_byte(self, link: Link, key: Tuple[int, int]) -> float:
        loss = self._link_loss.get(key)
        per = link.trans_delay_per_byte
        return per / (1.0 - loss) if loss else per

    def _hop(self, u: int, v: int, nbytes: float, t_arrive: float,
             contend: bool = True) -> Tuple[float, float, Link, float]:
        """Returns (delivery time at v, transmission start, link, effective
        per-byte delay), honoring the link's FIFO occupancy for bulk
        transfers and the bounded control-queue delay for datagrams."""
        link = self.topo.link(u, v)
        key = self._key(u, v)
        per = self._eff_per_byte(link, key)
        if contend:
            start = max(t_arrive, self._link_free.get(key, 0.0))
            self._link_free[key] = start + nbytes * per
        else:
            backlog = max(0.0, self._link_free.get(key, 0.0) - t_arrive)
            start = t_arrive + min(backlog, CONTROL_QUEUE_CAP_S)
        done = start + link.latency_s + nbytes * per
        return done, start, link, per

    def transfer(self, route: List[int], nbytes: float,
                 on_done: Callable[[float], None],
                 handle: Optional[TransferHandle] = None,
                 daemon: bool = False,
                 contend: bool = True) -> TransferHandle:
        """Send ``nbytes`` along ``route`` (store-and-forward per hop).

        ``nbytes`` is the caller's **wire** byte count: transfer duration,
        per-link FIFO occupancy, and the ``1/(1-loss)`` goodput inflation
        all apply to what actually crosses the wire. Codec-encoded
        replication streams (repro_torch.core.codec) pass their framed wire size
        here — payload-byte accounting lives with the caller.

        Returns a :class:`TransferHandle`; cancelling it before delivery
        suppresses ``on_done`` (used by the churn engine to invalidate
        replications overtaken by a later churn event). The handle's
        progress fields are primed from the *final* hop: the destination
        receives its first byte once that hop's transmission window opens
        and drains linearly at the hop's link rate, so a cancellation at
        any virtual time knows exactly how many bytes already landed.

        ``daemon`` schedules the delivery as a daemon event — required for
        self-rescheduling periodic traffic (monitor probes/heartbeats),
        which must never keep ``sim.run()`` alive on its own.
        ``contend=False`` sends a non-contending control datagram (see the
        class docstring)."""
        handle = handle if handle is not None else TransferHandle()
        if contend:
            self.data_wire_bytes += nbytes
        else:
            self.control_wire_bytes += nbytes
        t = self.sim.now
        last_start, last_link, last_per = t, None, 0.0
        for a, b in zip(route, route[1:]):
            t, last_start, last_link, last_per = self._hop(
                a, b, nbytes, t, contend=contend)
            self.bytes_on_wire += nbytes
        handle.nbytes = float(nbytes)
        if last_link is not None:
            handle.t_first_byte = last_start + last_link.latency_s
            handle.byte_rate = 1.0 / last_per if last_per > 0 else float("inf")
        else:  # degenerate single-node route: instantly "delivered"
            handle.t_first_byte = t
            handle.byte_rate = float("inf")

        def deliver():
            if handle.cancelled or handle.stalled:
                return
            handle.done_t = t
            on_done(t)
            if contend and self.on_delivery is not None:
                # Control datagrams (contend=False) never count as evidence
                # for piggybacking — they ARE the traffic being saved.
                self.on_delivery(route, t)

        self.sim.at(t, deliver, daemon=daemon)
        return handle

    def metrics_snapshot(self, now: Optional[float] = None) -> Dict:
        """Point-in-time counter read for telemetry scrapes. Pure read —
        never touches the event queue or any transfer state."""
        now = self.sim.now if now is None else float(now)
        backlogs = [max(0.0, free - now) for free in self._link_free.values()]
        return {
            "data_wire_bytes": self.data_wire_bytes,
            "control_wire_bytes": self.control_wire_bytes,
            "control_messages": self.control_messages,
            "bytes_on_wire": self.bytes_on_wire,
            "queue_backlog_s": math.fsum(b for b in backlogs if b > 0.0),
            "queued_links": sum(1 for b in backlogs if b > 0.0),
        }

    def control(self, u: int, v: int, on_done: Callable[[], None],
                payload_bytes: float = CONTROL_MSG_BYTES):
        """Control message over the direct link (or shortest route)."""
        self.control_messages += 1
        if u == v:
            self.sim.after(1e-6, on_done)
            return
        if self.topo.has_link(u, v):
            route = [u, v]
        else:
            route = self.topo.shortest_path(u, v, payload_bytes)
        t = self.sim.now
        for a, b in zip(route, route[1:]):
            # Control messages don't meaningfully occupy links.
            t += self.topo.link(a, b).latency_s
        self.sim.at(t, lambda: on_done())


# ---------------------------------------------------------------------------
# Synchronous training session with barriers.
# ---------------------------------------------------------------------------


@dataclass
class TrainEvents:
    """Per-node bookkeeping for idle-time accounting."""
    compute_done: Dict[int, float] = field(default_factory=dict)
    allreduce_done: Dict[int, float] = field(default_factory=dict)
    blocked: Dict[int, float] = field(default_factory=dict)  # accumulated idle


class TrainingSession:
    """Iteration-driven synchronous data-parallel training.

    Each iteration: every active node computes for ``compute_s`` (own speed),
    waits at the all-reduce barrier, then all-reduce runs for a time set by a
    simple decentralized-ring model over the overlay; per-node finish skew
    (τ^sync) is derived from each node's slowest incident link.
    """

    def __init__(self, sim: Sim, net: Network, topo: Topology,
                 state_bytes: int):
        self.sim = sim
        self.net = net
        self.topo = topo
        self.state_bytes = state_bytes
        self.iteration = 0
        self.events = TrainEvents()
        self.idle: Dict[int, float] = {}
        self.sync_skew: Dict[int, float] = {}
        self._barrier_extra: Dict[int, float] = {}  # injected stalls (scale-out)
        self._iter_cb: List[Callable[[int], None]] = []
        self.paused = False

    # -- models -------------------------------------------------------------

    def allreduce_time(self) -> float:
        nodes = self.topo.active_nodes()
        n = len(nodes)
        if n <= 1:
            return 0.0
        # Ring all-reduce over the overlay: 2(n-1)/n of state over the
        # bottleneck link + latency per step.
        links = [self.topo.link(u, v) for u, v in self.topo.g.edges
                 if self.topo.nodes[u].state == "active"
                 and self.topo.nodes[v].state == "active"]
        if not links:
            return 0.0
        bw = min(l.bytes_per_s for l in links)
        lat = max(l.latency_s for l in links)
        return 2 * (n - 1) / n * self.state_bytes / bw + 2 * (n - 1) * lat

    def node_sync_skew(self, u: int) -> float:
        """τ^sync estimate: slower-linked nodes exit the ring later."""
        nbrs = self.topo.neighbors(u)
        if not nbrs:
            return 0.0
        worst = max(self.topo.link(u, v).latency_s for v in nbrs)
        return worst * len(self.topo.active_nodes())

    # -- iteration loop -------------------------------------------------------

    def on_iteration(self, cb: Callable[[int], None]):
        self._iter_cb.append(cb)

    def inject_stall(self, node: int, seconds: float):
        """Extra time ``node`` must spend before the next barrier (e.g. while
        serving state shards synchronously — not used by Chaos, which
        overlaps; used by the EDL+/Autoscaling barrier models)."""
        self._barrier_extra[node] = self._barrier_extra.get(node, 0.0) + seconds

    def run_iterations(self, n: int) -> Dict[int, float]:
        """Run n iterations; returns accumulated per-node idle seconds."""
        for _ in range(n):
            self.step()
        return dict(self.idle)

    def step(self):
        nodes = self.topo.active_nodes()
        if not nodes:
            return
        t0 = self.sim.now
        ready = {}
        for u in nodes:
            c = self.topo.nodes[u].compute_s
            ready[u] = t0 + c + self._barrier_extra.pop(u, 0.0)
        barrier = max(ready.values())
        for u in nodes:
            self.idle[u] = self.idle.get(u, 0.0) + (barrier - ready[u])
        ar = self.allreduce_time()
        for u in nodes:
            skew = self.node_sync_skew(u)
            self.sync_skew[u] = skew
            self.events.allreduce_done[u] = barrier + ar + skew
        end = barrier + ar + (max(self.sync_skew[u] for u in nodes) if nodes else 0.0)
        self.sim.run(until=end)
        self.iteration += 1
        for cb in list(self._iter_cb):
            cb(self.iteration)
