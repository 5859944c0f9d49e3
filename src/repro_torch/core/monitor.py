"""Cluster monitor (paper §IV-A): overlay-topology tracking, node/link event
detection (control messages, heartbeats, probes), and on-demand network
resource measurement. Runs inside the discrete-event simulator; on a real
deployment the same interface is backed by host agents + iperf probes.
Copied from ``repro/core/monitor.py``; the relay-disjoint heartbeat routes
use the stdlib graph's ``restricted_view`` and ``shortest_path``.

Detection is *active* and rides the simulated network: once
:meth:`ClusterMonitor.start_sweeps` is called, periodic sweeps (daemon events
on the virtual clock) make every live node send a small heartbeat datagram to
the monitor's home node and launch a small probe transfer on every live link.
A congested, degraded, or lossy path delays or drops those datagrams
organically — a probe "fails" when its transfer does not complete within
``PROBE_TIMEOUT_S``, not because the monitor peeked at the fault tables.

Two detectors are available (``detector=``):

* ``"phi"`` (default) — a phi-accrual suspicion detector: each node's
  heartbeat inter-arrival history yields a suspicion score
  ``phi = -log10 P(no heartbeat for this long)``; the node is declared dead
  once ``phi >= PHI_THRESHOLD``. Because the score adapts to the *observed*
  arrival process, WAN jitter and congestion widen the tolerance instead of
  causing false positives, and a tight arrival history crosses the threshold
  well before a fixed timeout would. Sweep periods are **adaptive**: they
  back off geometrically while every suspicion is low and tighten to
  ``SWEEP_TIGHTEN_FACTOR`` of the base period while any suspicion is
  elevated or any probe-failure counter is non-zero.
* ``"fixed"`` — the pre-phi baseline (fixed ``HEARTBEAT_TIMEOUT_S`` lapse,
  constant sweep periods), kept for the detection-latency A/B in
  ``benchmarks/scaleout_delay.py --detected``.

Faults injected with :meth:`inject_node_fault` / :meth:`inject_link_fault` /
:meth:`inject_link_loss` change the *world* the sweeps observe: a silent node
stops sending heartbeats, a blackholed link swallows every datagram routed
over it, and a lossy link drops each probe with probability ``loss_rate``
(per-link seeded RNG streams, so one link's detection fate is invariant to
churn elsewhere) while its data-plane per-byte time inflates by the
``1/(1-loss)`` goodput factor (``Network.set_link_loss``). The monitor
reports detections through ``on_node_detected`` / ``on_link_detected``
together with the injection time, so callers can measure fault-to-detection
latency.

Two extensions: **probe piggybacking** (a completed bulk transfer is
fresh probe/heartbeat evidence for its links and endpoints — the next
redundant control datagram is skipped; ``piggyback = False`` restores
always-probe) and **scheduler silence** (``scheduler_silent``: the home
node died, so this monitor processes nothing until the decentralized
control plane (``repro_torch.core.control``) elects a
successor and calls :meth:`rebase_home`).
"""
from __future__ import annotations

import math
import random
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Set, Tuple

from repro_torch.core import graph
from repro_torch.core.simulator import Network, Sim
from repro_torch.core.topology import Link, Topology

HEARTBEAT_PERIOD_S = 2.0
HEARTBEAT_TIMEOUT_S = 6.0  # fixed-detector lapse threshold
PROBE_PERIOD_S = 1.0
PROBE_FAILURES_FOR_LINK_DOWN = 2
PROBE_TIMEOUT_S = 0.4  # a probe not delivered by then counts as failed
MEASURE_SECONDS = 0.5  # iperf-style bandwidth probe duration per link
HEARTBEAT_BYTES = 256.0  # heartbeat datagram riding the simulated network
PROBE_BYTES = 256.0  # probe datagram riding the simulated network

# -- phi-accrual suspicion ---------------------------------------------------
PHI_THRESHOLD = 8.0  # declare dead at P(alive) <= 1e-8
PHI_ELEVATED = 1.0  # any node above this keeps sweeps tightened
PHI_HISTORY = 32  # inter-arrival samples kept per node
PHI_MIN_STD_FRACTION = 0.25  # std floor, as a fraction of the heartbeat period

# -- adaptive sweep periods --------------------------------------------------
SWEEP_BACKOFF = 1.5  # period multiplier applied per quiet sweep
SWEEP_MAX_FACTOR = 4.0  # periods never exceed base * this
SWEEP_TIGHTEN_FACTOR = 0.5  # period factor while any suspicion is elevated

#: give-up windows, in worst-case (fully backed-off) sweep periods: a fault
#: still pending after this many is declared undetectable by the engine's
#: drain. Node/link faults always trip their detectors well inside the
#: window; the loss window is the real policy knob (a low-rate lossy link
#: may never produce the required *consecutive* probe failures).
NODE_GIVEUP_SWEEPS = 16
LINK_GIVEUP_SWEEPS = 8
LOSS_GIVEUP_SWEEPS = 32

DETECTORS = ("fixed", "phi")

#: heartbeat-ack datagram the scheduler sends back to its deputies — the
#: signal the decentralized control plane (repro_torch.core.control) watches to
#: detect the scheduler's *own* silence (inverting the one-way heartbeat).
ACK_BYTES = 128.0

_SQRT2 = math.sqrt(2.0)


def phi_score(elapsed: float, mean: float, std: float) -> float:
    """Phi-accrual suspicion: ``-log10 P(inter-arrival > elapsed)`` under a
    normal model of the arrival process. Deterministic, monotone in
    ``elapsed``; capped at 300 where the tail underflows."""
    z = (elapsed - mean) / std
    p = 0.5 * math.erfc(z / _SQRT2)
    if p <= 1e-300:
        return 300.0
    return -math.log10(p)


@dataclass
class EventRecord:
    t: float
    kind: str  # join | leave | node-failure | link-join | link-leave | link-failure
    subject: Tuple
    detail: str = ""


@dataclass
class _ArrivalStats:
    """Per-node heartbeat arrival history feeding the phi estimator."""
    last: float
    window: Deque[float] = field(
        default_factory=lambda: deque(maxlen=PHI_HISTORY))

    def observe(self, now: float):
        self.window.append(max(0.0, now - self.last))
        self.last = now

    def mean_std(self) -> Tuple[float, float]:
        w = self.window
        if not w:
            return 0.0, 0.0
        m = sum(w) / len(w)
        var = sum((x - m) ** 2 for x in w) / len(w)
        return m, math.sqrt(var)


class ClusterMonitor:
    """Tracks node state, heartbeats, link probes, and network resources."""

    def __init__(self, sim: Sim, net: Network, topo: Topology,
                 detector: str = "phi"):
        self.sim = sim
        self.net = net
        self.topo = topo
        if detector not in DETECTORS:
            raise ValueError(f"unknown detector {detector!r}")
        self.detector = detector
        #: node the heartbeats are sent to (the scheduler node); defaults to
        #: the lowest live node id when unset.
        self.home: Optional[int] = None
        self.last_heartbeat: Dict[int, float] = {}
        self.events: List[EventRecord] = []
        self.on_node_failure: Optional[Callable[[int], None]] = None
        self.on_link_failure: Optional[Callable[[int, int], None]] = None
        #: detection-aware callbacks: (subject…, fault_t | None, detected_t).
        #: When set they take precedence over the legacy callbacks above.
        self.on_node_detected: Optional[
            Callable[[int, Optional[float], float], None]] = None
        self.on_link_detected: Optional[
            Callable[[int, int, Optional[float], float], None]] = None
        #: an injected fault became moot before detection (its subject was
        #: removed by other churn): (fault kind, subject tuple, fault_t).
        self.on_fault_cleared: Optional[
            Callable[[str, Tuple, float], None]] = None
        #: home processed a heartbeat from this node — the control plane
        #: subscribes to send the ack datagram deputies watch.
        self.on_heartbeat_from: Optional[Callable[[int], None]] = None
        #: the scheduler node failed silently: the monitor process living on
        #: it is dead — it processes no heartbeats, launches no probes, and
        #: declares nothing until a peer election installs a new home
        #: (``rebase_home``). Node agents keep *sending* (they don't know).
        self.scheduler_silent = False
        self._probe_failures: Dict[Tuple[int, int], int] = {}
        # Injected faults awaiting detection: subject -> injection time,
        # plus the give-up deadline the engine's drain honors.
        self._node_faults: Dict[int, float] = {}
        self._link_faults: Dict[Tuple[int, int], float] = {}
        self._link_loss: Dict[Tuple[int, int], Tuple[float, float]] = {}
        #: loss whose detection attribution the drain gave up on — the
        #: *world* stays lossy (probe drops, goodput inflation) until the
        #: link itself churns; give-up is detector bookkeeping, not repair.
        self._expired_loss: Dict[Tuple[int, int], float] = {}
        self._giveup: Dict[Tuple[str, Tuple], float] = {}
        self._silenced: Set[int] = set()  # detected-dead, pending removal
        self.heartbeat_period = HEARTBEAT_PERIOD_S
        self.heartbeat_timeout = HEARTBEAT_TIMEOUT_S
        self.probe_period = PROBE_PERIOD_S
        self.probe_timeout = PROBE_TIMEOUT_S
        self.phi_threshold = PHI_THRESHOLD
        #: phi value that crossed the threshold for the most recent
        #: detection (None under the fixed detector) — read by the engine
        #: backend inside the detection callback for the ledger record.
        self.last_suspicion: Optional[float] = None
        self.sweeps_on = False
        #: iperf bursts from measure_links occupy the network only once
        #: sweeps are on (detected mode) — omniscient replays stay
        #: byte-identical to the bookkeeping-only era.
        self.measurement_traffic = False
        self._sweep_gen = 0  # stale sweep chains self-cancel on mismatch
        self._sweep_seed = 0
        self._hb_scale = 1.0
        self._probe_scale = 1.0
        self._hb_interval = self.heartbeat_period  # last scheduled interval
        self._hb_stats: Dict[int, _ArrivalStats] = {}
        self._hb_seq: Dict[int, int] = {}  # per-node heartbeat sequence sent
        self._hb_delivered: Dict[int, int] = {}  # highest sequence received
        self._link_rngs: Dict[Tuple[int, int], random.Random] = {}
        self._probe_epoch: Dict[Tuple[int, int], int] = {}
        # Heartbeat routes cached per sender, invalidated by topo.version:
        # two Dijkstras per node per sweep only when the overlay changed.
        self._route_cache: Dict[int, Tuple[int, List[List[int]]]] = {}
        # -- probe piggybacking on data-plane traffic ----------------------
        # A completed bulk transfer proves its links carry bytes and its
        # endpoints are alive; the next redundant probe/heartbeat datagram
        # is skipped and the observation counted directly.
        self.piggyback = True
        self._fresh_link_obs: Dict[Tuple[int, int], float] = {}
        self._fresh_node_obs: Dict[int, float] = {}
        self._last_probe_sweep_t = 0.0
        self._last_hb_sweep_t = 0.0
        #: control datagrams actually put on the wire (heartbeat copies,
        #: probes, control-plane acks/syncs) — the piggybacking win is this
        #: number going *down* for the same trace.
        self.control_datagrams = 0
        self.piggybacked_probes = 0
        self.piggybacked_heartbeats = 0

    @staticmethod
    def _key(u: int, v: int) -> Tuple[int, int]:
        return (min(u, v), max(u, v))

    # -- topology bookkeeping -------------------------------------------------

    def record(self, kind: str, subject, detail: str = ""):
        self.events.append(EventRecord(self.sim.now, kind, tuple(subject) if
                                       isinstance(subject, (list, tuple)) else (subject,),
                                       detail))

    def _prime_node(self, node_id: int):
        """(Re)start the node's arrival history: last arrival = now, one
        synthetic inter-arrival at the configured heartbeat period so phi is
        defined before real samples accumulate."""
        st = _ArrivalStats(self.sim.now)
        st.window.append(self.heartbeat_period)
        self._hb_stats[node_id] = st
        self.last_heartbeat[node_id] = self.sim.now
        # Late datagrams from a previous incarnation must not count.
        self._hb_seq[node_id] = self._hb_delivered[node_id] = (
            max(self._hb_seq.get(node_id, 0),
                self._hb_delivered.get(node_id, 0)))

    def register_join(self, node_id: int, links: Dict[int, Link], compute_s=1.0):
        info = self.topo.add_node(node_id, compute_s=compute_s)
        info.state = "standby"
        info.join_time = self.sim.now
        for peer, link in links.items():
            self.topo.add_link(node_id, peer, link)
        self._prime_node(node_id)
        self._silenced.discard(node_id)
        self.record("join", node_id)
        return info

    def _drop_node_tracking(self, node_id: int):
        """Stop tracking a node's heartbeats: entry, arrival history, and
        any still-in-flight datagram copies (the delivered watermark jumps
        to the last sequence sent, so stragglers can't resurrect it)."""
        self.last_heartbeat.pop(node_id, None)
        self._hb_stats.pop(node_id, None)
        self._fresh_node_obs.pop(node_id, None)
        self._hb_delivered[node_id] = self._hb_seq.get(node_id, 0)

    def activate(self, node_id: int):
        self.topo.nodes[node_id].state = "active"

    def register_leave(self, node_id: int, failure: bool = False):
        if node_id in self.topo.nodes:
            self.topo.nodes[node_id].state = "failed" if failure else "left"
            self.topo.g.remove_node(node_id)
            self.topo.g.add_node(node_id)  # keep id known, no links
            self.topo.touch()  # direct graph surgery: invalidate route caches
        # A departed node can't heartbeat, answer probes, or stay faulted:
        # drop every piece of monitor state that references it, so a later
        # re-join starts with clean counters. Pending faults the departure
        # absorbs are reported as cleared, not silently forgotten.
        self._drop_node_tracking(node_id)
        fault_t = self._node_faults.pop(node_id, None)
        self._giveup.pop(("node", (node_id,)), None)
        if fault_t is not None and self.on_fault_cleared:
            self.on_fault_cleared("node-fault", (node_id,), fault_t)
        self._silenced.discard(node_id)
        self._drop_link_state_for(node_id)
        self.record("node-failure" if failure else "leave", node_id)

    def reset_link(self, u: int, v: int):
        """A link was (re-)established or removed: its probe-failure counter
        and any injected fault are moot. Without this a re-connected link
        inherits the old consecutive-failure count and can be declared down
        after a single failed probe. In-flight probes from the link's
        previous life are invalidated by bumping its probe epoch."""
        key = self._key(u, v)
        self._probe_failures.pop(key, None)
        self._probe_epoch[key] = self._probe_epoch.get(key, 0) + 1
        self._fresh_link_obs.pop(key, None)  # evidence predates this life
        self._clear_link_fault(key)

    def _clear_link_fault(self, key: Tuple[int, int]):
        self.net.clear_link_loss(*key)
        fault_t = self._link_faults.pop(key, None)
        self._giveup.pop(("link", key), None)
        if fault_t is not None and self.on_fault_cleared:
            self.on_fault_cleared("link-fault", key, fault_t)
        loss = self._link_loss.pop(key, None)
        self._expired_loss.pop(key, None)
        self._giveup.pop(("loss", key), None)
        if loss is not None and self.on_fault_cleared:
            self.on_fault_cleared("link-loss", key, loss[1])

    def _drop_link_state_for(self, node: int):
        for key in [k for k in self._probe_failures if node in k]:
            del self._probe_failures[key]
        for key in sorted(set(self._link_faults) | set(self._link_loss)):
            if node in key:
                self._clear_link_fault(key)

    # -- fault injection (silent failures the sweeps must detect) --------------

    def _max_period(self, base: float) -> float:
        """Worst-case sweep period: the fixed detector never backs off, so
        its give-up windows (and drain steps) stay in base periods."""
        return base * (SWEEP_MAX_FACTOR if self.detector == "phi" else 1.0)

    def inject_node_fault(self, node: int):
        """The node goes silent (crash, hang, severed management plane): it
        stops heartbeating but no churn event is emitted — detection is the
        heartbeat sweep's job."""
        if node not in self._node_faults:
            self._node_faults[node] = self.sim.now
            self._giveup[("node", (node,))] = (
                self.sim.now
                + NODE_GIVEUP_SWEEPS * self._max_period(self.heartbeat_period))
        self.record("node-fault", node, "injected")

    def inject_link_fault(self, u: int, v: int):
        """The link silently blackholes traffic: every datagram routed over
        it (probe or heartbeat) is swallowed."""
        key = self._key(u, v)
        if key not in self._link_faults:
            self._link_faults[key] = self.sim.now
            self._giveup[("link", key)] = (
                self.sim.now
                + LINK_GIVEUP_SWEEPS * self._max_period(self.probe_period))
        self.record("link-fault", key, "injected")

    def inject_link_loss(self, u: int, v: int, loss_rate: float):
        """The link starts dropping each probe with probability
        ``loss_rate`` (per-link seeded stream) and — for partial loss — its
        data-plane per-byte time inflates by the ``1/(1-loss)`` goodput
        factor for every transfer scheduled from now on. Total loss
        (``rate >= 1``) blackholes datagrams like a link-fault; the data
        plane is stalled by the engine."""
        key = self._key(u, v)
        rate = min(max(float(loss_rate), 0.0), 1.0)
        if key not in self._link_loss:
            self._link_loss[key] = (rate, self.sim.now)
            self._giveup[("loss", key)] = (
                self.sim.now
                + LOSS_GIVEUP_SWEEPS * self._max_period(self.probe_period))
            if rate < 1.0:
                self.net.set_link_loss(*key, rate)
        self.record("link-loss", key, "injected")

    def node_faulted(self, node: int) -> bool:
        return node in self._node_faults or node in self._silenced

    def link_fault_pending(self, u: int, v: int) -> bool:
        key = self._key(u, v)
        return key in self._link_faults or key in self._link_loss

    def faulted_nodes(self) -> List[int]:
        """Nodes currently silent (injected fault or detected-dead but not
        yet removed): no byte can originate from or transit them."""
        return sorted(set(self._node_faults) | self._silenced)

    def faulted_links(self) -> List[Tuple[int, int]]:
        """Links currently blackholing data: hard faults plus total loss
        (partial loss degrades goodput, it doesn't stop bytes) — whether
        or not detection attribution has expired."""
        return sorted(set(self._link_faults)
                      | {k for k, (rate, _) in self._link_loss.items()
                         if rate >= 1.0}
                      | {k for k, rate in self._expired_loss.items()
                         if rate >= 1.0})

    # -- drain contract (suspicion-aware deadlines) ----------------------------

    def detection_horizon(self) -> Optional[float]:
        """Earliest give-up deadline among pending faults, or None when no
        fault is pending. The engine's drain advances the clock toward this
        (in bounded steps) until every fault is detected or expired."""
        return min(self._giveup.values()) if self._giveup else None

    def drain_step_s(self) -> float:
        """Safe clock increment for the drain loop: one fully backed-off
        sweep period, so sweeps always get to run between steps."""
        return self._max_period(max(self.heartbeat_period, self.probe_period))

    def expire_faults(self, now: float) -> List[Tuple[str, Tuple, float]]:
        """Drop injected faults whose give-up deadline has passed; returns
        [(fault kind, subject, fault_t)] for ledger bookkeeping."""
        out: List[Tuple[str, Tuple, float]] = []
        for (fam, subject), deadline in sorted(self._giveup.items()):
            if now < deadline - 1e-9:
                continue
            del self._giveup[(fam, subject)]
            if fam == "node":
                t = self._node_faults.pop(subject[0], None)
                if t is not None:
                    out.append(("node-fault", subject, t))
            elif fam == "link":
                t = self._link_faults.pop(subject, None)
                if t is not None:
                    out.append(("link-fault", subject, t))
            else:  # loss
                entry = self._link_loss.pop(subject, None)
                if entry is not None:
                    # Attribution ends; the physics stays. The link keeps
                    # dropping probes and inflating per-byte time (exactly
                    # as TrainerBackend keeps its goodput inflation) until
                    # the link itself churns — a later consecutive-failure
                    # detection is then an organic one with no fault_t.
                    self._expired_loss[subject] = entry[0]
                    out.append(("link-loss", subject, entry[1]))
        return out

    # -- periodic sweeps (daemon activities on the virtual clock) ---------------

    def start_sweeps(self, *, seed: int = 0,
                     heartbeat_period: Optional[float] = None,
                     probe_period: Optional[float] = None,
                     detector: Optional[str] = None):
        """Schedule periodic heartbeat + probe sweeps as daemon events.

        Daemon events never keep ``sim.run()`` alive on their own, so sweeps
        can self-reschedule forever without hanging drains. Idempotent while
        running; after :meth:`stop_sweeps`, a new call starts a fresh sweep
        *generation* — the orphaned chains of the previous generation
        self-cancel instead of resuming alongside the new one (which would
        double every sweep and RNG draw)."""
        if self.sweeps_on:
            return
        if heartbeat_period is not None:
            self.heartbeat_period = float(heartbeat_period)
        if probe_period is not None:
            self.probe_period = float(probe_period)
        if detector is not None:
            if detector not in DETECTORS:
                raise ValueError(f"unknown detector {detector!r}")
            self.detector = detector
        self.sweeps_on = True
        self.measurement_traffic = True
        self._sweep_seed = int(seed)
        self._link_rngs = {}
        self._sweep_gen += 1
        gen = self._sweep_gen
        self._hb_scale = 1.0
        self._probe_scale = 1.0
        self._hb_interval = self.heartbeat_period
        self._last_probe_sweep_t = self.sim.now
        self._last_hb_sweep_t = self.sim.now
        self.net.on_delivery = self.note_data_delivery
        for n in self._live_nodes():
            self._prime_node(n)
        self.sim.at(self.sim.now + self.heartbeat_period,
                    lambda: self._heartbeat_sweep(gen), daemon=True)
        self.sim.at(self.sim.now + self.probe_period,
                    lambda: self._probe_sweep(gen), daemon=True)

    def stop_sweeps(self):
        self.sweeps_on = False
        self.measurement_traffic = False  # bursts exist only in detected mode
        self.net.on_delivery = None
        self._sweep_gen += 1  # any still-scheduled chain is now stale

    def note_data_delivery(self, route: List[int], t: float):
        """A bulk data-plane transfer completed along ``route``: every hop
        demonstrably carried bytes and both endpoints demonstrably ran the
        protocol — fresh probe evidence for the links and heartbeat
        evidence for the endpoints, free of charge. The shard-completion
        report the source sends the scheduler doubles as its beat."""
        for a, b in zip(route, route[1:]):
            self._fresh_link_obs[self._key(a, b)] = t
        if len(route) > 1:
            self._fresh_node_obs[route[0]] = t
            self._fresh_node_obs[route[-1]] = t

    def _live_nodes(self) -> List[int]:
        return sorted(n for n, i in self.topo.nodes.items()
                      if i.state in ("active", "standby"))

    def _home(self) -> Optional[int]:
        if self.home is not None:
            return self.home
        live = self._live_nodes()
        return live[0] if live else None

    def rebase_home(self, new_home: int):
        """A peer election promoted ``new_home`` to scheduler: heartbeats
        route there from now on. Cached heartbeat routes all pointed at the
        old home, so the cache is wiped wholesale (cheaper and safer than
        versioning the home like the topology)."""
        self.home = new_home
        self.scheduler_silent = False
        self._route_cache.clear()

    def defer_node_giveup(self, node: int):
        """Suspend the monitor-owned give-up deadline for a pending node
        fault: while the cluster is leaderless the dead *scheduler* cannot
        be detected by its own sweeps — the control plane owns the clock
        (election give-up) until a new home is installed."""
        self._giveup.pop(("node", (node,)), None)

    def restore_node_giveup(self, node: int):
        """Re-arm the give-up deadline (relative to now) for a pending node
        fault whose detection just became possible again — the new home's
        freshly restarted sweeps get a full window."""
        if node in self._node_faults:
            self._giveup[("node", (node,))] = (
                self.sim.now
                + NODE_GIVEUP_SWEEPS * self._max_period(self.heartbeat_period))

    def _sweep_alerted(self) -> bool:
        """Observed evidence of trouble: any elevated suspicion or any
        non-zero consecutive-probe-failure counter. Purely detector-side —
        never peeks at the injected-fault tables."""
        if self._probe_failures:
            return True
        return any(self.suspicion(n) >= PHI_ELEVATED
                   for n in self.last_heartbeat)

    def _next_scale(self, scale: float) -> float:
        if self.detector != "phi":
            return 1.0  # fixed detector keeps fixed periods (A/B baseline)
        if self._sweep_alerted():
            return SWEEP_TIGHTEN_FACTOR
        return min(scale * SWEEP_BACKOFF, SWEEP_MAX_FACTOR)

    def _heartbeat_sweep(self, gen: int):
        if not self.sweeps_on or gen != self._sweep_gen:
            return
        self.check_heartbeats()
        for n in self._live_nodes():
            if self.node_faulted(n):
                continue
            if (self.piggyback
                    and self._fresh_node_obs.get(n, -1.0)
                    >= self._last_hb_sweep_t):
                # The node completed a data-plane transfer since the last
                # sweep; its shard-completion report to the scheduler
                # doubles as this sweep's beat — skip the redundant
                # heartbeat datagram.
                self.piggybacked_heartbeats += 1
                self.heartbeat(n)
            else:
                self._send_heartbeat(n)  # healthy nodes keep beating
        self._last_hb_sweep_t = self.sim.now
        self._hb_scale = self._next_scale(self._hb_scale)
        self._hb_interval = self.heartbeat_period * self._hb_scale
        self.sim.at(self.sim.now + self._hb_interval,
                    lambda: self._heartbeat_sweep(gen), daemon=True)

    def _probe_sweep(self, gen: int):
        if not self.sweeps_on or gen != self._sweep_gen:
            return
        if not self.scheduler_silent:
            # A dead scheduler launches no probes; the chain keeps
            # rescheduling so probing resumes the instant a new home is
            # installed (sweeps are restarted then anyway).
            for u, v in self._probe_targets():
                self._launch_probe(u, v)
            self._last_probe_sweep_t = self.sim.now
        self._probe_scale = self._next_scale(self._probe_scale)
        self.sim.at(self.sim.now + self.probe_period * self._probe_scale,
                    lambda: self._probe_sweep(gen), daemon=True)

    def _probe_targets(self) -> List[Tuple[int, int]]:
        """Links probed this sweep: both endpoints live and not silent — a
        probe that dies because its *endpoint* is dead is the heartbeat
        path's failure to detect, not the link's."""
        live = {n for n in self._live_nodes() if not self.node_faulted(n)}
        return sorted(self._key(u, v) for u, v in self.topo.g.edges
                      if u in live and v in live)

    # -- heartbeat / probe transport (datagrams on the simulated network) ------

    def _route_blackholed(self, route: List[int]) -> bool:
        """World physics, not detector knowledge: a datagram routed over a
        blackholed link or through a silent relay never arrives."""
        for a, b in zip(route, route[1:]):
            key = self._key(a, b)
            if key in self._link_faults:
                return True
            loss = self._link_loss.get(key)
            if loss is not None and loss[0] >= 1.0:
                return True
            if self._expired_loss.get(key, 0.0) >= 1.0:
                return True
        return any(self.node_faulted(r) for r in route[1:-1])

    def _heartbeat_routes(self, node: int, home: int) -> List[List[int]]:
        """Up to two node-disjoint routes from node to home (disjoint in
        relays — the alternate avoids every intermediate node of the
        primary, and the primary's direct link when there are none). Tiny
        heartbeats are cheap enough to send redundantly (gossip-style), so
        one silent relay on the primary route doesn't make a healthy node
        look dead — only a node whose *every* disjoint path is bad goes
        silent, which is the correct suspicion.

        Empty when the node is partitioned from home — cached like any
        other answer, so unreachable senders cost nothing per sweep until
        the topology version changes."""
        cached = self._route_cache.get(node)
        if cached is not None and cached[0] == self.topo.version:
            return cached[1]
        routes: List[List[int]] = []
        try:
            primary = ([node, home] if self.topo.has_link(node, home)
                       else self.topo.shortest_path(node, home,
                                                    HEARTBEAT_BYTES))
        except (graph.NoPath, graph.NodeNotFound):
            primary = None  # partitioned from home
        if primary is not None:
            routes.append(primary)
            relays = primary[1:-1]
            sub = graph.restricted_view(self.topo.g, relays,
                                        [] if relays else [(node, home)])
            try:
                routes.append(graph.shortest_path(
                    sub, node, home,
                    weight=lambda a, b, d:
                    d["link"].transfer_time(HEARTBEAT_BYTES)))
            except (graph.NoPath, graph.NodeNotFound):
                pass  # no disjoint alternate: single-homed toward home
        self._route_cache[node] = (self.topo.version, routes)
        return routes

    def _send_heartbeat(self, node: int):
        """The node's agent sends its heartbeat datagram toward home over
        the overlay (redundantly, on first-hop-disjoint routes). Congestion
        delays it (bounded control-queue model), partial loss slows it via
        the goodput factor, and blackholes or partitions swallow it — the
        detector only ever sees the first arrival of a beat, or nothing."""
        home = self._home()
        if home is None:
            return
        if node == home:
            if not self.scheduler_silent:
                self.heartbeat(node)
            return
        routes = self._heartbeat_routes(node, home)
        if not routes:
            return  # partitioned from home: the beat is lost
        seq = self._hb_seq.get(node, 0) + 1
        self._hb_seq[node] = seq
        for route in routes:
            if self._route_blackholed(route):
                continue
            self.control_datagrams += 1
            self.net.transfer(route, HEARTBEAT_BYTES,
                              lambda t, n=node, s=seq:
                              self._heartbeat_arrival(n, s),
                              daemon=True, contend=False)

    def _heartbeat_arrival(self, node: int, seq: int):
        """First copy of a beat counts; duplicates and late stragglers from
        older beats are dropped so redundant routes don't pollute the
        inter-arrival history with near-zero samples."""
        if self.scheduler_silent:
            return  # the datagram reached a dead home: nobody processes it
        if self._hb_delivered.get(node, 0) >= seq:
            return
        self._hb_delivered[node] = seq
        self.heartbeat(node)

    def _link_rng(self, key: Tuple[int, int]) -> random.Random:
        """Per-link seeded loss stream: one link's draws never depend on
        probe activity (or churn) anywhere else in the overlay."""
        rng = self._link_rngs.get(key)
        if rng is None:
            rng = random.Random(f"{self._sweep_seed}|{key[0]}|{key[1]}")
            self._link_rngs[key] = rng
        return rng

    def _launch_probe(self, u: int, v: int):
        """Send a probe datagram over (u, v); judge it at the deadline.

        The probe rides the simulated network: a congested link delays it
        (possibly past the timeout), a lossy link drops it with probability
        ``loss_rate``, a blackholed link swallows it. Success is purely
        "did the transfer complete in time"."""
        key = self._key(u, v)
        if (self.piggyback
                and self._fresh_link_obs.get(key, -1.0)
                >= self._last_probe_sweep_t):
            # A bulk transfer finished on this link since the last sweep:
            # the link demonstrably carries bytes, which is a stronger
            # observation than a 256-byte probe — count the success and
            # skip the redundant datagram (and its loss-RNG draw).
            self.piggybacked_probes += 1
            self.probe_link(u, v, ok=True)
            return
        epoch = self._probe_epoch.get(key, 0)
        gen = self._sweep_gen
        deadline = self.sim.now + self.probe_timeout
        delivered: Dict[str, float] = {}
        dropped = key in self._link_faults
        if not dropped:
            loss = self._link_loss.get(key)
            rate = (loss[0] if loss is not None
                    else self._expired_loss.get(key))
            if rate is not None:
                dropped = (rate >= 1.0
                           or self._link_rng(key).random() < rate)
        self.control_datagrams += 1
        if not dropped:
            self.net.transfer([u, v], PROBE_BYTES,
                              lambda t: delivered.setdefault("t", t),
                              daemon=True, contend=False)

        def judge():
            if not self.sweeps_on or gen != self._sweep_gen:
                return
            if self._probe_epoch.get(key, 0) != epoch:
                return  # link churned (re-joined / removed) since launch
            if not self.topo.has_link(u, v):
                return
            ok = "t" in delivered and delivered["t"] <= deadline + 1e-12
            self.probe_link(u, v, ok=ok)

        self.sim.at(deadline, judge, daemon=True)

    # -- heartbeats ------------------------------------------------------------

    def heartbeat(self, node_id: int):
        """A heartbeat from ``node_id`` arrived now: refresh the last-seen
        time and feed the inter-arrival history behind the phi score."""
        if self.scheduler_silent:
            return  # home's monitor process is dead: beats land on nobody
        now = self.sim.now
        st = self._hb_stats.get(node_id)
        if st is None:
            self._prime_node(node_id)
        else:
            st.observe(now)
            self.last_heartbeat[node_id] = now
        if self.on_heartbeat_from is not None:
            self.on_heartbeat_from(node_id)  # control plane acks the beat

    def suspicion(self, node_id: int, now: Optional[float] = None) -> float:
        """Current phi suspicion for the node (0 when unknown).

        The expected inter-arrival is the max of the observed window mean
        and the monitor's own current send interval — the monitor slowed
        the senders down when it backed off, so a longer gap is expected,
        not suspicious, until the history catches up."""
        st = self._hb_stats.get(node_id)
        if st is None:
            return 0.0
        now = self.sim.now if now is None else now
        mean, std = st.mean_std()
        mean = max(mean, self._hb_interval)
        std = max(std, PHI_MIN_STD_FRACTION * self.heartbeat_period, 1e-6)
        return phi_score(now - st.last, mean, std)

    def metrics_snapshot(self, now: Optional[float] = None) -> Dict:
        """Point-in-time read of the detector's observables for telemetry
        scrapes: per-node phi suspicion, current (adaptively scaled) sweep
        periods, piggyback savings, and pending-fault table sizes. Pure
        read — shares :meth:`suspicion`'s code path and touches nothing."""
        now = self.sim.now if now is None else float(now)
        return {
            "control_datagrams": self.control_datagrams,
            "piggybacked_probes": self.piggybacked_probes,
            "piggybacked_heartbeats": self.piggybacked_heartbeats,
            "heartbeat_period_s": self._hb_interval,
            "probe_period_s": self.probe_period * self._probe_scale,
            "phi_threshold": self.phi_threshold,
            "sweeps_on": self.sweeps_on,
            "suspicion": {n: self.suspicion(n, now=now)
                          for n in sorted(self._hb_stats)},
            "pending_faults": {
                "node": len(self._node_faults),
                "link": len(self._link_faults),
                "loss": len(self._link_loss),
            },
        }

    def check_heartbeats(self) -> List[int]:
        """Returns nodes the detector now declares dead; triggers callbacks.

        ``detector="phi"``: suspicion ``>= phi_threshold``;
        ``detector="fixed"``: last arrival older than ``heartbeat_timeout``.

        Each declared node is reported exactly once: its heartbeat-table
        entry (and arrival history) is dropped on detection, and stale
        entries of nodes in any non-live state are garbage-collected — a
        node parked outside active/standby can neither beat nor be
        detected, so keeping its entry would leak it forever."""
        if self.scheduler_silent:
            return []  # a dead monitor declares nothing
        dead = []
        # pop (not del): a detection callback earlier in this very loop can
        # remove other nodes from the table (e.g. aborting an in-flight join
        # whose only source died), invalidating the snapshot being iterated.
        for n, t in sorted(self.last_heartbeat.items()):
            info = self.topo.nodes.get(n)
            if info is None or info.state not in ("active", "standby"):
                self._drop_node_tracking(n)
                continue
            if self.detector == "phi":
                s = self.suspicion(n)
                lapsed = s >= self.phi_threshold
            else:
                s = None
                lapsed = self.sim.now - t > self.heartbeat_timeout
            if lapsed:
                self.last_suspicion = s
                dead.append(n)
                self._drop_node_tracking(n)
                self._silenced.add(n)
                fault_t = self._node_faults.pop(n, None)
                self._giveup.pop(("node", (n,)), None)
                self.record("node-failure", n, "heartbeat suspicion")
                if self.on_node_detected is not None:
                    self.on_node_detected(n, fault_t, self.sim.now)
                elif self.on_node_failure:
                    self.on_node_failure(n)
        return dead

    # -- link probes -------------------------------------------------------------

    def probe_link(self, u: int, v: int, ok: bool = True):
        if self.scheduler_silent:
            return False  # judgments belong to the (dead) monitor process
        key = self._key(u, v)
        if ok:
            self._probe_failures.pop(key, None)
            return False
        c = self._probe_failures.get(key, 0) + 1
        self._probe_failures[key] = c
        if c >= PROBE_FAILURES_FOR_LINK_DOWN:
            self._probe_failures.pop(key, None)
            self.net.clear_link_loss(*key)
            fault_t = self._link_faults.pop(key, None)
            self._giveup.pop(("link", key), None)
            loss = self._link_loss.pop(key, None)
            self._expired_loss.pop(key, None)
            self._giveup.pop(("loss", key), None)
            if fault_t is None and loss is not None:
                fault_t = loss[1]
            self.record("link-failure", key)
            if self.on_link_detected is not None:
                self.on_link_detected(key[0], key[1], fault_t, self.sim.now)
            elif self.on_link_failure:
                self.on_link_failure(u, v)
            return True
        return False

    # -- resource measurement ------------------------------------------------------

    def measure_links(self, node: int, peers: List[int]) -> Tuple[Dict[int, Tuple[float, float]], float]:
        """iperf-style measurement of (prop_s, trans_s_per_byte) to each peer.

        Returns (measurements, wall_seconds). Probes run in parallel across
        peers (each occupies its own link), so wall time ≈ one probe.
        Chaos measures only on scale-out / connect-link (§IV-A).

        With ``measurement_traffic`` on (detected mode), each measurement
        saturates its link for ``MEASURE_SECONDS`` — an iperf burst riding
        the real network, contending with whatever else is on the wire —
        instead of charging wall time without occupying anything.
        """
        out = {}
        for p in peers:
            l = self.topo.link(node, p)
            out[p] = (l.latency_s, l.trans_delay_per_byte)
            if self.measurement_traffic:
                burst = l.bytes_per_s * MEASURE_SECONDS
                self.net.transfer([node, p], burst, lambda t: None,
                                  daemon=True)
        return out, MEASURE_SECONDS
