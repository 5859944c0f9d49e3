"""Decentralized control plane: replicated scheduler state + peer election,
copied from ``repro/core/control.py``; the election's round trips run over
the stdlib graph's ``subgraph_view`` and
``single_source_dijkstra_path_length``.

The paper's setting is *self-governed* multi-party training (§I): there is
no cloud control plane to restart a dead coordinator, so the scheduler
itself must survive the same churn as the data plane. Everywhere else in
this repo the scheduler is a single point of failure — the monitor's
heartbeats all route to ``monitor.home`` and a silent home simply stops
detecting anything, including its own death. This module closes that gap:

* **Deputy replication** — the scheduler continuously replicates its
  control state (a :class:`SchedulerSnapshot`: topology/sync-policy
  versions, live membership, the in-flight scale-out ledger, the
  pending-fault table) to ``k`` *deputy* nodes via small sync datagrams
  riding the simulated :class:`~repro_torch.core.simulator.Network` — the same
  daemon, non-contending substrate heartbeats and probes use, so
  congestion delays deputy syncs organically without them ever occupying
  a data link.
* **Ack-watch self-silence detection** — detection is *inverted*: the
  scheduler acks every heartbeat it processes with a small ack datagram
  back to the sender, and each deputy keeps a phi-accrual suspicion score
  over its ack inter-arrival history (the exact estimator the monitor
  runs over heartbeats, pointed the other way). A scheduler that goes
  silently bad stops acking; the deputies' suspicion crosses
  ``PHI_THRESHOLD`` and an election starts. No deputy ever peeks at the
  fault tables — silence is inferred purely from missing acks.
* **Term-numbered quorum election** — candidates (live deputies, ranked
  by replica freshness then node id; a trace-supplied ``new_home``
  preference ranks first) each consume one term attempting to gather
  votes from the live nodes reachable over working control links. A
  candidate wins when its reachable set meets the majority quorum of its
  *replicated* membership view. Election messages pay real control RTTs,
  so ``election_s`` is a measured cost, not a constant. Under a
  partition, at most one side can hold the quorum: exactly one leader is
  elected there and the minority side stays leaderless (frozen — no
  split-brain scale-outs), retrying only if the overlay changes.
* **Fail-over install** — the winner becomes ``monitor.home`` (heartbeat
  route caches are invalidated, sweeps restart under a fresh generation),
  the scheduler's identity moves (``ChaosScheduler.handover``), and the
  new leader *re-adopts* the in-flight scale-outs recorded in its
  replica — streams keep flowing, delivered bytes stay credited exactly
  as ``replan_scale_out`` credits them — while scale-outs that began
  after its last sync are rebuilt via a credit-aware re-plan.

Determinism: elections use no randomness — suspicion, reachability,
ranking, and RTTs are all pure functions of the virtual clock and the
topology — so same-seed runs with fail-over enabled stay byte-identical,
and none of this machinery is constructed into the event flow until the
first fault event starts the sweeps (omniscient traces replay untouched).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

from repro_torch.core import graph
from repro_torch.core.monitor import (
    ACK_BYTES,
    PHI_MIN_STD_FRACTION,
    PHI_THRESHOLD,
    ClusterMonitor,
    _ArrivalStats,
    phi_score,
)
from repro_torch.core import codec as wire_codec
from repro_torch.core.simulator import Network, Sim
from repro_torch.core.topology import Topology

#: deputies holding a replica of the scheduler state (the paper's 6–12-node
#: overlays make 2 a sensible default: one deputy can die with the leader).
K_DEPUTIES = 2
#: scheduler-state sync datagram (versions + inflight ledger + fault table,
#: JSON-ish — still a control packet, not a data transfer).
SYNC_BYTES = 512.0
#: per-term election processing overhead on top of the vote-round RTTs.
ELECTION_TERM_S = 2e-3
#: give-up window for the whole fail-over, in worst-case (fully backed-off)
#: heartbeat sweep periods: if no candidate assembles a quorum by then the
#: cluster is declared frozen (minority side of a partition).
ELECTION_GIVEUP_SWEEPS = 12


@dataclass(frozen=True)
class InflightEntry:
    """Replicated ledger entry for one in-flight scale-out — what a deputy
    needs to re-adopt the replication without re-asking the (dead) leader:
    identity, trace position, and the delivered-byte watermark at sync."""
    seq: int
    new_node: int
    state_bytes: int
    replans: int
    delivered_bytes: int
    credited_bytes: int


@dataclass(frozen=True)
class SchedulerSnapshot:
    """One replicated scheduler-state generation (version = sync counter)."""
    version: int
    taken_t: float
    topo_version: int
    sync_policy_version: int
    membership: Tuple[int, ...]
    inflight: Tuple[InflightEntry, ...]
    pending_faults: Tuple[Tuple, ...]

    def inflight_nodes(self) -> Set[int]:
        return {e.new_node for e in self.inflight}


@dataclass
class DeputyReplica:
    """A deputy's view of the leader: last synced snapshot + ack history."""
    node: int
    snapshot: SchedulerSnapshot
    synced_t: float
    acks: _ArrivalStats = None  # primed by the control plane

    def observe_sync(self, snap: SchedulerSnapshot, t: float):
        if snap.version > self.snapshot.version:
            self.snapshot = snap
            self.synced_t = t


@dataclass
class FailoverResult:
    """What one completed peer election did, for the ledger and benchmarks.
    All fields are virtual-time/deterministic (ledger-safe)."""
    term: int
    old_home: int
    new_home: int
    fault_t: float
    detected_t: float
    election_s: float
    install_t: float
    suspicion: float
    terms_tried: int
    replicated_inflight: Set[int] = field(default_factory=set)
    replica_version: int = 0

    @property
    def detection_s(self) -> float:
        return self.detected_t - self.fault_t

    @property
    def failover_s(self) -> float:
        """Fault → new leader installed (detection + election)."""
        return self.install_t - self.fault_t


class ControlPlane:
    """Replicates scheduler state to deputies and elects a successor when
    the scheduler goes silently bad. One instance per ``SimBackend``; inert
    (no datagrams, no daemons) until :meth:`start`."""

    def __init__(self, sim: Sim, net: Network, topo: Topology,
                 monitor: ClusterMonitor, scheduler, *,
                 k_deputies: int = K_DEPUTIES,
                 phi_threshold: float = PHI_THRESHOLD):
        self.sim = sim
        self.net = net
        self.topo = topo
        self.monitor = monitor
        self.scheduler = scheduler
        self.k_deputies = int(k_deputies)
        self.phi_threshold = float(phi_threshold)
        self.replicas: Dict[int, DeputyReplica] = {}
        self.term = 0
        self.started = False
        #: the scheduler is silently dead and no successor is installed yet.
        self.leaderless = False
        #: election gave up (no quorum anywhere): the cluster stays frozen
        #: until the overlay changes — give-up is terminal for the drain.
        self.frozen = False
        self.fault_node: Optional[int] = None
        self.fault_t: Optional[float] = None
        self.preferred_home: Optional[int] = None  # trace-supplied successor
        self.on_failover: Optional[Callable[[FailoverResult], None]] = None
        #: engine-side provider of the live in-flight scale-outs:
        #: ``() -> [(seq, InflightScaleOut)]``.
        self.inflight_provider: Callable[[], List[Tuple[int, object]]] = (
            lambda: [])
        self.sync_datagrams = 0
        self.ack_datagrams = 0
        #: cumulative wire bytes of deputy sync payloads (codec-compressed
        #: when the scheduler runs a non-``none`` codec policy; acks stay
        #: raw — too small for framing to pay off).
        self.sync_wire_bytes = 0.0
        self._ack_seq: Dict[int, int] = {}  # per-deputy ack sequence sent
        self._ack_delivered: Dict[int, int] = {}  # highest sequence received
        #: terms consumed since the current scheduler fault was injected —
        #: what a terminal election-no-quorum record reports (the global
        #: ``term`` counter spans the whole run).
        self.terms_this_fault = 0
        self.failovers: List[FailoverResult] = []
        self._seed = 0
        self._gen = 0
        self._version = 0
        self._detected_t: Optional[float] = None
        self._giveup_deadline: Optional[float] = None
        self._pending_install: Optional[Tuple] = None
        #: topology version at the last quorum-less election round — retry
        #: only when the overlay changed (bounded terms, no spin).
        self._no_quorum_version: Optional[int] = None

    def metrics_snapshot(self) -> Dict:
        """Point-in-time counter read for telemetry scrapes. Pure read."""
        return {
            "term": self.term,
            "terms_this_fault": self.terms_this_fault,
            "sync_wire_bytes": self.sync_wire_bytes,
            "sync_datagrams": self.sync_datagrams,
            "ack_datagrams": self.ack_datagrams,
            "replicas": len(self.replicas),
            "leaderless": self.leaderless,
            "frozen": self.frozen,
        }

    # -- lifecycle -------------------------------------------------------------

    def start(self, *, seed: int = 0):
        """Appoint deputies and start the sync + ack-watch daemon chains.
        Idempotent while running (mirrors ``ClusterMonitor.start_sweeps``)."""
        if self.started:
            return
        self.started = True
        self._seed = int(seed)
        self._gen += 1
        gen = self._gen
        self.monitor.on_heartbeat_from = self._heartbeat_processed
        self._refresh_deputies()
        period = self.monitor.heartbeat_period
        self.sim.at(self.sim.now + period,
                    lambda: self._sync_sweep(gen), daemon=True)
        self.sim.at(self.sim.now + period,
                    lambda: self._deputy_sweep(gen), daemon=True)

    def stop(self):
        self.started = False
        self._gen += 1
        self.monitor.on_heartbeat_from = None

    # -- scheduler-state snapshots ---------------------------------------------

    def snapshot(self) -> SchedulerSnapshot:
        """Assemble the current scheduler state for replication."""
        self._version += 1
        sched_state = self.scheduler.control_state()
        entries = tuple(sorted(
            (InflightEntry(seq, fl.new_node, int(fl.state_bytes),
                           fl.replans, fl.delivered_bytes(),
                           fl.credited_bytes())
             for seq, fl in self.inflight_provider()),
            key=lambda e: e.new_node))
        return SchedulerSnapshot(
            version=self._version, taken_t=self.sim.now,
            topo_version=sched_state["topo_version"],
            sync_policy_version=sched_state["sync_policy_version"],
            membership=sched_state["membership"],
            inflight=entries,
            pending_faults=sched_state["pending_faults"])

    def _pick_deputies(self) -> List[int]:
        home = self.monitor._home()
        live = [n for n in self.monitor._live_nodes()
                if n != home and not self.monitor.node_faulted(n)]
        return live[:self.k_deputies]

    def _prime_acks(self, node: int) -> _ArrivalStats:
        """Fresh ack clock for a deputy: one synthetic inter-arrival at the
        heartbeat period (phi defined before real samples), and the
        delivered watermark jumps past every copy already in flight so
        stragglers from a previous epoch can't feed the new history."""
        acks = _ArrivalStats(self.sim.now)
        acks.window.append(self.monitor.heartbeat_period)
        self._ack_delivered[node] = self._ack_seq.get(node, 0)
        return acks

    def _refresh_deputies(self, snap: Optional[SchedulerSnapshot] = None,
                          reprime: bool = False):
        """(Re)appoint deputies deterministically; the appointment message
        carries an initial state copy, so a replica is never empty.

        ``reprime`` (used at fail-over install) restarts every surviving
        deputy's ack clock: its silence evidence indicted the *dead*
        leader — carrying it over would make the freshly installed one
        look instantly suspicious and trigger a phantom election."""
        now = self.sim.now
        current = set(self._pick_deputies())
        for node in [n for n in self.replicas if n not in current]:
            del self.replicas[node]
        new = [n for n in sorted(current) if n not in self.replicas]
        if new and snap is None:
            snap = self.snapshot()
        for node in new:
            self.replicas[node] = DeputyReplica(node, snap, now,
                                                self._prime_acks(node))
        if reprime:
            for node in sorted(self.replicas):
                if node not in new:
                    self.replicas[node].acks = self._prime_acks(node)

    # -- leader side: sync + acks ----------------------------------------------

    def _control_routes(self, node: int) -> List[List[int]]:
        """Up to two relay-disjoint leader→deputy routes: the reverse of
        the deputy's own heartbeat routes (links are undirected, and the
        rationale is identical — one silently blackholed edge or relay
        must not starve a deputy of acks and have it depose a healthy
        leader). Blackholed copies are swallowed by world physics."""
        home = self.monitor._home()
        if home is None or home == node:
            return []
        return [list(reversed(r))
                for r in self.monitor._heartbeat_routes(node, home)]

    def _send_control(self, node: int, nbytes: float,
                      on_done: Callable[[float], None]) -> int:
        """Send one control payload to ``node`` redundantly over the
        disjoint routes; returns the number of copies put on the wire.
        The receiver dedups (ack sequence watermark / snapshot version)."""
        sent = 0
        for route in self._control_routes(node):
            if self.monitor._route_blackholed(route):
                continue
            self.monitor.control_datagrams += 1
            self.net.transfer(route, nbytes, on_done,
                              daemon=True, contend=False)
            sent += 1
        return sent

    def _sync_payload_bytes(self) -> float:
        """Wire bytes of one deputy sync datagram. Under a non-``none``
        scheduler codec policy the snapshot ships int8-encoded (control
        state has no top-k structure — quantization only); under ``none``
        this is exactly ``SYNC_BYTES``, keeping ledgers byte-identical."""
        policy = getattr(self.scheduler, "codec", wire_codec.CODEC_NONE)
        if policy == wire_codec.CODEC_NONE:
            return SYNC_BYTES
        return float(wire_codec.wire_bytes(wire_codec.CODEC_INT8, SYNC_BYTES))

    def _sync_sweep(self, gen: int):
        if not self.started or gen != self._gen:
            return
        if not self.monitor.scheduler_silent:
            # A dead leader replicates nothing; the chain keeps ticking so
            # sync resumes under the next leader.
            snap = self.snapshot()
            self._refresh_deputies(snap=snap)
            payload = self._sync_payload_bytes()
            for node, replica in sorted(self.replicas.items()):
                sent = self._send_control(
                    node, payload,
                    lambda t, r=replica, s=snap: r.observe_sync(s, t))
                self.sync_datagrams += sent
                self.sync_wire_bytes += sent * payload
        self.sim.at(self.sim.now + self.monitor.heartbeat_period,
                    lambda: self._sync_sweep(gen), daemon=True)

    def _heartbeat_processed(self, node: int):
        """The leader processed a heartbeat: ack it back to the sender if
        the sender is a deputy (deputies are the only peers acting on ack
        silence, so acking everyone would be pure overhead)."""
        replica = self.replicas.get(node)
        if replica is None or self.monitor.scheduler_silent:
            return
        seq = self._ack_seq.get(node, 0) + 1
        self._ack_seq[node] = seq
        self.ack_datagrams += self._send_control(
            node, ACK_BYTES,
            lambda t, r=replica, n=node, s=seq: self._ack_arrival(r, n, s, t))

    def _ack_arrival(self, replica: DeputyReplica, node: int, seq: int,
                     t: float):
        """First copy of an ack counts; duplicates from the redundant
        route and stragglers from a previous leader epoch are dropped so
        they never pollute the inter-arrival history (the same dedup rule
        heartbeats apply)."""
        if self._ack_delivered.get(node, 0) >= seq:
            return
        if self.replicas.get(node) is not replica:
            return  # deputy re-appointed since this copy launched
        self._ack_delivered[node] = seq
        replica.acks.observe(t)

    # -- deputy side: ack suspicion + election ---------------------------------

    def ack_suspicion(self, node: int, now: Optional[float] = None) -> float:
        """Phi-accrual suspicion of the *leader*, from this deputy's ack
        inter-arrival history. The expectation floors at the monitor's
        current heartbeat send interval — acks ride the heartbeat cadence,
        so a backed-off sweep schedule widens the tolerance exactly as it
        does for node suspicion (the leader broadcasts its sweep schedule
        with each sync, so deputies legitimately know it)."""
        replica = self.replicas.get(node)
        if replica is None:
            return 0.0
        now = self.sim.now if now is None else now
        mean, std = replica.acks.mean_std()
        mean = max(mean, self.monitor._hb_interval)
        std = max(std, PHI_MIN_STD_FRACTION * self.monitor.heartbeat_period,
                  1e-6)
        return phi_score(now - replica.acks.last, mean, std)

    def _deputy_sweep(self, gen: int):
        if not self.started or gen != self._gen:
            return
        now = self.sim.now
        if self._pending_install is None and not self.frozen:
            live = set(self.monitor._live_nodes())
            suspects = [n for n in sorted(self.replicas)
                        if n in live and not self.monitor.node_faulted(n)
                        and self.ack_suspicion(n, now) >= self.phi_threshold]
            if suspects:
                self._run_election(suspects, now)
        self.sim.at(now + self.monitor.heartbeat_period,
                    lambda: self._deputy_sweep(gen), daemon=True)

    def _reachable_live(self, start: int) -> Set[int]:
        """Live, non-silent nodes reachable from ``start`` over working
        control links — the voters an election round can actually gather."""
        mon = self.monitor
        live = {n for n in mon._live_nodes() if not mon.node_faulted(n)}
        if start not in live:
            return set()
        bad_links = set(mon.faulted_links())
        seen, stack = {start}, [start]
        while stack:
            x = stack.pop()
            for y in self.topo.g.neighbors(x):
                key = (min(x, y), max(x, y))
                if y in live and y not in seen and key not in bad_links:
                    seen.add(y)
                    stack.append(y)
        return seen

    def _vote_round_s(self, cand: int, voters: Set[int]) -> float:
        """Wall cost of one request-vote + announce exchange: two RTTs to
        the farthest voter over the live overlay (latency-weighted)."""
        mon = self.monitor
        live = {n for n in mon._live_nodes() if not mon.node_faulted(n)}
        bad = set(mon.faulted_links())
        sub = graph.subgraph_view(
            self.topo.g,
            filter_node=lambda n: n in live,
            filter_edge=lambda a, b: (min(a, b), max(a, b)) not in bad)
        dist = graph.single_source_dijkstra_path_length(
            sub, cand, weight=lambda a, b, d: d["link"].latency_s)
        worst = max((dist.get(v, 0.0) for v in voters), default=0.0)
        return 2 * (2 * worst)  # two rounds, each an RTT

    def _ranked_candidates(self, suspects: List[int]) -> List[int]:
        """Candidates ranked by who should lead: the trace-preferred
        successor first (when it is a live deputy), then freshest replica,
        then lowest node id — all deterministic.

        Only deputies that *themselves* suspect the leader may stand: a
        deputy still receiving acks would refuse to depose a leader it can
        hear (the Raft vote-denial rule), so a partitioned deputy's
        suspicion can never enlist a healthy-side deputy to seize power."""
        live = set(self.monitor._live_nodes())
        cands = [n for n in suspects
                 if n in self.replicas and n in live
                 and not self.monitor.node_faulted(n)]

        def rank(n: int):
            preferred = (0 if (self.preferred_home is not None
                               and n == self.preferred_home) else 1)
            return (preferred, -self.replicas[n].snapshot.version, n)

        return sorted(cands, key=rank)

    def _run_election(self, suspects: List[int], now: float):
        """One election: candidates consume terms until one holds a quorum.
        With no quorum anywhere (minority partition side) the attempt is
        remembered against the topology version — no retry, hence bounded
        terms, until the overlay changes."""
        if self._no_quorum_version == self.topo.version:
            return  # already failed on this exact overlay: stay frozen-ish
        if self._detected_t is None:
            self._detected_t = now
        suspicion = max(self.ack_suspicion(n, now) for n in suspects)
        elapsed = 0.0
        terms_tried = 0
        winner = None
        episode = self.leaderless  # terms count toward the current fault
        for cand in self._ranked_candidates(suspects):
            self.term += 1
            terms_tried += 1
            membership = self.replicas[cand].snapshot.membership
            quorum = len(membership) // 2 + 1
            # Only replicated *members* hold votes: reachable standby
            # joiners are not yet part of the membership the quorum is a
            # majority of, so counting them could hand a minority
            # partition side an election it must not win.
            voters = self._reachable_live(cand) & set(membership)
            elapsed += self._vote_round_s(cand, voters) + ELECTION_TERM_S
            if len(voters) >= quorum:
                winner = cand
                break
        if episode:
            self.terms_this_fault += terms_tried
        if winner is None:
            self._no_quorum_version = self.topo.version
            return
        replica = self.replicas[winner]
        result = FailoverResult(
            term=self.term,
            old_home=(self.fault_node if self.fault_node is not None
                      else self.monitor._home()),
            new_home=winner,
            fault_t=(self.fault_t if self.fault_t is not None
                     else self._detected_t),
            detected_t=self._detected_t,
            election_s=elapsed,
            install_t=now + elapsed,
            suspicion=round(suspicion, 4),
            terms_tried=terms_tried,
            replicated_inflight=replica.snapshot.inflight_nodes(),
            replica_version=replica.snapshot.version)
        self._pending_install = (winner, result)
        # Non-daemon: the install must complete even inside a bare
        # ``sim.run()`` drain — it is real work, not a periodic activity.
        self.sim.at(result.install_t, self._install)

    def _install(self):
        """The winner takes over: scheduler identity moves, heartbeat
        routes re-target the new home, sweeps restart fresh, deputies are
        re-appointed, and the engine is told to re-adopt in-flight work.
        Per-entry adopt-vs-rebuild goes through the recovery policy's
        re-adoption context (``repro_torch.core.recovery``), which ledgers the
        choice under an adaptive policy."""
        if self._pending_install is None:
            return
        winner, result = self._pending_install
        self._pending_install = None
        old = result.old_home
        self.leaderless = False
        self.frozen = False
        self.fault_node = None
        self.fault_t = None
        self._detected_t = None
        self._giveup_deadline = None
        self._no_quorum_version = None
        self.preferred_home = None
        self.failovers.append(result)
        self.scheduler.handover(winner)
        # The old home is still silently dead as a *node*: give the new
        # monitor's sweeps a full window to detect it the honest way.
        self.monitor.restore_node_giveup(old)
        self.monitor.stop_sweeps()
        self.monitor.start_sweeps(seed=self._seed,
                                  detector=self.monitor.detector)
        self._refresh_deputies(reprime=True)
        if self.on_failover is not None:
            self.on_failover(result)

    # -- scheduler-fault injection + drain contract ----------------------------

    def inject_scheduler_fault(self) -> int:
        """The scheduler node fails silently: its monitor process dies with
        it (no heartbeat processing, no probes, no detections) and the
        cluster is leaderless until the deputies elect. Returns the faulted
        home node id. The control plane owns the give-up clock while
        leaderless — the dead scheduler cannot detect itself."""
        mon = self.monitor
        home = mon._home()
        self.fault_node = home
        self.fault_t = self.sim.now
        self.leaderless = True
        self.frozen = False
        self._detected_t = None
        self._no_quorum_version = None
        self.terms_this_fault = 0
        mon.scheduler_silent = True
        mon.inject_node_fault(home)
        mon.defer_node_giveup(home)
        self._giveup_deadline = (
            self.sim.now + ELECTION_GIVEUP_SWEEPS
            * mon._max_period(mon.heartbeat_period))
        return home

    def detection_horizon(self) -> Optional[float]:
        """Give-up deadline for the in-progress fail-over, or None. The
        engine's drain folds this into the monitor's horizon so leaderless
        windows drain to a terminal record instead of hanging."""
        if self.leaderless and not self.frozen:
            return self._giveup_deadline
        return None

    def expire(self, now: float) -> Optional[dict]:
        """No quorum assembled anywhere by the deadline: the cluster
        freezes (minority partition side). Returns the terminal-record
        payload once, None otherwise. The old home stays physically dead
        (``_silenced``) but stops holding a give-up deadline — give-up is
        bookkeeping, not repair."""
        if (not self.leaderless or self.frozen
                or self._pending_install is not None
                or self._giveup_deadline is None
                or now < self._giveup_deadline - 1e-9):
            return None
        self.frozen = True
        self._giveup_deadline = None
        mon = self.monitor
        if self.fault_node is not None:
            mon._node_faults.pop(self.fault_node, None)
            mon._silenced.add(self.fault_node)
        payload = {"fault_t": self.fault_t,
                   "terms_tried": self.terms_this_fault,
                   "old_home": self.fault_node}
        if self._detected_t is not None:
            # When the ack-watch *did* fire before the give-up, the ledger
            # (and GoodPut accounting) can split the window into detection
            # (fault -> suspicion) and leaderless (failed elections).
            payload["detected_t"] = self._detected_t
        return payload
