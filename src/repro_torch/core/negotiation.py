"""Peer-negotiation protocols (paper §IV-B, Fig 4) + the SimCluster facade,
copied from ``repro/core/negotiation.py``.

The scheduler coordinates scale-out, scale-in, connect-link and
disconnect-link through control messages over the simulated network; state
replication transfers ride the same network with per-link FIFO contention.
Following §IV-C, negotiation/measurement overlap with all-reduce and state
replication overlaps with gradient computation — the *reported* delay of each
primitive is its non-hidden (blocking) portion, which is what the paper's
Table I / Fig 9 measure.

Scale-out is split into begin / replan / finish phases so the churn engine
(``engine.py``) can overlap events: ``begin_scale_out`` runs the §IV-B
negotiation + measurement + Algorithm 1–2 planning and schedules the shard
streams; ``replan_scale_out`` handles churn that lands mid-replication with
**partial-transfer credit** — every cancelled stream keeps the shard-aligned
byte prefix it already delivered (``TransferHandle.progress``), and only the
missing suffix is re-planned over the surviving topology; ``finish_scale_out``
installs state + sync policy once the streams drain. ``scheduler.partial_credit
= False`` restores the forfeit-everything pre-credit behavior for A/B
benchmarks.
"""
from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import codec as wire_codec
from repro_torch.core.monitor import ClusterMonitor, MEASURE_SECONDS
from repro_torch.core.plans import ReplicationPlan, build_plan, trim_tensor_sizes
from repro_torch.core.simulator import (
    CONTROL_MSG_BYTES,
    Network,
    Sim,
    TrainingSession,
    TransferHandle,
)
from repro_torch.core.topology import Link, Topology

POLICY_SWAP_S = 50e-6  # local pointer swap installing a new sync policy
SOCKET_SETUP_S = 120e-6  # local socket setup/teardown cost


@dataclass
class ScaleOutResult:
    delay_s: float  # join request → node ready to train (§VI-B)
    replication_s: float  # state transfer critical path
    solver_s: float  # Alg 1+2 wall time (measured, on the critical path)
    idle_s: Dict[int, float]  # per-node idle attributable to this event
    plan: ReplicationPlan
    timeline: Dict[str, float]
    replans: int = 0  # times churn invalidated the in-flight replication


@dataclass
class PrimitiveResult:
    delay_s: float  # blocking (non-overlapped) portion — Table I semantics
    wall_s: float  # full protocol wall time incl. hidden parts
    timeline: Dict[str, float]
    #: monitor detection latency (fault injection → sweep detection) when the
    #: primitive was triggered by the cluster monitor rather than an
    #: omniscient trace event; None for injected/graceful churn.
    detection_s: Optional[float] = None


@dataclass
class TransferRecord:
    """One source→new-node shard stream of an in-flight replication.

    ``nbytes`` is the payload the stream installs; ``wire_nbytes`` is what
    rides the network (== ``nbytes`` under the ``none`` codec). The handle's
    progress therefore meters **wire** bytes. ``credited`` is set when churn
    cancels the stream mid-flight: the payload bytes that had already landed
    on the new node, floored to a shard boundary (a resumable prefix —
    partial shards are re-sent); ``credited_wire`` is the matching wire-byte
    prefix (whole wire-shards, each of which decodes to one payload shard)."""
    source: int
    nbytes: int
    route: List[int]
    handle: TransferHandle
    gen: int  # 0 for the original plan, 1+ per re-plan
    credited: int = 0  # shard-floored payload bytes retained after cancellation
    codec: str = wire_codec.CODEC_NONE
    wire_nbytes: int = 0  # bytes on the wire (== nbytes when codec is none)
    payload_shard: int = 0  # this generation's shard granularity (payload)
    wire_shard: int = 0  # one encoded shard's framed size on the wire
    decode_s: float = 0.0  # decode charge before the payload installs
    credited_wire: int = 0  # wire-byte prefix kept after cancellation


@dataclass
class InflightScaleOut:
    """A scale-out whose state replication is still on the wire.

    The churn engine holds these between events: a leave / link-failure
    arriving mid-replication cancels the affected streams and re-plans the
    undelivered bytes from the surviving neighbors instead of crashing or
    serializing the events (§IV-C overlap, taken to its conclusion).
    Delivered-byte accounting is byte-granular: completed streams count in
    full, cancelled streams count their credited shard-aligned prefix."""
    new_node: int
    t0: float
    state_bytes: int
    tensor_sizes: List[int]
    neighbor_ids: List[int]
    plan: ReplicationPlan  # latest generation
    sync: Dict[int, float]
    solver_s: float
    t_transfers_start: float
    timeline: Dict[str, float]
    transfers: List[TransferRecord] = field(default_factory=list)
    replans: int = 0
    aborted: bool = False
    t_last_credit: float = 0.0  # virtual time of the latest credited prefix
    codec: str = wire_codec.CODEC_NONE  # codec policy this scale-out runs under

    def delivered_bytes(self) -> int:
        """Payload bytes already on the new node: completed streams + the
        credited prefixes of cancelled ones."""
        return (sum(r.nbytes for r in self.transfers if r.handle.done)
                + self.credited_bytes())

    def credited_bytes(self) -> int:
        """Payload bytes salvaged from cancelled partial streams (never
        forfeited back; monotone across re-plans)."""
        return sum(r.credited for r in self.transfers)

    def wire_delivered_bytes(self) -> int:
        """Wire bytes that reached the new node: completed streams in full
        plus the whole-wire-shard prefixes of cancelled ones."""
        return (sum(r.wire_nbytes for r in self.transfers if r.handle.done)
                + self.credited_wire_bytes())

    def credited_wire_bytes(self) -> int:
        return sum(r.credited_wire for r in self.transfers)

    def decode_critical_s(self) -> float:
        """Largest decode charge among completed streams — the codec's
        contribution to the install critical path (``finish_scale_out``
        waits on ``done_t + decode_s`` per stream), ledgered on ``ready``
        records as the "decode" BadPut category."""
        return max((r.decode_s for r in self.transfers if r.handle.done),
                   default=0.0)

    def pending(self) -> List[TransferRecord]:
        return [r for r in self.transfers
                if not r.handle.cancelled and not r.handle.done]

    @property
    def complete(self) -> bool:
        return not self.aborted and not self.pending()

    def uses_node(self, node: int) -> bool:
        return any(node == r.source or node in r.route for r in self.pending())

    def uses_link(self, u: int, v: int) -> bool:
        key = (min(u, v), max(u, v))
        for r in self.pending():
            for a, b in zip(r.route, r.route[1:]):
                if (min(a, b), max(a, b)) == key:
                    return True
        return False


class ChaosScheduler:
    """The scheduler: cluster monitor + peer negotiator + plan generator."""

    def __init__(self, sim: Sim, net: Network, topo: Topology,
                 session: TrainingSession, *, scheduler_node: int,
                 strategy: str = "chaos",
                 codec: str = wire_codec.CODEC_NONE):
        self.sim = sim
        self.net = net
        self.topo = topo
        self.session = session
        self.node = scheduler_node
        self.strategy = strategy
        #: codec policy for state-bearing transfers ("none" / "int8" /
        #: "int8+topk" / "auto" — per-link negotiation resolves the rest).
        #: "none" keeps every byte and every timestamp pre-codec identical.
        self.codec = wire_codec.validate_policy(codec)
        self.monitor = ClusterMonitor(sim, net, topo)
        self.monitor.home = scheduler_node  # heartbeats route to the scheduler
        self.monitor.on_node_failure = lambda n: self.scale_in(n, failure=True)
        self.monitor.on_link_failure = lambda u, v: self.disconnect_link(u, v, failure=True)
        self.sync_policy_version = 0
        # None ⇒ charge the *measured* Alg 1+2 wall time to the virtual clock
        # (paper Table I semantics). The churn engine sets a fixed charge so
        # same-seed replays produce byte-identical ledgers.
        self.solver_time_model: Optional[float] = None
        # Credit shard-aligned prefixes of cancelled streams instead of
        # forfeiting all in-flight bytes. False restores the pre-credit
        # replan-everything-undelivered behavior (benchmark baseline).
        self.partial_credit = True
        #: cumulative replication-stream accounting (scheduled transfers
        #: only — measurement bursts and control datagrams excluded), the
        #: codec A/B's numerator/denominator.
        self.replication_payload_bytes = 0
        self.replication_wire_bytes = 0

    # -- control-plane replication / fail-over (repro/core/control.py) --------

    def control_state(self) -> dict:
        """The scheduler state a deputy needs besides the in-flight ledger
        (which the engine backend contributes): versions, live membership
        (the election quorum denominator), and the pending-fault table —
        everything JSON-ish and deterministic."""
        mon = self.monitor
        return {
            "topo_version": self.topo.version,
            "sync_policy_version": self.sync_policy_version,
            "membership": tuple(sorted(self.topo.active_nodes())),
            "pending_faults": (
                tuple(("node", n) for n in sorted(mon._node_faults))
                + tuple(("link", k) for k in sorted(mon._link_faults))),
        }

    def handover(self, new_home: int):
        """A peer election promoted ``new_home``: the scheduler identity
        moves there, heartbeats re-route (cached routes invalidated), and
        the new leader regenerates the sync policy it now owns."""
        self.node = new_home
        self.monitor.rebase_home(new_home)
        self._update_sync_policy()

    def re_adopt_scale_out(self, fl: "InflightScaleOut",
                           *, adopt: bool) -> Optional[dict]:
        """The elected leader takes ownership of an in-flight replication
        after fail-over.

        ``adopt`` — the recovery policy's verdict (``repro_torch.core.recovery``,
        "re-adoption" context: it can only be True when the scale-out was
        in the winner's deputy replica): adopt it in place. Streams keep
        flowing (they never depended on the dead leader) and every
        delivered byte stays credited; only the finalization, which needs a
        live leader, was waiting. Otherwise the plan must be rebuilt —
        ``replan_scale_out`` re-plans the missing bytes, crediting the
        delivered prefix the joining node itself reports (§IV-C delta
        recovery — the bytes live on the joiner, not in the dead leader's
        memory).

        Returns the adoption accounting for the ledger, or None when the
        rebuild found no surviving neighbors and aborted."""
        # Finalization could not have happened during the leaderless
        # window: a replication that drained then is complete at install
        # time, not before (the ready record must postdate the election).
        fl.t_last_credit = max(fl.t_last_credit, self.sim.now)
        if not adopt and not self.replan_scale_out(fl):
            return None
        return {
            "re_adoption": "adopted" if adopt else "rebuilt",
            "delivered_bytes": fl.delivered_bytes(),
            "credited_bytes": fl.credited_bytes(),
            "replans": fl.replans,
        }

    # -- helpers ---------------------------------------------------------------

    def _control_rtt(self, u: int, v: int) -> float:
        if u == v:
            return 2e-6
        if self.topo.has_link(u, v):
            return 2 * self.topo.link(u, v).latency_s
        if not self.topo.has_path(u, v):
            # Partitioned overlay: no ack can arrive; the primitive proceeds
            # on heartbeat-timeout semantics (no control exchange charged).
            return 0.0
        path = self.topo.shortest_path(u, v, CONTROL_MSG_BYTES)
        prop, _ = self.topo.path_delay_per_byte(path)
        return 2 * prop

    def _update_sync_policy(self):
        """Model-synchronization policy regeneration (all-reduce schedule —
        e.g. NetStorm FAPT over the new overlay). Local swap cost only."""
        self.sync_policy_version += 1
        return POLICY_SWAP_S

    # -- scale-out (Fig 4a / Fig 5a) --------------------------------------------
    #
    # The protocol is split into begin / finish phases so the churn engine can
    # overlap it with later events: ``begin_scale_out`` runs negotiation,
    # measurement, planning and *schedules* the shard transfers, returning an
    # InflightScaleOut; ``finish_scale_out`` finalizes once the transfers have
    # drained. ``scale_out`` is the one-shot convenience wrapper (equivalent
    # to the pre-engine behavior).

    def scale_out(self, new_node: int, links: Dict[int, Link],
                  state_bytes: int, tensor_sizes: Sequence[int],
                  compute_s: float = 1.0) -> ScaleOutResult:
        fl = self.begin_scale_out(new_node, links, state_bytes, tensor_sizes,
                                  compute_s=compute_s)
        self.sim.run()  # drain the scheduled transfers
        return self.finish_scale_out(fl)

    def begin_scale_out(self, new_node: int, links: Dict[int, Link],
                        state_bytes: int, tensor_sizes: Sequence[int],
                        compute_s: float = 1.0,
                        codec: Optional[str] = None) -> InflightScaleOut:
        # Per-join codec override (trace events may carry one); None means
        # the scheduler's standing policy.
        policy = (self.codec if codec is None
                  else wire_codec.validate_policy(codec))
        t0 = self.sim.now
        timeline = {"request": t0}

        # 1. Join request reaches the scheduler (over the best of its links).
        self.monitor.register_join(new_node, links, compute_s=compute_s)
        req_delay = min(l.latency_s for l in links.values()) if links else 0.0
        t = t0 + req_delay

        # 2. Peer negotiation: scheduler instructs neighbors; sockets open.
        neighbor_ids = list(links)
        nego = max((self._control_rtt(self.node, u) for u in neighbor_ids),
                   default=0.0) + SOCKET_SETUP_S
        t_sockets = t + nego
        timeline["sockets_up"] = t_sockets

        # 3. Monitor measures links (parallel iperf probes) — overlaps with
        #    the in-flight all-reduce (§IV-C).
        meas, meas_wall = self.monitor.measure_links(new_node, neighbor_ids)
        t_measured = t_sockets + meas_wall
        timeline["measured"] = t_measured

        # 4. All-reduce boundary: replication starts after the current
        #    all-reduce completes for each neighbor (τ^sync skew).
        ar_done = {u: self.session.events.allreduce_done.get(u, t_measured)
                   for u in neighbor_ids}
        sync = {u: max(0.0, ar_done[u] - t_measured) + self.session.node_sync_skew(u)
                for u in neighbor_ids}

        # 5. Plan generation (Algorithm 1 + 2) — wall time measured for real
        #    (or a fixed deterministic charge under the churn engine).
        wall0 = _time.perf_counter()
        plan = build_plan(self.strategy, self.topo, new_node, state_bytes,
                          tensor_sizes, sync, codec=policy)
        wall = _time.perf_counter() - wall0
        solver_s = wall if self.solver_time_model is None else self.solver_time_model
        t_plan = t_measured + solver_s
        timeline["plan_ready"] = t_plan

        # 6. Policies distributed; shard transfers ride the data network.
        policy_dist = max((self._control_rtt(self.node, u) / 2
                           for u in list(plan.sources) + [new_node]), default=0.0)
        t_transfers_start = t_plan + policy_dist

        fl = InflightScaleOut(new_node, t0, int(state_bytes),
                              list(tensor_sizes), neighbor_ids, plan, sync,
                              solver_s, t_transfers_start, timeline,
                              codec=policy)
        self._schedule_transfers(fl, plan, t_transfers_start, sync, gen=0)
        return fl

    def _schedule_transfers(self, fl: InflightScaleOut, plan: ReplicationPlan,
                            t_start: float, sync: Dict[int, float], gen: int):
        """Schedule one stream per plan source. What rides the network is the
        **wire** byte count (payload + per-shard scale framing); the source's
        encode charge delays the first byte and the joining node's decode
        charge lands after delivery (``finish_scale_out``). Under the
        ``none`` codec wire == payload and both charges are exactly 0.0, so
        every scheduled timestamp is bit-identical to the pre-codec path."""
        for u, nbytes in plan.sources.items():
            route = plan.routes[u]
            cname = plan.codec_for(u)
            wire = plan.wire_for(u)
            self.replication_payload_bytes += int(nbytes)
            self.replication_wire_bytes += int(wire)
            handle = TransferHandle()
            fl.transfers.append(TransferRecord(
                u, int(nbytes), route, handle, gen,
                codec=cname, wire_nbytes=int(wire),
                payload_shard=int(plan.shard_size),
                wire_shard=plan.wire_shard_for(u),
                decode_s=wire_codec.decode_s(cname, nbytes)))
            start = (t_start + sync.get(u, 0.0)
                     + wire_codec.encode_s(cname, nbytes))

            def launch(route=route, wire=wire, handle=handle):
                # Invalidated (or silently stalled) before the bytes moved.
                if handle.cancelled or handle.stalled:
                    return
                self.net.transfer(route, wire, lambda t: None, handle=handle)

            self.sim.at(start, launch)

    def finish_scale_out(self, fl: InflightScaleOut) -> ScaleOutResult:
        """Finalize a drained replication: install state + policy, activate.
        Each stream's payload is usable only after its decode charge (0.0
        under the ``none`` codec)."""
        done_ts = [r.handle.done_t + r.decode_s
                   for r in fl.transfers if r.handle.done]
        t_state_done = max(done_ts, default=fl.t_transfers_start)
        # A replication finished by credited prefixes (remaining hit zero at
        # cancellation) is complete at the credit instant, not earlier.
        t_state_done = max(t_state_done, fl.t_last_credit)
        fl.timeline["state_replicated"] = t_state_done

        # 7. New node installs state + policy, joins the next iteration.
        t_ready = t_state_done + self._update_sync_policy()
        fl.timeline["ready"] = t_ready
        self.monitor.activate(fl.new_node)

        delay = t_ready - fl.t0
        idle = self._idle_for_scaleout(fl.plan, fl.t0, t_ready, fl.neighbor_ids)
        return ScaleOutResult(delay, t_state_done - fl.t_transfers_start,
                              fl.solver_s, idle, fl.plan, fl.timeline,
                              replans=fl.replans)

    def replan_scale_out(self, fl: InflightScaleOut) -> bool:
        """Churn invalidated part of an in-flight replication: cancel the
        affected streams, credit the shard-aligned prefix each stream had
        already delivered, and re-plan only the genuinely missing bytes over
        the current topology. Returns False (and aborts) when the joining
        node has no surviving neighbors to pull from.

        Credit granularity follows the plan: ``plan.shard_size > 0`` floors
        each cancelled stream's delivered bytes to a whole-shard boundary
        (partial shards are re-sent — they can't be verified/installed);
        ``shard_size == 0`` (single-/multi-source baselines) credits the raw
        byte prefix. Under a non-``none`` codec the handle meters **wire**
        bytes and shards are framed independently, so the credit floors the
        wire prefix to whole *wire* shards — each of which decodes to exactly
        one payload shard — and converts back to payload bytes (unsharded
        streams credit the proportional payload prefix). With
        ``partial_credit`` off, cancelled streams forfeit everything in
        flight — the pre-credit behavior."""
        now = self.sim.now
        self.credit_cancel_pending(fl)
        remaining = fl.state_bytes - fl.delivered_bytes()
        if remaining <= 0:
            return True  # everything already on the new node
        if not self.topo.neighbors(fl.new_node):
            self.abort_scale_out(fl)
            return False

        wall0 = _time.perf_counter()
        sizes = trim_tensor_sizes(fl.tensor_sizes, remaining)
        plan = build_plan(self.strategy, self.topo, fl.new_node, remaining,
                          sizes, sync=None, codec=fl.codec)
        wall = _time.perf_counter() - wall0
        solver_s = wall if self.solver_time_model is None else self.solver_time_model
        fl.solver_s += solver_s

        # Re-negotiation: scheduler redistributes policies to the new sources.
        policy_dist = max((self._control_rtt(self.node, u) / 2
                           for u in list(plan.sources) + [fl.new_node]),
                          default=0.0)
        t_start = now + solver_s + policy_dist
        fl.replans += 1
        fl.plan = plan
        fl.timeline[f"replanned_{fl.replans}"] = t_start
        self._schedule_transfers(fl, plan, t_start, {}, gen=fl.replans)
        return True

    def credit_cancel_pending(self, fl: InflightScaleOut):
        """Cancel every pending stream of ``fl``, crediting each one's
        shard-aligned delivered prefix (the loop ``replan_scale_out`` has
        always run, factored out so reshard fetches share it verbatim —
        crediting semantics must stay byte-identical between the two
        paths)."""
        now = self.sim.now
        shard = int(fl.plan.shard_size) if self.partial_credit else 0
        for r in fl.pending():
            r.handle.cancel(now)
            if not self.partial_credit:
                continue
            got = int(r.handle.cancelled_delivered)
            if r.codec == wire_codec.CODEC_NONE:
                keep = (got // shard) * shard if shard > 0 else got
                r.credited = min(int(keep), int(r.nbytes))
                r.credited_wire = r.credited
            elif r.wire_shard > 0:
                n_shards = got // r.wire_shard
                r.credited = min(n_shards * r.payload_shard, int(r.nbytes))
                r.credited_wire = min(n_shards * r.wire_shard,
                                      int(r.wire_nbytes))
            else:  # unsharded encoded stream: proportional payload prefix
                frac = got / r.wire_nbytes if r.wire_nbytes else 0.0
                r.credited = min(int(frac * r.nbytes), int(r.nbytes))
                r.credited_wire = min(got, int(r.wire_nbytes))
            if r.credited > 0:
                fl.t_last_credit = max(fl.t_last_credit, now)

    # -- reshard fetches (ElasWave layout changes) --------------------------------
    #
    # A parallelism-plan reshard moves interval deltas between *live* members.
    # The fetches ride the same InflightScaleOut machinery (streams, credit,
    # replans) but must never touch membership: the fetching node is already
    # active, so there is no ``monitor.activate`` on finish and cancellation
    # must not ``register_leave`` it (``abort_scale_out`` is scale-out-only).

    def begin_reshard_fetch(self, node: int, plan: ReplicationPlan,
                            t_start: float) -> InflightScaleOut:
        """Schedule one member's reshard fetch streams starting at
        ``t_start`` (the engine charges solver + policy-distribution ahead
        of it). ``plan`` comes from ``plans.reshard_plan`` — shard-aligned
        per source, so mid-reshard churn credits exactly like scale-out."""
        total = sum(int(b) for b in plan.sources.values())
        shard = int(plan.shard_size)
        sizes = ([shard] * (total // shard) if shard > 0 and total else
                 ([total] if total else []))
        fl = InflightScaleOut(node, self.sim.now, total, sizes,
                              list(plan.sources), plan, {}, 0.0, t_start,
                              {"request": self.sim.now}, codec=self.codec)
        self._schedule_transfers(fl, plan, t_start, {}, gen=0)
        return fl

    def finish_reshard_fetch(self, fl: InflightScaleOut) -> float:
        """Virtual time this fetch's payload is installed (last stream's
        delivery + decode, or the last credit instant when credit completed
        it). Membership is untouched — the node was live throughout."""
        done_ts = [r.handle.done_t + r.decode_s
                   for r in fl.transfers if r.handle.done]
        return max(max(done_ts, default=fl.t_transfers_start),
                   fl.t_last_credit)

    def cancel_reshard_fetch(self, fl: InflightScaleOut):
        """Membership churn invalidated the whole reshard: drop this fetch,
        keeping delivered-byte credit for the ledger but *not* touching the
        fetching node's membership (it is still live)."""
        self.credit_cancel_pending(fl)
        fl.aborted = True

    def abort_scale_out(self, fl: InflightScaleOut, failure: bool = True):
        """The joining node died or lost all its links mid-replication."""
        for r in fl.pending():
            r.handle.cancel()
        fl.aborted = True
        if fl.new_node in self.topo.nodes:
            self.monitor.register_leave(fl.new_node, failure=failure)

    def _idle_for_scaleout(self, plan, t0, t_ready, neighbors) -> Dict[int, float]:
        """Idle attribution per §VI-C:
        * chaos: only replication sources pause training while serving shards
          (their next compute window shrinks); others keep training.
        * single-source (EDL+ barrier): every node waits for replication.
        * multi-source: every node both serves and waits.
        """
        window = t_ready - t0
        idle = {}
        active = [n for n in self.topo.active_nodes()]
        if self.strategy in ("chaos", "chaos-even"):
            for u in plan.sources:
                nbytes = plan.sources[u]
                # The plan's route may reference a link that churned away
                # after the stream completed (no replan touches a finished
                # stream): idle attribution then falls back to zero serve
                # time rather than dereferencing a dead edge.
                route = plan.routes[u]
                l = (self.topo.link(u, route[1])
                     if len(route) > 1 and self.topo.has_link(u, route[1])
                     else None)
                serve = nbytes * l.trans_delay_per_byte if l else 0.0
                # Serving overlaps with compute; idle is the non-hidden tail.
                hide = self.topo.nodes[u].compute_s
                idle[u] = max(0.0, serve - hide)
        elif self.strategy == "single-source":
            for u in active:
                idle[u] = window  # extra barrier in EDL+ blocks everyone
        elif self.strategy == "multi-source":
            for u in active:
                idle[u] = window
        return idle

    # -- scale-in (Fig 4b) -------------------------------------------------------

    def scale_in(self, node: int, failure: bool = False,
                 fault_t: Optional[float] = None) -> PrimitiveResult:
        t0 = self.sim.now
        timeline = {"request": t0}
        detection_s = None
        if fault_t is not None:
            # Monitor-detected failure: the node went silent at ``fault_t``
            # and the heartbeat sweep noticed now — the detection latency is
            # part of the end-to-end failure-to-recovery time even though
            # the handling below stays sub-ms.
            timeline["fault"] = fault_t
            timeline["detected"] = t0
            detection_s = t0 - fault_t
        # Control exchange (leave request / failure detection) is overlapped
        # with training; the blocking part is socket teardown + policy swap.
        wall = self._control_rtt(self.node, node) if not failure else 0.0
        self.monitor.register_leave(node, failure=failure)
        blocking = SOCKET_SETUP_S + self._update_sync_policy()
        if failure:
            # Failure mid-all-reduce → all-reduce restart for this iteration
            # (blocking portion stays sub-ms; the restarted all-reduce is
            # charged to the training loop, not the primitive).
            timeline["allreduce_restart"] = t0 + blocking
        timeline["done"] = t0 + blocking
        return PrimitiveResult(blocking, wall + blocking, timeline,
                               detection_s=detection_s)

    # -- connect-link (Fig 4c / 5b) -----------------------------------------------

    def connect_link(self, u: int, v: int, link: Link) -> PrimitiveResult:
        t0 = self.sim.now
        self.topo.add_link(u, v, link)
        self.monitor.reset_link(u, v)  # fresh link, fresh probe counters
        # Socket setup + measurement overlap with all-reduce + gradient
        # compute (§IV-C Fig 5b) — fully hidden; blocking part = policy swap.
        wall = self._control_rtt(self.node, u) + SOCKET_SETUP_S + MEASURE_SECONDS
        blocking = SOCKET_SETUP_S + self._update_sync_policy()
        self.monitor.record("link-join", (u, v))
        return PrimitiveResult(blocking, wall + blocking, {"request": t0,
                                                           "done": t0 + blocking})

    # -- disconnect-link (Fig 4d) ----------------------------------------------------

    def disconnect_link(self, u: int, v: int, failure: bool = False,
                        fault_t: Optional[float] = None) -> PrimitiveResult:
        t0 = self.sim.now
        self.topo.remove_link(u, v)
        self.monitor.reset_link(u, v)  # gone link, no lingering probe state
        wall = 0.0 if failure else self._control_rtt(self.node, u)
        blocking = SOCKET_SETUP_S + self._update_sync_policy()
        self.monitor.record("link-failure" if failure else "link-leave", (u, v))
        timeline = {"request": t0, "done": t0 + blocking}
        detection_s = None
        if fault_t is not None:
            timeline["fault"] = fault_t
            timeline["detected"] = t0
            detection_s = t0 - fault_t
        return PrimitiveResult(blocking, wall + blocking, timeline,
                               detection_s=detection_s)


# ---------------------------------------------------------------------------
# Facade used by benchmarks and tests.
# ---------------------------------------------------------------------------


class SimCluster:
    """An elastic synchronous-training cluster under one scaling strategy."""

    def __init__(self, topo: Topology, *, state_bytes: int,
                 tensor_sizes: Sequence[int], strategy: str = "chaos",
                 scheduler_node: Optional[int] = None,
                 codec: str = wire_codec.CODEC_NONE):
        self.sim = Sim()
        self.topo = topo
        self.net = Network(self.sim, topo)
        self.session = TrainingSession(self.sim, self.net, topo, state_bytes)
        self.state_bytes = state_bytes
        self.tensor_sizes = list(tensor_sizes)
        sched = scheduler_node if scheduler_node is not None else min(topo.active_nodes())
        self.scheduler = ChaosScheduler(self.sim, self.net, topo, self.session,
                                        scheduler_node=sched, strategy=strategy,
                                        codec=codec)

    def train(self, iterations: int = 1):
        self.session.run_iterations(iterations)

    def scale_out(self, new_node: int, links: Dict[int, Link],
                  compute_s: float = 1.0) -> ScaleOutResult:
        return self.scheduler.scale_out(new_node, links, self.state_bytes,
                                        self.tensor_sizes, compute_s=compute_s)

    def scale_in(self, node: int, failure: bool = False) -> PrimitiveResult:
        return self.scheduler.scale_in(node, failure=failure)

    def connect_link(self, u: int, v: int, link: Link) -> PrimitiveResult:
        return self.scheduler.connect_link(u, v, link)

    def disconnect_link(self, u: int, v: int, failure=False) -> PrimitiveResult:
        return self.scheduler.disconnect_link(u, v, failure=failure)
