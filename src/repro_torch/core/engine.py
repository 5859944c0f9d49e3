"""The churn-event pipeline, from ``repro/core/engine.py``: events, the
deterministic ledger and the engine loop that drives a backend.

* ``ChurnEvent`` — one churn occurrence (join / leave / node-failure /
  link events / silent faults / scheduler-fault / checkpoint),
  JSON-serializable; scenario traces (``repro_torch.scenarios``) are
  ordered lists of these, in the same JSONL format as the JAX package's.
* ``EventLedger`` — the deterministic record of what the pipeline did with
  each event. Same trace ⇒ byte-identical ledger (``canonical_bytes``).
* ``ChurnEngine`` — pulls events in scenario-time order and drives a
  backend. ``SimBackend`` (here) executes them against the discrete-event
  cluster (``core.negotiation.SimCluster``) with overlapping-event
  semantics: a leave, link failure or link-rate drop arriving
  mid-replication cancels the doomed shard streams, credits the
  shard-aligned prefix each stream already delivered, and re-plans only the
  missing bytes. ``run_trace_sim`` and ``run_trace_goodput`` are its entry
  points. ``repro_torch.elastic.TrainerBackend`` replays the same trace
  against the real ``ElasticTrainer``.

``ChurnEvent.link_objects`` builds the port's ``topology.Link`` objects for
the simulator.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field, replace
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.core import codec as wire_codec
from repro_torch.core.control import ControlPlane
from repro_torch.core.goodput import GoodputReport, SimCheckpointTier, goodput_report
from repro_torch.core.negotiation import InflightScaleOut, SimCluster
from repro_torch.core.plans import (
    RESHARD_MODES,
    ParallelismPlan,
    ReshardPolicy,
    reshard_plan,
)
from repro_torch.core.recovery import (
    RECOVERY_ACTIONS,
    FaultContext,
    decision_detail,
    make_policy,
)
from repro_torch.core.topology import Link

EVENT_KINDS = ("join", "leave", "node-failure",
               "link-join", "link-leave", "link-failure", "link-degrade",
               # silent faults: no churn emitted, the monitor must detect
               "node-fault", "link-fault", "link-loss",
               # the scheduler node itself fails silently: the deputies'
               # ack-watch must detect it and elect a successor
               "scheduler-fault",
               # trace-borne checkpoint request: force a push of the
               # checkpoint tier *now* (recorded cadences replay verbatim);
               # skipped when the backend runs without a tier
               "checkpoint")

#: floor for link-degrade rates: degrading to ≤ 0 Mbit/s would break the
#: transfer-time model (divide by zero); severing is link-failure's job.
MIN_LINK_MBPS = 1e-6


@dataclass
class ChurnEvent:
    """One churn occurrence. ``t`` is scenario time: virtual seconds for the
    simulator; the trainer backend treats it as ordering only."""
    t: float
    kind: str  # one of EVENT_KINDS
    node: Optional[int] = None  # join / leave / node-failure / node-fault
    u: Optional[int] = None  # link events
    v: Optional[int] = None
    links: Optional[Dict[int, Tuple[float, float]]] = None  # peer -> (mbps, lat_s)
    compute_s: float = 1.0
    bandwidth_mbps: Optional[float] = None  # link-join / link-degrade: new rate
    latency_s: Optional[float] = None  # link-join / link-degrade: new latency
    loss_rate: Optional[float] = None  # link-loss: probe drop probability
    # Election-ledger fields (scheduler-fault): ``new_home`` doubles as the
    # preferred successor when the event is replayed live.
    term: Optional[int] = None
    new_home: Optional[int] = None
    election_s: Optional[float] = None
    #: join-only codec policy override ("none"/"int8"/"int8+topk"/"auto"):
    #: this join's replication runs under the given policy instead of the
    #: backend's standing one. None = backend default.
    codec: Optional[str] = None
    #: parallelism-plan resharding annotations (join / leave / node-failure):
    #: ``reshard`` overrides the backend's standing reshard mode;
    #: ``new_shape`` pins the target (dp, tp) when it matches the surviving
    #: device count; ``old_shape`` is carried by recorded traces.
    reshard: Optional[str] = None
    old_shape: Optional[Tuple[int, ...]] = None
    new_shape: Optional[Tuple[int, ...]] = None
    #: per-event recovery-action override (one of ``RECOVERY_ACTIONS``) for
    #: the failure this event causes. None = let the policy choose.
    recovery: Optional[str] = None

    def __post_init__(self):
        if self.kind not in EVENT_KINDS:
            raise ValueError(f"unknown churn event kind {self.kind!r}")
        if self.reshard is not None and self.reshard not in RESHARD_MODES:
            raise ValueError(f"unknown reshard mode {self.reshard!r}")
        if self.recovery is not None and self.recovery not in RECOVERY_ACTIONS:
            raise ValueError(f"unknown recovery action {self.recovery!r}")

    def to_json(self) -> dict:
        # Every field serializes on `is None` checks (not truthiness), so an
        # empty links dict or an explicit 0.0 latency survives the round-trip.
        out = {"t": self.t, "kind": self.kind}
        if self.node is not None:
            out["node"] = self.node
        if self.u is not None:
            out["u"], out["v"] = self.u, self.v
        if self.links is not None:
            out["links"] = {str(p): [bw, lat] for p, (bw, lat)
                            in sorted(self.links.items())}
            out["compute_s"] = self.compute_s
        if self.bandwidth_mbps is not None:
            out["bandwidth_mbps"] = self.bandwidth_mbps
        if self.latency_s is not None:
            out["latency_s"] = self.latency_s
        if self.loss_rate is not None:
            out["loss_rate"] = self.loss_rate
        if self.term is not None:
            out["term"] = self.term
        if self.new_home is not None:
            out["new_home"] = self.new_home
        if self.election_s is not None:
            out["election_s"] = self.election_s
        if self.codec is not None:
            out["codec"] = self.codec
        if self.reshard is not None:
            out["reshard"] = self.reshard
        if self.old_shape is not None:
            out["old_shape"] = [int(s) for s in self.old_shape]
        if self.new_shape is not None:
            out["new_shape"] = [int(s) for s in self.new_shape]
        if self.recovery is not None:
            out["recovery"] = self.recovery
        return out

    @classmethod
    def from_json(cls, d: dict) -> "ChurnEvent":
        links = None
        if "links" in d:
            links = {int(p): (bw, lat) for p, (bw, lat) in d["links"].items()}
        return cls(t=float(d["t"]), kind=d["kind"], node=d.get("node"),
                   u=d.get("u"), v=d.get("v"), links=links,
                   compute_s=float(d.get("compute_s", 1.0)),
                   bandwidth_mbps=d.get("bandwidth_mbps"),
                   latency_s=d.get("latency_s"),
                   loss_rate=d.get("loss_rate"),
                   term=d.get("term"), new_home=d.get("new_home"),
                   election_s=d.get("election_s"), codec=d.get("codec"),
                   reshard=d.get("reshard"),
                   old_shape=(tuple(int(s) for s in d["old_shape"])
                              if "old_shape" in d else None),
                   new_shape=(tuple(int(s) for s in d["new_shape"])
                              if "new_shape" in d else None),
                   recovery=d.get("recovery"))

    def link_objects(self) -> Dict[int, Link]:
        return {p: Link(bw, lat) for p, (bw, lat) in (self.links or {}).items()}


@dataclass
class LedgerRecord:
    seq: int  # event sequence number (trace order); -1 for engine-internal
    t: float  # scenario time the action took effect
    kind: str  # event kind, or engine action like "replan"/"ready"/"aborted"
    subject: Tuple  # node id or (u, v)
    action: str  # what the pipeline did
    detail: dict = field(default_factory=dict)

    def to_json(self) -> dict:
        return {"seq": self.seq, "t": self.t, "kind": self.kind,
                "subject": list(self.subject), "action": self.action,
                "detail": self.detail}


class EventLedger:
    """Deterministic, append-only record of pipeline decisions.

    Two runs of the same trace produce byte-identical ``canonical_bytes()``.
    Keep wall-clock measurements out of ``detail``; virtual times and byte
    counts only.
    """

    def __init__(self):
        self.records: List[LedgerRecord] = []

    def append(self, seq: int, t: float, kind: str, subject, action: str,
               detail: Optional[dict] = None) -> LedgerRecord:
        if not isinstance(subject, tuple):
            subject = (subject,)
        rec = LedgerRecord(seq, t, kind, subject, action, detail or {})
        self.records.append(rec)
        return rec

    def __len__(self):
        return len(self.records)

    def __iter__(self):
        return iter(self.records)

    def actions(self) -> List[str]:
        return [r.action for r in self.records]

    def canonical_bytes(self) -> bytes:
        lines = [json.dumps(r.to_json(), sort_keys=True,
                            separators=(",", ":")) for r in self.records]
        return ("\n".join(lines) + "\n").encode()

    def digest(self) -> str:
        return hashlib.sha256(self.canonical_bytes()).hexdigest()


class ChurnEngine:
    """The event pipeline: pulls churn events from a source, hands them to a
    backend in scenario-time order, and keeps the ledger + per-event results.

    ``results[seq]`` maps an event's trace position to the result it
    produced: the simulator's ``ScaleOutResult`` once the join's replication
    drains, which may be several events later, or the trainer backend's
    ``ScaleEvent``.
    """

    def __init__(self, backend):
        self.backend = backend
        self.ledger = EventLedger()

    @property
    def results(self) -> Dict[int, object]:
        return self.backend.results

    def run(self, events: Iterable[ChurnEvent]) -> EventLedger:
        seq_events = sorted(enumerate(events), key=lambda p: (p[1].t, p[0]))
        for seq, ev in seq_events:
            self.backend.advance_to(ev.t, self.ledger)
            self.backend.handle(seq, ev, self.ledger)
        self.backend.drain(self.ledger)
        return self.ledger


# ---------------------------------------------------------------------------
# Simulation backend: overlapping events against the discrete-event cluster.
# ---------------------------------------------------------------------------


class SimBackend:
    """Executes churn events on a :class:`SimCluster` with overlap semantics.

    A join starts an :class:`InflightScaleOut` and the engine moves on; the
    replication drains in virtual time while later events are dispatched. A
    leave / node-failure / link event that touches an in-flight replication
    (a source node, a route link, or the joining node itself) triggers a
    re-plan of the undelivered bytes — or an abort when the joining node has
    nothing left to pull from.
    """

    #: virtual seconds charged per Alg 1+2 solve under the engine. A fixed
    #: charge (not the measured wall time) is what makes same-seed replays
    #: byte-identical; pass ``solver_charge_s="measured"`` (benchmarks) to
    #: keep the paper's measured-solver-on-critical-path semantics.
    DEFAULT_SOLVER_CHARGE_S = 1e-3

    def __init__(self, cluster: SimCluster, *, min_active: int = 2,
                 solver_charge_s=DEFAULT_SOLVER_CHARGE_S,
                 partial_credit: bool = True, detection_seed: int = 0,
                 detector: str = "phi",
                 codec: str = wire_codec.CODEC_NONE,
                 checkpoint: Optional[str] = None,
                 ckpt_interval_s: Optional[float] = None,
                 policy="fixed",
                 accounting: bool = False,
                 reshard: str = "never",
                 reshard_policy: Optional[ReshardPolicy] = None):
        self.cluster = cluster
        self.min_active = min_active
        # Unified recovery-policy layer (repro_torch.core.recovery): every fault
        # handler consults ``self.policy`` — which action to take on a node
        # failure, whether to credit-replan touched streams, whether a new
        # leader adopts or rebuilds an in-flight scale-out, and whether a
        # membership change reshapes the (dp, tp) plan. ``"fixed"``
        # reproduces the pre-policy behavior exactly (no decision records);
        # ``"adaptive"`` scores feasible actions with costs calibrated
        # online from this run's own ledger measurements.
        self.policy = make_policy(policy, reshard=reshard,
                                  reshard_policy=reshard_policy,
                                  state_bytes=cluster.state_bytes)
        #: park-and-degrade was chosen at least once: the cluster runs on
        #: under a relaxed sync policy instead of restoring redundancy.
        self.degraded = False
        #: fault subject -> per-event recovery override, stashed at silent
        #: injection and honored when the monitor detects the failure.
        self._fault_recovery: Dict[Tuple, str] = {}
        #: GoodPut accounting (repro_torch.core.goodput): a pure post-hoc read of
        #: the ledger — enabling it cannot change a ledger byte.
        self.accounting = bool(accounting)
        self.goodput: Optional[GoodputReport] = None
        self._t_start = cluster.sim.now
        # Standing codec policy for state-bearing transfers; per-join trace
        # events may override it (ChurnEvent.codec). "none" replays every
        # pre-codec trace byte-identically.
        cluster.scheduler.codec = wire_codec.validate_policy(codec)
        self.inflight: List[InflightScaleOut] = []
        self._inflight_seq: Dict[int, int] = {}  # new_node -> event seq
        self.results: Dict[int, object] = {}
        cluster.scheduler.solver_time_model = (
            None if solver_charge_s == "measured" else float(solver_charge_s))
        cluster.scheduler.partial_credit = bool(partial_credit)
        # Detection wiring: the monitor's sweeps report detected failures
        # here so they re-enter the pipeline as synthesized churn events.
        # Sweeps stay off until the first fault event, so omniscient traces
        # replay exactly as before. ``detector`` picks the suspicion model
        # ("phi" adaptive phi-accrual, "fixed" timeout baseline).
        self.detection_seed = int(detection_seed)
        self.detector = str(detector)
        self._fault_seq: Dict[Tuple, int] = {}  # fault subject -> trace seq
        self._detection: Optional[dict] = None  # fault_t/detected_t context
        self._ledger: Optional[EventLedger] = None
        mon = cluster.scheduler.monitor
        mon.on_node_detected = self._node_failure_detected
        mon.on_link_detected = self._link_failure_detected
        mon.on_fault_cleared = self._fault_cleared
        # Decentralized control plane (repro_torch.core.control): deputies hold a
        # replica of the scheduler state and elect a successor when the
        # scheduler itself goes silently bad. Inert (no daemons, no
        # datagrams) until the first fault starts the sweeps.
        self.control = ControlPlane(cluster.sim, cluster.net, cluster.topo,
                                    mon, cluster.scheduler)
        self.control.inflight_provider = lambda: [
            (self._inflight_seq.get(fl.new_node, -1), fl)
            for fl in self.inflight if not fl.aborted]
        self.control.on_failover = self._failover_installed
        self._sched_fault_seq = -1
        #: omniscient events arriving while leaderless: nobody can process a
        #: join/leave request until a successor is installed.
        self._parked: List[Tuple[int, ChurnEvent]] = []
        # Checkpoint tier (repro_torch.core.goodput): periodic pushes riding the
        # network as contending transfers, churn-adaptive cadence, ledgered
        # restore paths. None (the default) schedules nothing and writes no
        # records — pre-checkpoint traces replay byte-identically.
        self.ckpt: Optional[SimCheckpointTier] = None
        if checkpoint is not None:
            self.ckpt = SimCheckpointTier(self, cadence=checkpoint,
                                          interval_s=ckpt_interval_s)
        # Parallelism-plan resharding (ElasWave): membership changes may
        # reshape the (dp, tp) layout instead of re-replicating into the old
        # one. The reshard mode/policy live on ``self.policy`` — reshard is
        # one candidate recovery action, not a separate gate. ``"never"``
        # (the default) leaves ``self.plan`` None — the implicit pure-DP
        # full-replica layout — and writes no records, so every pre-reshard
        # trace replays byte-identically.
        self.plan: Optional[ParallelismPlan] = None
        self._reshard: Optional[dict] = None  # one in-flight reshard at a time
        self._join_reshard: Dict[int, Tuple] = {}  # node -> (mode, new_shape)

    def metrics_snapshot(self, now: Optional[float] = None) -> Dict:
        """Point-in-time counter read across the backend's layers for
        telemetry scrapes (repro_torch.core.telemetry). Pure read — scraping can
        never change a ledger byte or perturb the event queue."""
        sched = self.cluster.scheduler
        return {
            "n_active": len(self.cluster.topo.active_nodes()),
            "degraded": self.degraded,
            "inflight_scaleouts": sum(1 for fl in self.inflight
                                      if not fl.aborted),
            "replication_payload_bytes": sched.replication_payload_bytes,
            "replication_wire_bytes": sched.replication_wire_bytes,
        }

    # -- engine protocol -----------------------------------------------------

    def advance_to(self, t: float, ledger: EventLedger):
        self._ledger = ledger
        sim = self.cluster.sim
        if t > sim.now:
            sim.run(until=t)
        self._pump(ledger)

    def handle(self, seq: int, ev: ChurnEvent, ledger: EventLedger):
        self._ledger = ledger
        if (self.control.leaderless and ev.kind not in
                ("scheduler-fault", "node-fault", "link-fault", "link-loss")):
            # Leaderless window: silent faults still change the world (they
            # ask no one's permission), but omniscient events either park
            # (requests — nobody can grant them) or convert to pending
            # faults (physics that happened unannounced).
            self._defer_leaderless(seq, ev, ledger)
            return
        dispatch = {
            "join": self._on_join,
            "leave": self._on_leave,
            "node-failure": self._on_leave,
            "link-join": self._on_link_join,
            "link-leave": self._on_link_down,
            "link-failure": self._on_link_down,
            "link-degrade": self._on_link_degrade,
            "node-fault": self._on_node_fault,
            "link-fault": self._on_link_fault,
            "link-loss": self._on_link_loss,
            "scheduler-fault": self._on_scheduler_fault,
            "checkpoint": self._on_checkpoint,
        }
        dispatch[ev.kind](seq, ev, ledger)

    def drain(self, ledger: EventLedger):
        """Drain transfers AND outstanding detections: monitor sweeps are
        daemon events (they never keep ``sim.run()`` alive), so after real
        work drains we keep advancing the clock until every injected fault
        has been detected — or deterministically given up on (a lossy link
        that never tripped the consecutive-failure threshold).

        The advance is *suspicion-aware*: the monitor owns each fault's
        give-up deadline (set at injection, sized for fully backed-off
        adaptive sweeps) and exposes the earliest one as
        ``detection_horizon()``. The drain steps the clock toward that
        horizon one worst-case sweep period at a time, so detections —
        and the replication re-plans they trigger — land at their natural
        virtual times instead of after one big jump."""
        self._ledger = ledger
        sim = self.cluster.sim
        mon = self.sched.monitor
        while True:
            sim.run()
            self._pump(ledger)
            horizons = [h for h in (mon.detection_horizon(),
                                    self.control.detection_horizon())
                        if h is not None]
            if not horizons:
                if sim._live:
                    # _pump itself scheduled real work (a membership change
                    # completing at drain time can *start* a reshard, whose
                    # fetch streams are new live transfers) — keep draining.
                    continue
                break
            horizon = min(horizons)
            step_to = min(max(horizon, sim.now), sim.now + mon.drain_step_s())
            sim.run(until=max(step_to, sim.now + 1e-9))
            self._pump(ledger)
            expired = self.control.expire(sim.now)
            if expired is not None:
                # No quorum anywhere by the deadline (minority partition
                # side): the fail-over fails terminally and the cluster
                # freezes — parked requests are refused, not forgotten.
                detail = {"fault_t": expired["fault_t"],
                          "terms_tried": expired["terms_tried"]}
                if "detected_t" in expired:
                    detail["detected_t"] = expired["detected_t"]
                ledger.append(self._sched_fault_seq, sim.now,
                              "scheduler-fault", expired["old_home"],
                              "election-no-quorum", detail)
                self._fault_seq.pop(("node", expired["old_home"]), None)
                self._flush_parked_frozen(ledger)
            for kind, subject, fault_t in mon.expire_faults(sim.now):
                key = (("node", subject[0]) if kind == "node-fault"
                       else ("link", subject))
                seq = self._fault_seq.pop(key, -1)
                ledger.append(seq, sim.now, kind, subject, "fault-undetected",
                              {"fault_t": fault_t})
        if self.ckpt is not None:
            self.ckpt.finalize(ledger)
        self._flush_parked_frozen(ledger)
        if self.accounting:
            self.goodput = goodput_report(ledger, t_start=self._t_start,
                                          t_end=sim.now)

    def _flush_parked_frozen(self, ledger: EventLedger):
        """A frozen (no-quorum) cluster can never process parked requests:
        give each a terminal record so every trace event reaches one."""
        if not self.control.frozen:
            return
        for seq, ev in self._parked:
            subject = ev.node if ev.node is not None else (ev.u, ev.v)
            ledger.append(seq, self.cluster.sim.now, ev.kind, subject,
                          "skipped-leaderless")
        self._parked = []

    # -- helpers -------------------------------------------------------------

    @property
    def sched(self):
        return self.cluster.scheduler

    @property
    def topo(self):
        return self.cluster.topo

    def _pump(self, ledger: EventLedger):
        """Finalize replications whose transfers have drained."""
        if self.control.leaderless:
            # Finalization (state install + policy swap + activation) is
            # leader work: drained replications wait for the election —
            # exactly the window benchmarks/failover_delay.py measures.
            return
        for fl in list(self.inflight):
            if fl.aborted:
                self.inflight.remove(fl)
                continue
            if fl.complete:
                res = self.sched.finish_scale_out(fl)
                seq = self._inflight_seq.pop(fl.new_node, -1)
                self.results[seq] = res
                detail = {
                    "delay_s": res.delay_s,
                    "replication_s": res.replication_s,
                    "replans": res.replans,
                    "credited_bytes": fl.credited_bytes(),
                    "plan": fl.plan.summary(),
                }
                # Wire accounting only under an active codec: "none" ledgers
                # must stay byte-identical to the pre-codec format.
                if fl.codec != wire_codec.CODEC_NONE:
                    detail["codec"] = fl.codec
                    detail["wire_delivered_bytes"] = fl.wire_delivered_bytes()
                    # Decode charge on the install critical path — the
                    # "decode" BadPut category (repro_torch.core.goodput).
                    detail["decode_s"] = fl.decode_critical_s()
                ledger.append(seq, res.timeline["ready"], "join",
                              fl.new_node, "ready", detail)
                self.inflight.remove(fl)
                # The join changed active membership: a layout change may
                # now pay off (and any in-flight reshard planned against
                # the smaller cluster is stale).
                mode, pinned = self._join_reshard.pop(fl.new_node,
                                                      (None, None))
                self._cancel_reshard(ledger, "membership-changed")
                self._after_membership_change(seq, ledger, mode, pinned)
        self._finalize_reshard(ledger)

    # -- recovery-policy plumbing ---------------------------------------------

    def _record_decision(self, seq: int, ledger: EventLedger,
                         ctx: FaultContext, dec) -> None:
        """Ledger a policy verdict as a first-class ``recovery-decided``
        record (scored alternatives included) — how GoodPut attributes time
        per chosen action. Silent policies (FixedPolicy) write nothing so
        pre-policy digests replay byte-identically; a per-event override
        (``forced``) always records — the annotation itself is new input."""
        if not (self.policy.records or dec.forced):
            return
        ledger.append(seq, self.cluster.sim.now, "recovery", ctx.subject,
                      "recovery-decided", decision_detail(ctx, dec))

    def _link_classes(self) -> Tuple[float, ...]:
        """Sorted live-link bandwidth classes (Mbit/s) — the WAN
        heterogeneity input to adaptive scoring. Deterministic: sorted,
        rounded, active links only."""
        seen = set()
        for u in self.topo.active_nodes():
            for v in self.topo.neighbors(u):
                seen.add((min(u, v), max(u, v)))
        return tuple(sorted(round(self.topo.link(u, v).bandwidth_mbps, 6)
                            for u, v in seen))

    def _failure_context(self, node: int, ev: ChurnEvent,
                         det: dict) -> FaultContext:
        """Build the node-failure decision context from what the ledger
        already measures. The substrate-local fields (detection latency,
        link classes, checkpoint age) feed the cost scores only; the parity
        projection (``recovery.decision_digest``) never sees them."""
        override = (ev.recovery if ev.recovery is not None
                    else self._fault_recovery.pop(("node", node), None))
        ckpt_age = None
        if self.ckpt is not None:
            last = self.ckpt.last_ckpt
            if last is not None and last.get("holder") != node:
                ckpt_age = self.cluster.sim.now - last["t"]
        return FaultContext(
            kind="node-failure", t=self.cluster.sim.now, subject=(node,),
            n_active=len(self.topo.active_nodes()),
            min_active=self.min_active,
            state_bytes=self.cluster.state_bytes,
            detection_s=det.get("detection_s"),
            link_mbps=self._link_classes(),
            # A full peer replica survives unless the plan is sharded with
            # a single data-parallel replica group.
            replica_feasible=(self.plan is None or self.plan.dp > 1),
            ckpt_available=self.ckpt is not None, ckpt_age_s=ckpt_age,
            override=override)

    def _park_and_degrade(self, seq: int, node: int, ledger: EventLedger):
        """Execute ``park-and-degrade``: no state is restored — the cluster
        trains on without the dead node's redundancy, paying only a sync
        policy swap. Terminal record; ``blocking_s`` routes the swap into
        the "handling" BadPut window."""
        swap_s = self.sched._update_sync_policy()
        self.degraded = True
        ledger.append(seq, self.cluster.sim.now, "recovery", node,
                      "parked-degraded", {
                          "blocking_s": swap_s,
                          "n_active": len(self.topo.active_nodes()),
                          "sync_policy_version": self.sched.sync_policy_version,
                      })

    # -- parallelism-plan resharding (ElasWave) --------------------------------
    #
    # ``self.plan`` is the cluster's current ParallelismPlan; None means the
    # implicit pure-DP layout every pre-reshard trace ran under (all members
    # hold the full state). A membership change evaluates the divisor chain
    # of surviving shapes via the shared ``decide_reshard`` policy; a "go"
    # emits ``reshard-started``, schedules the interval-delta fetches through
    # the same credited stream machinery as scale-out, and ``reshard-ready``
    # lands when the last fetch installs. Membership churn mid-reshard
    # cancels the whole reshard (holdings conservatively stay at the old
    # layout); link churn re-plans only the touched fetches with credit.

    def _reshard_fls(self) -> List[InflightScaleOut]:
        return (list(self._reshard["fls"].values())
                if self._reshard is not None else [])

    def _after_membership_change(self, seq: int, ledger: EventLedger,
                                 mode: Optional[str],
                                 pinned_shape) -> None:
        """Membership changed: ask the policy whether the layout should
        reshape. The reshard-vs-keep evaluation (including the forced
        replicate-only fall-back while sharded under mode "never") lives in
        ``repro_torch.core.recovery.evaluate_membership``; this method only
        executes the verdict."""
        active = sorted(self.topo.active_nodes())
        ctx = FaultContext(
            kind="membership-change", t=self.cluster.sim.now,
            subject=(self.sched.node,), n_active=len(active),
            min_active=self.min_active,
            state_bytes=self.cluster.state_bytes,
            plan=self.plan, reshard_mode=mode, pinned_shape=pinned_shape,
            devices=tuple(active),
            tensor_sizes=tuple(self.cluster.tensor_sizes))
        dec = self.policy.decide(ctx)
        self._record_decision(seq, ledger, ctx, dec)
        if dec.reshard is not None:
            self._start_reshard(seq, dec.reshard, ledger)
        elif dec.baseline is not None and self.plan is not None:
            self.plan = dec.baseline  # refresh device membership

    def _start_reshard(self, seq: int, decision: dict, ledger: EventLedger):
        now = self.cluster.sim.now
        cand: ParallelismPlan = decision["plan"]
        rp = reshard_plan(self.plan, cand, self.topo,
                          self.cluster.state_bytes, codec=self.sched.codec)
        detail = {
            "old_shape": decision["old_shape"],
            "new_shape": decision["new_shape"],
            "moved_bytes": decision["moved_bytes"],
            "step_s": decision["step_s"],
            "baseline_step_s": decision["baseline_step_s"],
            "n_fetches": len(rp.fetches),
        }
        if rp.lost_bytes:
            detail["lost_bytes"] = rp.lost_bytes
        ledger.append(seq, now, "reshard", self.sched.node,
                      "reshard-started", detail)
        if not rp.fetches:
            # Nothing to move (e.g. DP → TP: every interval is a subset of
            # the full replicas): the layout swaps after the solver charge
            # + policy swap alone.
            solver_s = (self.sched.solver_time_model
                        if self.sched.solver_time_model is not None
                        else self.DEFAULT_SOLVER_CHARGE_S)
            t_ready = now + solver_s + self.sched._update_sync_policy()
            self.plan = cand
            ledger.append(seq, t_ready, "reshard", self.sched.node,
                          "reshard-ready",
                          {"old_shape": decision["old_shape"],
                           "new_shape": decision["new_shape"],
                           "moved_bytes": decision["moved_bytes"]})
            return
        solver_s = (self.sched.solver_time_model
                    if self.sched.solver_time_model is not None
                    else self.DEFAULT_SOLVER_CHARGE_S)
        targets = set()
        for node, plan in rp.fetches.items():
            targets.add(node)
            targets.update(plan.sources)
        policy_dist = max((self.sched._control_rtt(self.sched.node, u) / 2
                           for u in sorted(targets)), default=0.0)
        t_start = now + solver_s + policy_dist
        fls = {}
        for node, plan in sorted(rp.fetches.items()):
            fl = self.sched.begin_reshard_fetch(node, plan, t_start)
            self._stall_faulted_streams(fl)
            fls[node] = fl
        self._reshard = {"seq": seq, "fls": fls, "new": cand,
                         "decision": decision}

    def _finalize_reshard(self, ledger: EventLedger):
        rs = self._reshard
        if rs is None or not all(fl.complete for fl in rs["fls"].values()):
            return
        t_done = max(self.sched.finish_reshard_fetch(fl)
                     for fl in rs["fls"].values())
        t_ready = max(t_done, self.cluster.sim.now) \
            + self.sched._update_sync_policy()
        self.plan = rs["new"]
        d = rs["decision"]
        ledger.append(rs["seq"], t_ready, "reshard", self.sched.node,
                      "reshard-ready", {"old_shape": d["old_shape"],
                                        "new_shape": d["new_shape"],
                                        "moved_bytes": d["moved_bytes"]})
        self._reshard = None

    def _cancel_reshard(self, ledger: EventLedger, reason: str):
        rs = self._reshard
        if rs is None:
            return
        for fl in rs["fls"].values():
            self.sched.cancel_reshard_fetch(fl)
        d = rs["decision"]
        ledger.append(rs["seq"], self.cluster.sim.now, "reshard",
                      self.sched.node, "reshard-cancelled", {
                          "reason": reason,
                          "old_shape": d["old_shape"],
                          "new_shape": d["new_shape"],
                          "delivered_bytes": sum(
                              fl.delivered_bytes()
                              for fl in rs["fls"].values()),
                      })
        # Holdings conservatively stay at the old layout (self.plan); the
        # next membership evaluation re-plans from there.
        self._reshard = None

    def _replan_reshard_touched(self, ledger: EventLedger, *,
                                node=None, link=None):
        """Link churn invalidated reshard fetch streams: credit + re-plan
        each touched fetch (membership churn cancels the whole reshard
        instead — see ``_cancel_reshard``). A fetching node with no
        surviving route kills the reshard: ``replan_scale_out``'s abort
        path would deactivate a live member, so it must never run here."""
        rs = self._reshard
        if rs is None:
            return
        for fnode, fl in sorted(rs["fls"].items()):
            touched = ((node is not None and fl.uses_node(node))
                       or (link is not None and fl.uses_link(*link)))
            if not touched:
                continue
            if not self.topo.neighbors(fnode):
                self._cancel_reshard(ledger, "no-route")
                return
            self.sched.replan_scale_out(fl)
            delivered = fl.delivered_bytes()
            ledger.append(rs["seq"], self.cluster.sim.now, "reshard", fnode,
                          "reshard-replanned", {
                              "replans": fl.replans,
                              "delivered_bytes": delivered,
                              "credited_bytes": fl.credited_bytes(),
                              "replanned_bytes": max(
                                  0, fl.state_bytes - delivered),
                          })

    def _replan_touched(self, ledger: EventLedger, *, node=None, link=None,
                        seq: int = -1):
        """Re-plan (or abort) in-flight replications invalidated by churn.

        The stream-churn decision (credit-aware replan vs. restart from
        scratch) flows through the policy once per churn event; each re-plan
        then credits the shard-aligned prefix every cancelled stream had
        delivered (``credited_bytes``) and the new plan covers only the
        ``replanned_bytes`` still missing from the joining node. A stream
        with no surviving route aborts regardless — that is feasibility,
        not policy."""
        touched_fls = [fl for fl in self.inflight
                       if (node is not None and fl.uses_node(node))
                       or (link is not None and fl.uses_link(*link))]
        if not touched_fls:
            return
        ctx = FaultContext(
            kind="stream-churn", t=self.cluster.sim.now,
            subject=(node,) if node is not None else tuple(link),
            n_active=len(self.topo.active_nodes()),
            min_active=self.min_active,
            state_bytes=self.cluster.state_bytes,
            inflight_credit_bytes=sum(fl.delivered_bytes()
                                      for fl in touched_fls),
            link_mbps=self._link_classes())
        dec = self.policy.decide(ctx)
        self._record_decision(seq, ledger, ctx, dec)
        solver_s = (self.sched.solver_time_model
                    if self.sched.solver_time_model is not None
                    else self.DEFAULT_SOLVER_CHARGE_S)
        for fl in touched_fls:
            seq = self._inflight_seq.get(fl.new_node, -1)
            if self.sched.replan_scale_out(fl):
                self.policy.observe("replan", solver_s)
                self._stall_faulted_streams(fl)
                delivered = fl.delivered_bytes()
                detail = {
                    "replans": fl.replans,
                    "delivered_bytes": delivered,
                    "credited_bytes": fl.credited_bytes(),
                    "replanned_bytes": max(
                        0, fl.state_bytes - delivered),
                    "plan": fl.plan.summary(),
                }
                if fl.codec != wire_codec.CODEC_NONE:
                    detail["codec"] = fl.codec
                    detail["credited_wire_bytes"] = fl.credited_wire_bytes()
                    detail["replanned_wire_bytes"] = int(
                        fl.plan.total_wire_bytes())
                ledger.append(seq, self.cluster.sim.now, "join", fl.new_node,
                              "replanned", detail)
            else:
                self.inflight.remove(fl)
                self._inflight_seq.pop(fl.new_node, None)
                ledger.append(seq, self.cluster.sim.now, "join", fl.new_node,
                              "aborted", {"delivered_bytes": fl.delivered_bytes()})

    # -- event handlers -------------------------------------------------------

    def _on_join(self, seq: int, ev: ChurnEvent, ledger: EventLedger):
        node = ev.node
        info = self.topo.nodes.get(node)
        if info is not None and info.state in ("active", "standby"):
            ledger.append(seq, ev.t, ev.kind, node, "skipped-already-member")
            return
        links = {p: l for p, l in ev.link_objects().items()
                 if p in self.topo.nodes
                 and self.topo.nodes[p].state == "active" and p != node
                 and self.topo.has_path(self.sched.node, p)}
        if not links:
            ledger.append(seq, ev.t, ev.kind, node, "skipped-no-active-peers")
            return
        fl = self.sched.begin_scale_out(node, links, self.cluster.state_bytes,
                                        self.cluster.tensor_sizes,
                                        compute_s=ev.compute_s, codec=ev.codec)
        self._stall_faulted_streams(fl)
        self.inflight.append(fl)
        self._inflight_seq[node] = seq
        # Reshard evaluation happens when the join *completes* (membership
        # changes at activation, not at request) — stash the event's
        # per-event overrides until then.
        self._join_reshard[node] = (ev.reshard, ev.new_shape)
        detail = {
            "peers": sorted(links),
            "plan": fl.plan.summary(),
        }
        if fl.codec != wire_codec.CODEC_NONE:
            detail["codec"] = fl.codec
            detail["wire_bytes_total"] = int(fl.plan.total_wire_bytes())
        ledger.append(seq, ev.t, ev.kind, node, "scale-out-started", detail)

    def _on_leave(self, seq: int, ev: ChurnEvent, ledger: EventLedger):
        node = ev.node
        failure = ev.kind == "node-failure"
        det = dict(self._detection or {})  # monitor-detected: fault_t etc.
        # The joining node itself dying aborts its replication outright.
        for fl in list(self.inflight):
            if fl.new_node == node:
                self.sched.abort_scale_out(fl, failure=failure)
                self.inflight.remove(fl)
                s = self._inflight_seq.pop(node, -1)
                ledger.append(s, ev.t, "join", node, "aborted",
                              {"delivered_bytes": fl.delivered_bytes()})
                ledger.append(seq, ev.t, ev.kind, node,
                              "aborted-inflight-join", det)
                return
        info = self.topo.nodes.get(node)
        if info is None or info.state != "active":
            ledger.append(seq, ev.t, ev.kind, node, "skipped-not-active", det)
            return
        if node == self.sched.node:
            ledger.append(seq, ev.t, ev.kind, node, "skipped-scheduler-node",
                          det)
            return
        if len(self.topo.active_nodes()) <= self.min_active and not det:
            # The floor only blocks *policy* departures. A monitor-detected
            # death proceeds regardless: the node is physically gone, and
            # skipping would leave its stalled shard streams frozen forever.
            ledger.append(seq, ev.t, ev.kind, node, "skipped-min-cluster")
            return
        res = self.sched.scale_in(node, failure=failure,
                                  fault_t=det.get("fault_t"))
        self.results[seq] = res
        ledger.append(seq, ev.t, ev.kind, node,
                      "node-failed" if failure else "scaled-in",
                      {"blocking_s": res.delay_s, **det})
        self.policy.observe("handling", res.delay_s)
        self.policy.observe("detection", det.get("detection_s"))
        # Failures pick a recovery action *before* the world is patched up:
        # the context must see checkpoint freshness as it was at death.
        action = None
        if failure:
            ctx = self._failure_context(node, ev, det)
            dec = self.policy.decide(ctx)
            self._record_decision(seq, ledger, ctx, dec)
            action = dec.action
        # Membership changed: an in-flight reshard was planned against the
        # old membership and is stale in full.
        self._cancel_reshard(ledger, "membership-changed")
        # The departure may have severed in-flight shard streams.
        self._replan_touched(ledger, node=node, seq=seq)
        if self.ckpt is not None:
            # Credit a touched checkpoint push and drop holder state.
            # Detected failures were already counted as faults at injection.
            self.ckpt.on_node_event(seq, node, failure=failure,
                                    omniscient=not det)
        if failure:
            if action == "park-and-degrade":
                self._park_and_degrade(seq, node, ledger)
            elif self.ckpt is not None and action in (
                    "restore-replica", "restore-checkpoint"):
                self.ckpt.restore(seq, node, action)
        self._after_membership_change(seq, ledger, ev.reshard, ev.new_shape)

    def _on_link_join(self, seq: int, ev: ChurnEvent, ledger: EventLedger):
        u, v = ev.u, ev.v
        if u not in self.topo.nodes or v not in self.topo.nodes:
            ledger.append(seq, ev.t, ev.kind, (u, v), "skipped-unknown-node")
            return
        if self.topo.has_link(u, v):
            if self.sched.monitor.link_fault_pending(u, v):
                # A silent fault never removed the link from the topology,
                # so this link-join is a *restoration* racing detection
                # (e.g. a detector_stress flap whose restore wins): clear
                # the pending fault — reset_link reports it through
                # on_fault_cleared, closing the fault's ledger trail with a
                # terminal fault-cleared record — refresh the link's
                # parameters, and re-plan the streams the fault stalled
                # (their connections died with the blackhole; the bytes
                # already delivered stay credited).
                link = self.topo.link(u, v)
                if ev.bandwidth_mbps is not None:
                    link.bandwidth_mbps = max(float(ev.bandwidth_mbps),
                                              MIN_LINK_MBPS)
                if ev.latency_s is not None:
                    link.latency_s = float(ev.latency_s)
                self.topo.touch()
                self.sched.monitor.reset_link(u, v)
                ledger.append(seq, ev.t, ev.kind, (u, v), "link-restored", {
                    "bandwidth_mbps": link.bandwidth_mbps,
                    "latency_s": link.latency_s,
                })
                self._replan_touched(ledger, link=(u, v), seq=seq)
                self._replan_reshard_touched(ledger, link=(u, v))
                return
            ledger.append(seq, ev.t, ev.kind, (u, v), "skipped-link-exists")
            return
        # `is None` (not truthiness): an explicit 0.0 latency is a real
        # zero-propagation link, not a request for the default. Rates are
        # clamped to the same floor link-degrade uses — a 0 Mbit/s link
        # would divide-by-zero the transfer model.
        bw = (100.0 if ev.bandwidth_mbps is None
              else max(float(ev.bandwidth_mbps), MIN_LINK_MBPS))
        lat = 0.01 if ev.latency_s is None else float(ev.latency_s)
        res = self.sched.connect_link(u, v, Link(bw, lat))
        self.results[seq] = res
        ledger.append(seq, ev.t, ev.kind, (u, v), "link-connected",
                      {"blocking_s": res.delay_s})

    def _on_link_down(self, seq: int, ev: ChurnEvent, ledger: EventLedger):
        u, v = ev.u, ev.v
        failure = ev.kind == "link-failure"
        det = dict(self._detection or {})
        if not self.topo.has_link(u, v):
            ledger.append(seq, ev.t, ev.kind, (u, v), "skipped-no-link", det)
            return
        res = self.sched.disconnect_link(u, v, failure=failure,
                                         fault_t=det.get("fault_t"))
        self.results[seq] = res
        ledger.append(seq, ev.t, ev.kind, (u, v),
                      "link-failed" if failure else "link-disconnected",
                      {"blocking_s": res.delay_s, **det})
        self.policy.observe("handling", res.delay_s)
        self.policy.observe("detection", det.get("detection_s"))
        self._replan_touched(ledger, link=(u, v), seq=seq)
        self._replan_reshard_touched(ledger, link=(u, v))
        if self.ckpt is not None:
            self.ckpt.on_link_event((u, v))

    def _on_link_degrade(self, seq: int, ev: ChurnEvent, ledger: EventLedger):
        """A link survives but its rate/latency changed (congestion, tc
        reshaping, a failing NIC). The monitor re-measures, and any in-flight
        replication riding the link gets a credit-aware reshuffle: delivered
        shards stay put, the missing bytes are re-planned at the new rates."""
        u, v = ev.u, ev.v
        if not self.topo.has_link(u, v):
            ledger.append(seq, ev.t, ev.kind, (u, v), "skipped-no-link")
            return
        link = self.topo.link(u, v)
        if ev.bandwidth_mbps is not None:
            # A zero/negative rate would divide-by-zero the transfer model;
            # a link that slow is indistinguishable from one crawling at the
            # floor (use link-failure to actually sever it).
            link.bandwidth_mbps = max(float(ev.bandwidth_mbps), MIN_LINK_MBPS)
        if ev.latency_s is not None:
            link.latency_s = float(ev.latency_s)
        self.topo.touch()  # in-place Link mutation: route caches are stale
        self.sched.monitor.record("link-degrade", (u, v))
        ledger.append(seq, ev.t, ev.kind, (u, v), "link-degraded", {
            "bandwidth_mbps": link.bandwidth_mbps,
            "latency_s": link.latency_s,
        })
        self._replan_touched(ledger, link=(u, v), seq=seq)
        self._replan_reshard_touched(ledger, link=(u, v))
        if self.ckpt is not None:
            # The push's precomputed timing rode the old rate: cancel with
            # credit and resume the missing bytes at the new one.
            self.ckpt.on_link_event((u, v))

    # -- fault injection + monitor-driven detection ----------------------------
    #
    # Fault events change the world silently: no churn is emitted, the
    # monitor's periodic sweeps (started lazily on the first fault, so
    # omniscient traces replay byte-identically) must notice and synthesize
    # the corresponding node-failure / link-failure back into this backend.

    def _start_sweeps(self):
        self.sched.monitor.start_sweeps(seed=self.detection_seed,
                                        detector=self.detector)
        # The control plane rides the same lazy start: from the first fault
        # on, deputies hold a continuously synced replica of the scheduler
        # state and watch heartbeat acks — so a later scheduler-fault finds
        # replicas that honestly predate it.
        self.control.start(seed=self.detection_seed)

    @staticmethod
    def _route_uses_link(route, key) -> bool:
        return any((min(a, b), max(a, b)) == key
                   for a, b in zip(route, route[1:]))

    def _stall_touched(self, *, node=None, link=None):
        """Freeze in-flight shard streams a silent fault just killed: the
        bytes stop flowing immediately, but the engine doesn't learn why
        until the monitor detects the fault — that gap is the detection
        latency the benchmarks measure."""
        now = self.cluster.sim.now
        key = (min(link), max(link)) if link is not None else None
        for fl in self.inflight + self._reshard_fls():
            for r in fl.pending():
                if node is not None and (r.source == node or node in r.route):
                    r.handle.stall(now)
                elif key is not None and self._route_uses_link(r.route, key):
                    r.handle.stall(now)
        if self.ckpt is not None:
            # Checkpoint pushes freeze under silent faults exactly like
            # replication streams; detection cancels + credits the prefix.
            self.ckpt.stall_if_touched(node=node, link=link)

    def _stall_faulted_streams(self, fl):
        """Streams *planned after* a silent fault die just as dead: the
        scheduler doesn't know the subject is bad (no omniscient filtering
        at plan time), so the plan may source from a silent node or route
        over a blackholed link — those bytes simply never flow, and the
        eventual detection re-plans them."""
        mon = self.sched.monitor
        bad_nodes = mon.faulted_nodes()
        bad_links = mon.faulted_links()
        if not bad_nodes and not bad_links:
            return
        now = self.cluster.sim.now
        for r in fl.pending():
            if any(n == r.source or n in r.route for n in bad_nodes):
                r.handle.stall(now)
            elif any(self._route_uses_link(r.route, k) for k in bad_links):
                r.handle.stall(now)

    def _on_node_fault(self, seq: int, ev: ChurnEvent, ledger: EventLedger):
        node = ev.node
        info = self.topo.nodes.get(node)
        live = info is not None and info.state in ("active", "standby")
        if not live:
            ledger.append(seq, ev.t, ev.kind, node, "skipped-not-active")
            return
        if node == self.sched.node:
            # The monitor lives on the scheduler node and cannot detect its
            # own silence — killing the scheduler is the `scheduler-fault`
            # kind's job (deputy ack-watch + peer election, control.py).
            ledger.append(seq, ev.t, ev.kind, node, "skipped-scheduler-node")
            return
        if self.sched.monitor.node_faulted(node):
            # Re-faulting a subject already pending detection would orphan
            # the first fault's ledger trail (every fault-injected record
            # must reach exactly one terminal record).
            ledger.append(seq, ev.t, ev.kind, node, "skipped-duplicate-fault")
            return
        self._start_sweeps()
        self.sched.monitor.inject_node_fault(node)
        self._stall_touched(node=node)
        if self.ckpt is not None:
            # Node-failure arrivals feed the adaptive cadence; counted at
            # injection (detection just reveals them later).
            self.ckpt.note_fault()
        self._fault_seq[("node", node)] = seq
        if ev.recovery is not None:
            # Honored when the monitor detects the death this fault causes.
            self._fault_recovery[("node", node)] = ev.recovery
        ledger.append(seq, ev.t, ev.kind, node, "fault-injected")

    def _on_link_fault(self, seq: int, ev: ChurnEvent, ledger: EventLedger):
        u, v = min(ev.u, ev.v), max(ev.u, ev.v)
        if not self.topo.has_link(u, v):
            ledger.append(seq, ev.t, ev.kind, (u, v), "skipped-no-link")
            return
        if self.sched.monitor.link_fault_pending(u, v):
            ledger.append(seq, ev.t, ev.kind, (u, v),
                          "skipped-duplicate-fault")
            return
        self._start_sweeps()
        self.sched.monitor.inject_link_fault(u, v)
        self._stall_touched(link=(u, v))
        self._fault_seq[("link", (u, v))] = seq
        ledger.append(seq, ev.t, ev.kind, (u, v), "fault-injected")

    def _on_link_loss(self, seq: int, ev: ChurnEvent, ledger: EventLedger):
        u, v = min(ev.u, ev.v), max(ev.u, ev.v)
        if not self.topo.has_link(u, v):
            ledger.append(seq, ev.t, ev.kind, (u, v), "skipped-no-link")
            return
        if self.sched.monitor.link_fault_pending(u, v):
            ledger.append(seq, ev.t, ev.kind, (u, v),
                          "skipped-duplicate-fault")
            return
        loss = 1.0 if ev.loss_rate is None else float(ev.loss_rate)
        self._start_sweeps()
        self.sched.monitor.inject_link_loss(u, v, loss)
        if loss >= 1.0:
            # Total loss blackholes the data plane exactly like link-fault:
            # in-flight shard bytes stop at the fault instant, not at
            # detection. Partial loss inflates the link's data-plane
            # per-byte time by the 1/(1-loss) goodput factor for transfers
            # scheduled from now on (``Network.set_link_loss``, applied by
            # the monitor's injection) — the same model the trainer backend
            # uses — while probes ride the lossy link and may or may not
            # trip the consecutive-failure threshold.
            self._stall_touched(link=(u, v))
        self._fault_seq[("link", (u, v))] = seq
        ledger.append(seq, ev.t, ev.kind, (u, v), "fault-injected",
                      {"loss_rate": loss})

    # -- scheduler fail-over (decentralized control plane) ---------------------

    def _on_scheduler_fault(self, seq: int, ev: ChurnEvent,
                            ledger: EventLedger):
        """The scheduler node fails silently: its monitor dies with it, the
        cluster goes leaderless, and the deputies' ack-watch must detect
        the silence and elect a successor (repro_torch.core.control). The node
        itself is handled like any silent death — streams it carried
        stall, and the *new* leader's sweeps detect it post-election."""
        home = self.sched.node
        if ev.node is not None and ev.node != home:
            # The trace thought someone else was scheduler (e.g. after an
            # earlier fail-over already moved the home).
            ledger.append(seq, ev.t, ev.kind, ev.node, "skipped-not-scheduler",
                          {"home": home})
            return
        if self.control.leaderless or self.sched.monitor.node_faulted(home):
            ledger.append(seq, ev.t, ev.kind, home, "skipped-duplicate-fault")
            return
        self._start_sweeps()
        self.control.preferred_home = ev.new_home
        self.control.inject_scheduler_fault()
        self._stall_touched(node=home)
        if self.ckpt is not None:
            self.ckpt.note_fault()
        self._sched_fault_seq = seq
        self._fault_seq[("node", home)] = seq
        if ev.recovery is not None:
            self._fault_recovery[("node", home)] = ev.recovery
        ledger.append(seq, ev.t, ev.kind, home, "fault-injected",
                      {"deputies": sorted(self.control.replicas)})

    def _on_checkpoint(self, seq: int, ev: ChurnEvent, ledger: EventLedger):
        """Trace-borne checkpoint request: recorded deployments carry their
        real checkpoint instants, so replays reproduce the cadence instead
        of re-deriving it from policy. Without a tier the event is a
        no-op with a terminal record (trace parity)."""
        subject = ev.node if ev.node is not None else self.sched.node
        if self.ckpt is None:
            ledger.append(seq, ev.t, ev.kind, subject,
                          "ckpt-skipped-no-checkpointer")
            return
        self.ckpt.force_push(seq, ledger)

    def _defer_leaderless(self, seq: int, ev: ChurnEvent,
                          ledger: EventLedger):
        """Route an omniscient event that landed in a leaderless window.

        * ``node-failure`` / ``link-failure`` — the world changed whether
          or not anyone is in charge: convert to a pending silent fault
          (streams stall now; the new leader's sweeps detect it later,
          synthesizing the churn under this event's seq).
        * ``link-degrade`` — physics too: the rate changes in place, but
          the credit-aware re-plan is leader work and is skipped (streams
          already scheduled keep their pre-degrade timing).
        * everything else (join / leave / link-join / link-leave) —
          requests that need a leader's grant: parked, re-processed at
          install, refused terminally if the cluster freezes.
        """
        mon = self.sched.monitor
        now = self.cluster.sim.now
        if ev.kind == "node-failure":
            node = ev.node
            info = self.topo.nodes.get(node)
            live = info is not None and info.state in ("active", "standby")
            if not live or mon.node_faulted(node):
                ledger.append(seq, ev.t, ev.kind, node, "skipped-not-active")
                return
            mon.inject_node_fault(node)
            self._stall_touched(node=node)
            if self.ckpt is not None:
                self.ckpt.note_fault()
            self._fault_seq[("node", node)] = seq
            if ev.recovery is not None:
                self._fault_recovery[("node", node)] = ev.recovery
            ledger.append(seq, ev.t, ev.kind, node, "deferred-leaderless",
                          {"as": "node-fault"})
            return
        if ev.kind == "link-failure":
            u, v = min(ev.u, ev.v), max(ev.u, ev.v)
            if not self.topo.has_link(u, v) or mon.link_fault_pending(u, v):
                ledger.append(seq, ev.t, ev.kind, (u, v), "skipped-no-link")
                return
            mon.inject_link_fault(u, v)
            self._stall_touched(link=(u, v))
            self._fault_seq[("link", (u, v))] = seq
            ledger.append(seq, ev.t, ev.kind, (u, v), "deferred-leaderless",
                          {"as": "link-fault"})
            return
        if ev.kind == "link-degrade":
            u, v = ev.u, ev.v
            if not self.topo.has_link(u, v):
                ledger.append(seq, ev.t, ev.kind, (u, v), "skipped-no-link")
                return
            link = self.topo.link(u, v)
            if ev.bandwidth_mbps is not None:
                link.bandwidth_mbps = max(float(ev.bandwidth_mbps),
                                          MIN_LINK_MBPS)
            if ev.latency_s is not None:
                link.latency_s = float(ev.latency_s)
            self.topo.touch()
            ledger.append(seq, ev.t, ev.kind, (u, v), "link-degraded", {
                "bandwidth_mbps": link.bandwidth_mbps,
                "latency_s": link.latency_s,
                "leaderless": True,
            })
            return
        subject = ev.node if ev.node is not None else (ev.u, ev.v)
        self._parked.append((seq, ev))
        ledger.append(seq, ev.t, ev.kind, subject, "deferred-leaderless",
                      {"parked_t": now})

    def _failover_installed(self, result):
        """The election completed: record it, have the new leader re-adopt
        (or rebuild) the in-flight scale-outs, and replay parked requests."""
        ledger = self._ledger
        if ledger is None:
            return  # control plane exercised outside an engine run
        now = self.cluster.sim.now
        seq = self._sched_fault_seq
        ledger.append(seq, now, "scheduler-fault",
                      (result.old_home, result.new_home), "failover", {
                          "term": result.term,
                          "old_home": result.old_home,
                          "new_home": result.new_home,
                          "fault_t": result.fault_t,
                          "detected_t": result.detected_t,
                          "detection_s": result.detection_s,
                          "election_s": result.election_s,
                          "suspicion": result.suspicion,
                          "terms_tried": result.terms_tried,
                          "replica_version": result.replica_version,
                      })
        self.policy.observe("election", result.election_s)
        self.policy.observe("detection", result.detection_s)
        # Re-adoption: the new leader re-evaluates each in-flight recovery
        # under its own measured costs. Adopt (scale-outs in the winner's
        # replica continue untouched, delivered bytes stay credited) or
        # rebuild via a credit-aware re-plan — a scale-out missing from the
        # winner's replica can never be adopted (no plan to adopt).
        known = result.replicated_inflight
        for fl in list(self.inflight):
            jseq = self._inflight_seq.get(fl.new_node, -1)
            ctx = FaultContext(
                kind="re-adoption", t=now, subject=(fl.new_node,),
                n_active=len(self.topo.active_nodes()),
                min_active=self.min_active,
                state_bytes=self.cluster.state_bytes,
                inflight_credit_bytes=fl.credited_bytes(),
                link_mbps=self._link_classes(),
                replicated=fl.new_node in known)
            dec = self.policy.decide(ctx)
            self._record_decision(jseq, ledger, ctx, dec)
            info = self.sched.re_adopt_scale_out(
                fl, adopt=(dec.action is None))
            if info is None:
                self.inflight.remove(fl)
                self._inflight_seq.pop(fl.new_node, None)
                ledger.append(jseq, now, "join", fl.new_node, "aborted",
                              {"delivered_bytes": fl.delivered_bytes()})
                continue
            self._stall_faulted_streams(fl)
            action = ("re-adopted" if info["re_adoption"] == "adopted"
                      else "replanned")
            if action == "replanned":
                info["plan"] = fl.plan.summary()
            ledger.append(jseq, now, "join", fl.new_node, action, info)
        # Parked requests get their day in court under the new leader. The
        # replayed copy carries the install time (honest record timing);
        # the caller's event object is never mutated — the same in-memory
        # trace must replay byte-identically forever.
        # An in-flight reshard began after the winner's last sync — the new
        # leader has no record of it; drop it (holdings keep the old plan).
        self._cancel_reshard(ledger, "failover")
        parked, self._parked = self._parked, []
        for pseq, ev in parked:
            self.handle(pseq, replace(ev, t=now), ledger)
        self._pump(ledger)

    def _detection_detail(self, fault_t: Optional[float],
                          detected_t: float) -> dict:
        det = {"detected_t": detected_t}
        if fault_t is not None:
            det["fault_t"] = fault_t
            det["detection_s"] = detected_t - fault_t
        return det

    def _node_failure_detected(self, node: int, fault_t: Optional[float],
                               detected_t: float):
        """Heartbeat sweep declared ``node`` dead: synthesize the
        node-failure the omniscient trace would have carried, under the
        originating fault's trace seq."""
        if self._ledger is None:
            return  # monitor used outside an engine run
        seq = self._fault_seq.pop(("node", node), -1)
        ev = ChurnEvent(t=detected_t, kind="node-failure", node=node)
        self._detection = self._detection_detail(fault_t, detected_t)
        mon = self.sched.monitor
        if mon.last_suspicion is not None:
            # The phi score that crossed the threshold, alongside the
            # threshold it crossed — the ledger's record of *why* the
            # detector fired, not just when.
            self._detection["suspicion"] = round(mon.last_suspicion, 4)
            self._detection["phi_threshold"] = mon.phi_threshold
        try:
            self._on_leave(seq, ev, self._ledger)
        finally:
            self._detection = None

    def _link_failure_detected(self, u: int, v: int,
                               fault_t: Optional[float], detected_t: float):
        """Probe sweep hit the consecutive-failure threshold on (u, v)."""
        if self._ledger is None:
            return
        seq = self._fault_seq.pop(("link", (min(u, v), max(u, v))), -1)
        ev = ChurnEvent(t=detected_t, kind="link-failure", u=u, v=v)
        self._detection = self._detection_detail(fault_t, detected_t)
        try:
            self._on_link_down(seq, ev, self._ledger)
        finally:
            self._detection = None

    def _fault_cleared(self, kind: str, subject: Tuple, fault_t: float):
        """A pending fault became moot before detection — its subject was
        removed by other churn (the faulted node left, the faulted link's
        endpoint died, the link was reconnected). Close the fault's ledger
        trail so every injected fault reaches a terminal record."""
        if self._ledger is None:
            return
        key = (("node", subject[0]) if kind == "node-fault"
               else ("link", tuple(subject)))
        seq = self._fault_seq.pop(key, -1)
        self._ledger.append(seq, self.cluster.sim.now, kind, subject,
                            "fault-cleared", {"fault_t": fault_t})


def run_trace_sim(cluster: SimCluster, events: Iterable[ChurnEvent],
                  *, min_active: int = 2,
                  solver_charge_s=SimBackend.DEFAULT_SOLVER_CHARGE_S,
                  partial_credit: bool = True, detection_seed: int = 0,
                  detector: str = "phi",
                  codec: str = wire_codec.CODEC_NONE,
                  checkpoint: Optional[str] = None,
                  ckpt_interval_s: Optional[float] = None,
                  policy="fixed",
                  accounting: bool = False,
                  reshard: str = "never",
                  reshard_policy: Optional[ReshardPolicy] = None,
                  ) -> Tuple[EventLedger, Dict[int, object]]:
    """Replay a churn trace through the engine on a simulated cluster."""
    engine = ChurnEngine(SimBackend(cluster, min_active=min_active,
                                    solver_charge_s=solver_charge_s,
                                    partial_credit=partial_credit,
                                    detection_seed=detection_seed,
                                    detector=detector, codec=codec,
                                    checkpoint=checkpoint,
                                    ckpt_interval_s=ckpt_interval_s,
                                    policy=policy, accounting=accounting,
                                    reshard=reshard,
                                    reshard_policy=reshard_policy))
    ledger = engine.run(events)
    return ledger, engine.results


def run_trace_goodput(cluster: SimCluster, events: Iterable[ChurnEvent],
                      **kw) -> Tuple[EventLedger, Dict[int, object],
                                     GoodputReport]:
    """:func:`run_trace_sim` with accounting forced on; returns the
    GoodPut report alongside the ledger and per-event results."""
    kw["accounting"] = True
    backend = SimBackend(cluster, **kw)
    engine = ChurnEngine(backend)
    ledger = engine.run(events)
    return ledger, engine.results, backend.goodput
