"""GoodPut/BadPut accounting over the churn ledger, from
``repro/core/goodput.py`` (its ledger part).

:func:`goodput_report` classifies every instant of a run's wall-clock
window into exactly one category, post hoc, from the
:class:`~repro_torch.core.engine.EventLedger` records — the ``fault_t`` /
``detected_t`` / ``election_s`` / ``blocking_s`` / ``decode_s`` fields the
pipeline writes. The report is a pure function of the ledger plus the
``[t_start, t_end]`` window, so computing it cannot change a ledger byte.

Interval taxonomy (highest priority first; overlapping windows resolve to
the highest-priority label, so the categories partition the window and sum
to ``t_end - t_start``): ``election``, ``detection``, ``leaderless``,
``lost``, ``checkpoint``, ``replication``, ``decode``, ``handling``, and
``productive`` — everything else, the GoodPut. The JAX module's docstring
defines each window.

:func:`optimal_interval` is the Unicron-style cadence optimum
``sqrt(2 * ckpt_cost / fault_rate)``, clamped to ``[CKPT_MIN_INTERVAL_S,
CKPT_MAX_INTERVAL_S]``.

Every float expression and summation order (``math.fsum`` where the JAX
module uses it, the same rounding in :meth:`GoodputReport.to_json`) is the
JAX module's, so the same ledger gives byte-identical reports in both
packages.

:class:`SimCheckpointTier` is the simulator's checkpoint tier: periodic
pushes that ride the simulated network as contending transfers
(``simulator.TransferHandle``), a fixed or churn-adaptive cadence, and the
ledgered restore paths ``SimBackend`` runs on a node failure.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.core.simulator import TransferHandle

# -- interval taxonomy -------------------------------------------------------

#: classification priority, highest first: an instant covered by several
#: candidate windows takes the first matching label. "productive" is the
#: complement and never appears in a candidate window.
PRIORITY = ("election", "detection", "leaderless", "lost", "checkpoint",
            "replication", "decode", "handling")
CATEGORIES = PRIORITY + ("productive",)


def _clamp(t0: float, t1: float, lo: float, hi: float):
    a, b = max(float(t0), lo), min(float(t1), hi)
    return (a, b) if b > a else None


def ledger_intervals_attributed(
        ledger, *, t_start: float,
        t_end: float) -> List[Tuple[float, float, str, int, Tuple]]:
    """Extract labeled candidate BadPut windows from ledger records, each
    attributed to the ``(seq, subject)`` of the record that caused it.

    Pure read: consumes only fields the engine already writes. Windows may
    overlap freely (e.g. detection inside a leaderless span); the sweep in
    :func:`classify` resolves overlaps by :data:`PRIORITY`. The attribution
    is what lets ``repro_torch.core.telemetry`` hang each window under its event's
    span without re-deriving (and possibly disagreeing about) the timing.
    """
    out: List[Tuple[float, float, str, int, Tuple]] = []

    def add(t0, t1, cat, seq, subject):
        iv = _clamp(t0, t1, t_start, t_end)
        if iv is not None:
            out.append((iv[0], iv[1], cat, seq, subject))

    # Replication rework: for each join, every replanned record opens a
    # rework window that closes at the join's terminal record.
    joins: Dict[Tuple, Dict[str, list]] = {}
    for r in ledger:
        if r.kind != "join":
            continue
        g = joins.setdefault((r.seq, r.subject), {"replans": [], "end": []})
        if r.action == "replanned":
            g["replans"].append(r.t)
        elif r.action in ("ready", "aborted"):
            g["end"].append(r.t)
    for (seq, subject), g in joins.items():
        terminal = max(g["end"]) if g["end"] else t_end
        for t_r in g["replans"]:
            add(t_r, terminal, "replication", seq, subject)

    for r in ledger:
        d = r.detail
        fault_t = d.get("fault_t")
        detected_t = d.get("detected_t")
        if fault_t is not None and detected_t is not None:
            add(fault_t, detected_t, "detection", r.seq, r.subject)
        elif fault_t is not None and r.action in (
                "fault-undetected", "fault-cleared", "election-no-quorum"):
            # The fault was live (streams stalled, probes burning) until the
            # monitor gave up or other churn mooted it.
            add(fault_t, r.t, "detection", r.seq, r.subject)
        if r.action == "failover":
            if fault_t is not None:
                add(fault_t, r.t, "leaderless", r.seq, r.subject)
            if detected_t is not None and d.get("election_s") is not None:
                add(detected_t, detected_t + d["election_s"], "election",
                    r.seq, r.subject)
        elif r.action == "election-no-quorum":
            # No quorum anywhere: leaderless from the fault to the give-up,
            # and the frozen cluster stays unproductive to the end.
            if fault_t is not None:
                add(fault_t, r.t, "leaderless", r.seq, r.subject)
            add(r.t, t_end, "leaderless", r.seq, r.subject)
        if d.get("blocking_s"):
            add(r.t, r.t + d["blocking_s"], "handling", r.seq, r.subject)
        if r.action == "ready" and d.get("decode_s"):
            add(r.t - d["decode_s"], r.t, "decode", r.seq, r.subject)
        if r.action == "ckpt-started":
            add(r.t, r.t + d.get("snapshot_s", 0.0), "checkpoint",
                r.seq, r.subject)
        elif r.action == "ckpt-restored":
            if d.get("restore_s"):
                add(r.t - d["restore_s"], r.t, "checkpoint", r.seq, r.subject)
            lf, lt = d.get("lost_from"), d.get("lost_to")
            if lf is not None and lt is not None:
                add(lf, lt, "lost", r.seq, r.subject)
    return out


def ledger_intervals(ledger, *, t_start: float,
                     t_end: float) -> List[Tuple[float, float, str]]:
    """Labeled candidate BadPut windows — the attribution-free projection of
    :func:`ledger_intervals_attributed` (identical windows, same order)."""
    return [(a, b, cat) for a, b, cat, _seq, _subject in
            ledger_intervals_attributed(ledger, t_start=t_start, t_end=t_end)]


def classify(intervals: List[Tuple[float, float, str]], *, t_start: float,
             t_end: float) -> Dict[str, float]:
    """Sweep-line partition of ``[t_start, t_end]`` into category totals.

    Every elementary segment between consecutive interval boundaries takes
    the highest-priority label covering it (or "productive" when none
    does), so the returned components are non-negative and sum to the total
    wall-clock up to float summation error.
    """
    rank = {c: i for i, c in enumerate(PRIORITY)}
    clamped = []
    for t0, t1, cat in intervals:
        iv = _clamp(t0, t1, t_start, t_end)
        if iv is not None:
            clamped.append((iv[0], iv[1], cat))
    intervals = clamped
    pts = sorted({t_start, t_end,
                  *(p for iv in intervals for p in iv[:2])})
    parts: Dict[str, List[float]] = {c: [] for c in CATEGORIES}
    for a, b in zip(pts, pts[1:]):
        if b <= a:
            continue
        best: Optional[str] = None
        for t0, t1, cat in intervals:
            if t0 < b and t1 > a and (best is None or rank[cat] < rank[best]):
                best = cat
        parts[best if best is not None else "productive"].append(b - a)
    return {c: math.fsum(parts[c]) for c in CATEGORIES}


@dataclass
class GoodputReport:
    """Per-category virtual seconds for one run. ``components`` partition
    ``[t_start, t_end]``; ``goodput_fraction`` is the paper's bottom line."""
    t_start: float
    t_end: float
    components: Dict[str, float]

    @property
    def total_s(self) -> float:
        return self.t_end - self.t_start

    @property
    def goodput_s(self) -> float:
        return self.components["productive"]

    @property
    def badput_s(self) -> float:
        return math.fsum(v for c, v in self.components.items()
                         if c != "productive")

    @property
    def goodput_fraction(self) -> float:
        return self.goodput_s / self.total_s if self.total_s > 0 else 1.0

    def to_json(self) -> dict:
        """Deterministic (same seed ⇒ byte-identical once dumped with sorted
        keys): virtual times only, rounded to dodge fsum order jitter."""
        return {
            "t_start": round(self.t_start, 9),
            "t_end": round(self.t_end, 9),
            "goodput_fraction": round(self.goodput_fraction, 9),
            "components": {c: round(v, 9)
                           for c, v in sorted(self.components.items())},
        }


def goodput_report(ledger, *, t_start: float, t_end: float) -> GoodputReport:
    """Classify a run's wall-clock from its ledger. Pure read — calling this
    (or running with ``accounting=True``) cannot change a ledger byte."""
    t_end = max(float(t_end), float(t_start))
    ivs = ledger_intervals(ledger, t_start=t_start, t_end=t_end)
    return GoodputReport(float(t_start), t_end,
                         classify(ivs, t_start=float(t_start), t_end=t_end))


# -- checkpoint cadence policy ----------------------------------------------

#: synchronous device→host snapshot charge per checkpoint push — the part
#: that stalls training (the async disk/network write overlaps, CheckFreq
#: style). This is exactly what the accounting charges per ``ckpt-started``.
CKPT_SNAPSHOT_S = 0.25
#: fixed-cadence baseline interval (virtual seconds).
CKPT_BASE_INTERVAL_S = 30.0
#: adaptive clamp: never checkpoint more often than this...
CKPT_MIN_INTERVAL_S = 1.0
#: ...nor wait longer than this (also the no-faults-yet fallback).
CKPT_MAX_INTERVAL_S = 600.0
#: back-off before resuming a churn-cancelled push.
CKPT_RETRY_S = 0.5


def optimal_interval(ckpt_cost_s: float, fault_rate_hz: float, *,
                     lo: float = CKPT_MIN_INTERVAL_S,
                     hi: float = CKPT_MAX_INTERVAL_S) -> float:
    """Unicron-style optimal checkpoint interval.

    BadPut per unit time under interval ``T`` is ``cost/T`` (snapshot
    stalls) plus ``rate * T/2`` (expected work lost back to the last
    checkpoint per fault); minimizing gives ``T* = sqrt(2*cost/rate)``.
    Monotone: higher fault rate or lower cost ⇒ shorter interval. With no
    observed faults the optimum diverges and clamps to ``hi``.
    """
    if ckpt_cost_s <= 0.0 or fault_rate_hz <= 0.0:
        return hi
    return min(max(math.sqrt(2.0 * ckpt_cost_s / fault_rate_hz), lo), hi)


class SimCheckpointTier:
    """Periodic checkpoint pushes riding the simulated network, wired into
    ``SimBackend`` (``checkpoint="fixed"|"adaptive"``).

    Each push charges a synchronous snapshot stall, then streams the state
    bytes from the scheduler home to a deterministically chosen holder as a
    *contending* data transfer. Churn touching the push's route (or either
    endpoint) cancels it with the same shard-aligned credit replication
    streams get — the credited prefix survives on the holder and the resumed
    push moves only the missing bytes. On a node failure the tier executes
    whichever restore action the backend's recovery policy chose
    (:meth:`restore`): ``restore-replica`` re-seeds from neighbor replicas
    for free (synchronous-DP state survives — the paper's §III premise),
    ``restore-checkpoint`` pays a restore read from the holder plus all work
    since the last completed checkpoint (``lost`` BadPut). The tier decides
    nothing — selection lives in ``repro_torch.core.recovery``.

    Every started push reaches exactly one terminal record
    (``ckpt-complete`` / ``ckpt-cancelled``); all records use the
    ``"checkpoint"`` ledger kind.
    """

    def __init__(self, backend, *, cadence: str = "adaptive",
                 interval_s: Optional[float] = None,
                 snapshot_s: float = CKPT_SNAPSHOT_S):
        if cadence not in ("fixed", "adaptive"):
            raise ValueError(f"unknown checkpoint cadence {cadence!r}")
        self.backend = backend
        self.cluster = backend.cluster
        self.cadence = cadence
        self.snapshot_s = float(snapshot_s)
        self.base_interval_s = float(CKPT_BASE_INTERVAL_S
                                     if interval_s is None else interval_s)
        self.interval_s = self.base_interval_s
        self.t0 = self.sim.now
        #: observed node-failure arrivals (the events a restore must cover).
        self.faults = 0
        self.completed = 0
        self.cancelled = 0
        self._costs: List[float] = []  # measured per-push stall charges
        self._push: Optional[dict] = None
        self._epoch = 0
        self._carry = 0  # credited bytes surviving a cancelled push
        self.last_ckpt: Optional[dict] = None  # {"t", "holder"}
        self._cold_base = self.sim.now  # lost-work floor before any ckpt
        self._gen = 0
        self._closed = False
        self._schedule_fire(self.interval_s)

    # -- plumbing ------------------------------------------------------------

    @property
    def sim(self):
        return self.cluster.sim

    @property
    def net(self):
        return self.cluster.net

    @property
    def topo(self):
        return self.cluster.topo

    @property
    def sched(self):
        return self.cluster.scheduler

    @property
    def _ledger(self):
        return self.backend._ledger

    def fault_rate_hz(self) -> float:
        elapsed = self.sim.now - self.t0
        return self.faults / elapsed if elapsed > 0 else 0.0

    def measured_cost_s(self) -> float:
        return (math.fsum(self._costs) / len(self._costs)
                if self._costs else self.snapshot_s)

    def current_interval(self) -> float:
        if self.cadence == "fixed":
            return self.base_interval_s
        if self.faults == 0:
            # No evidence yet: the adaptive prior is the fixed baseline
            # (never worse than it before the first measured fault).
            return self.base_interval_s
        return optimal_interval(self.measured_cost_s(), self.fault_rate_hz(),
                                hi=max(CKPT_MAX_INTERVAL_S,
                                       self.base_interval_s))

    def note_fault(self):
        """A node failure arrived (silent injection or omniscient handling):
        the arrival-rate input to the adaptive cadence."""
        self.faults += 1

    # -- the push cycle ------------------------------------------------------

    def _schedule_fire(self, dt: float):
        if self._closed:
            return
        self._gen += 1
        gen = self._gen
        self.sim.at(self.sim.now + max(float(dt), 1e-6),
                    lambda: self._scheduled_fire(gen), daemon=True)

    def _scheduled_fire(self, gen: int):
        if gen != self._gen or self._closed or self._ledger is None:
            return
        if self._push is not None or self.backend.control.leaderless \
                or self.backend.control.frozen:
            # A push still in flight (interval shorter than the wire time)
            # or no leader to coordinate one: try again shortly.
            self._schedule_fire(CKPT_RETRY_S)
            return
        self._fire(-1)

    def force_push(self, seq: int, ledger) -> None:
        """A trace-borne ``checkpoint`` event: push now, under the event's
        seq, so recorded cadences replay verbatim."""
        if self._push is not None:
            ledger.append(seq, self.sim.now, "checkpoint", self.sched.node,
                          "ckpt-skipped-inflight", {"epoch": self._epoch})
            return
        self._fire(seq)

    def _pick_holder(self, home: int) -> Optional[int]:
        """Deterministic holder: the directly linked active node with the
        fastest link to home (ties to the lowest id), else the lowest-id
        reachable node."""
        others = [n for n in self.topo.active_nodes() if n != home]
        linked = [n for n in others if self.topo.has_link(home, n)]
        if linked:
            return max(linked, key=lambda n: (
                self.topo.link(home, n).bandwidth_mbps, -n))
        for n in sorted(others):
            if self.topo.has_path(home, n):
                return n
        return None

    def _fire(self, seq: int):
        now = self.sim.now
        home = self.sched.node
        holder = self._pick_holder(home)
        if holder is None:
            if seq >= 0:
                self._ledger.append(seq, now, "checkpoint", home,
                                    "ckpt-skipped-no-holder")
            else:
                self._schedule_fire(CKPT_RETRY_S)
            return
        self.interval_s = self.current_interval()
        remaining = max(0, int(self.cluster.state_bytes) - self._carry)
        shard = (int(max(self.cluster.tensor_sizes))
                 if len(self.cluster.tensor_sizes) else 0)
        self._epoch += 1
        handle = TransferHandle()
        push = {"handle": handle, "home": home, "holder": holder,
                "route": self.topo.shortest_path(home, holder,
                                                 max(remaining, 1)),
                "t0": now, "bytes": remaining, "shard": shard,
                "epoch": self._epoch, "seq": seq}
        self._push = push
        self._ledger.append(seq, now, "checkpoint", home, "ckpt-started", {
            "holder": holder, "bytes": remaining,
            "credited_bytes": int(self._carry),
            "snapshot_s": self.snapshot_s,
            "interval_s": round(self.interval_s, 6),
            "cadence": self.cadence, "epoch": self._epoch,
        })

        def launch():
            # Superseded or killed during the snapshot window: the terminal
            # record comes from the cancellation path, not from here.
            if push is not self._push or handle.cancelled or handle.stalled:
                return
            self.net.transfer(push["route"], max(push["bytes"], 1),
                              lambda t: self._complete(push, t),
                              handle=handle)

        # The stall charge delays the first byte; the wire time overlaps
        # training (the accounting charges only the snapshot window).
        self.sim.at(now + self.snapshot_s, launch)

    def _complete(self, push: dict, t: float):
        if push is not self._push:
            return
        self._push = None
        self.completed += 1
        self._costs.append(self.snapshot_s)
        self.backend.policy.observe("snapshot", self.snapshot_s)
        self._carry = 0
        self.last_ckpt = {"t": t, "holder": push["holder"]}
        if self._ledger is not None:
            self._ledger.append(push["seq"], t, "checkpoint", push["home"],
                                "ckpt-complete", {
                                    "holder": push["holder"],
                                    "bytes": push["bytes"],
                                    "push_s": t - push["t0"],
                                    "epoch": push["epoch"],
                                })
        self.interval_s = self.current_interval()
        self._schedule_fire(self.interval_s)

    def _cancel_push(self, now: float, *, holder_lost: bool, reason: str,
                     resume: bool = True):
        push, self._push = self._push, None
        self.cancelled += 1
        h = push["handle"]
        h.cancel(now)
        delivered = int(h.cancelled_delivered)
        shard = push["shard"]
        credited = (delivered // shard) * shard if shard > 0 else delivered
        if holder_lost:
            # The holder died with the shards it held: nothing survives.
            self._carry, credited = 0, 0
        else:
            self._carry += credited
        if self._ledger is not None:
            self._ledger.append(push["seq"], now, "checkpoint", push["home"],
                                "ckpt-cancelled", {
                                    "holder": push["holder"],
                                    "delivered_bytes": delivered,
                                    "credited_bytes": credited,
                                    "epoch": push["epoch"],
                                    "reason": reason,
                                })
        if resume:
            self._schedule_fire(CKPT_RETRY_S)

    # -- churn hooks (mirroring the replication stream hooks) ----------------

    def _touches(self, push: dict, *, node=None, link=None) -> bool:
        if node is not None:
            return (node == push["holder"] or node == push["home"]
                    or node in push["route"])
        key = (min(link), max(link))
        return any((min(a, b), max(a, b)) == key
                   for a, b in zip(push["route"], push["route"][1:]))

    def stall_if_touched(self, *, node=None, link=None):
        """A silent fault froze the push stream: bytes stop now, the
        detection-triggered churn later cancels and credits the prefix."""
        push = self._push
        if push is not None and self._touches(push, node=node, link=link):
            push["handle"].stall(self.sim.now)

    def on_node_event(self, seq: int, node: int, *, failure: bool,
                      omniscient: bool):
        """A node left the cluster (graceful or failed, omniscient or
        detected). Credit any touched push and drop holder state; the
        engine executes the policy-chosen restore separately
        (:meth:`restore`)."""
        now = self.sim.now
        if failure and omniscient:
            # Detected failures were counted at fault injection.
            self.note_fault()
        if self._push is not None and self._touches(self._push, node=node):
            self._cancel_push(now, holder_lost=(node == self._push["holder"]),
                              reason="node-churn")
        if self.last_ckpt is not None and self.last_ckpt["holder"] == node:
            # The durable copy died with its holder; the next restore is
            # cold until a fresh push completes.
            self.last_ckpt = None

    def on_link_event(self, link: Tuple[int, int]):
        """A route link died or changed rate mid-push: cancel with credit
        and resume the missing bytes over the current topology."""
        if self._push is not None and self._touches(self._push, link=link):
            self._cancel_push(self.sim.now, holder_lost=False,
                              reason="link-churn")

    # -- recovery ------------------------------------------------------------

    def restore(self, seq: int, dead_node: int, action: str):
        """Execute the restore action the recovery policy chose for a node
        failure (``restore-replica`` / ``restore-checkpoint``). Measured
        restore and lost-work costs feed straight back into the policy's
        online cost model — the calibration loop Chameleon prescribes."""
        if action not in ("restore-replica", "restore-checkpoint"):
            raise ValueError(f"unknown restore action {action!r}")
        now = self.sim.now
        if self._ledger is None:
            return
        if action == "restore-replica":
            # Synchronous-DP state survives on the neighbor replicas
            # (MemoryReplicaStore tier): nothing is lost, nothing is read
            # back — the record exists so the A/B against checkpoint
            # recovery is visible in the same ledger vocabulary.
            self._ledger.append(seq, now, "checkpoint", dead_node,
                                "replica-restored",
                                {"restore_s": 0.0, "lost_s": 0.0})
            return
        lk = self.last_ckpt
        home = self.sched.node
        if (lk is None or lk["holder"] not in self.topo.nodes
                or not self.topo.has_path(lk["holder"], home)):
            # No durable checkpoint reachable: everything since the last
            # cold base is gone.
            lost_from = self._cold_base
            self._ledger.append(seq, now, "checkpoint", dead_node,
                                "ckpt-restored", {
                                    "restore_s": 0.0,
                                    "lost_s": now - lost_from,
                                    "lost_from": lost_from, "lost_to": now,
                                    "cold": True,
                                })
            self.backend.policy.observe("lost", now - lost_from)
            self._cold_base = now
            return
        nbytes = max(int(self.cluster.state_bytes), 1)
        route = self.topo.shortest_path(lk["holder"], home, nbytes)
        lost_from = lk["t"]

        def done(t, seq=seq, dead=dead_node, holder=lk["holder"],
                 t_req=now, lost_from=lost_from):
            if self._ledger is not None:
                self._ledger.append(seq, t, "checkpoint", dead,
                                    "ckpt-restored", {
                                        "restore_s": t - t_req,
                                        "lost_s": t_req - lost_from,
                                        "lost_from": lost_from,
                                        "lost_to": t_req,
                                        "holder": holder,
                                    })
            self.backend.policy.observe("restore-checkpoint", t - t_req)
            self.backend.policy.observe("lost", t_req - lost_from)

        # Contending, non-daemon: the restore read is real recovery work
        # and must drain before the run ends.
        self.net.transfer(route, nbytes, done)

    # -- shutdown ------------------------------------------------------------

    def finalize(self, ledger):
        """End of drain: close any still-open push with a credited terminal
        record so every ``ckpt-started`` reaches exactly one terminal."""
        self._closed = True
        self._gen += 1
        if self._push is not None:
            self._cancel_push(self.sim.now, holder_lost=False,
                              reason="drain", resume=False)
