"""The churn-event pipeline, from ``repro/core/engine.py``: events, the
deterministic ledger and the engine loop that drives a backend.

* ``ChurnEvent`` — one churn occurrence (join / leave / node-failure /
  link events / silent faults / scheduler-fault / checkpoint),
  JSON-serializable; scenario traces (``repro_torch.scenarios``) are
  ordered lists of these, in the same JSONL format as the JAX package's.
* ``EventLedger`` — the deterministic record of what the pipeline did with
  each event. Same trace ⇒ byte-identical ledger (``canonical_bytes``).
* ``ChurnEngine`` — pulls events in scenario-time order and drives a
  backend; the port's backend is ``repro_torch.elastic.TrainerBackend``,
  which replays a trace against the real ``ElasticTrainer``.

Not ported here: ``SimBackend`` and the simulator entry points that follow
it in the JAX module (``run_trace_sim``, ``run_trace_goodput``); they need
the decentralized control plane (``repro/core/control.py``), which is not
ported yet. ``ChurnEvent.link_objects`` builds the port's ``topology.Link``
objects for the simulator (``core.negotiation.SimCluster``).
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.core.plans import RESHARD_MODES
from repro_torch.core.recovery import RECOVERY_ACTIONS
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
    produced (the trainer backend's ``ScaleEvent``).
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
