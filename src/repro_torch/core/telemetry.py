"""Causal span tracing, Chrome/Perfetto export and metrics exposition over
the churn ledger, from ``repro/core/telemetry.py``.

A finished :class:`~repro_torch.core.engine.EventLedger` becomes three
derived artifacts:

1. **Span forest** (:func:`build_spans`): each trace event's records
   stitched into a causal span tree, with flow links across seqs and a
   well-formedness contract (:func:`validate`). The BadPut children are the
   GoodPut classifier's own windows
   (:func:`repro_torch.core.goodput.ledger_intervals_attributed`), so
   ``classify(forest.intervals) == goodput_report(ledger).components``
   exactly.
2. **Chrome/Perfetto export** (:func:`trace_events`,
   :func:`write_chrome_trace`): ``trace_event`` JSON on the ledger's clock,
   with per-node and per-link tracks and flow arrows.
3. **Metrics** (:class:`MetricsRegistry` and the ``collect_*`` helpers):
   counters, gauges and histograms with a deterministic Prometheus text
   exposition.

Everything here is a pure post-hoc read of a finished ledger plus
point-in-time counter snapshots. :func:`span_digest` projects each event
root to ``(seq, kind, normalized subject, fate)``, so the simulator's and
the trainer's replays of one trace hash identically.

Every float expression, summation order, ``_fmt`` and ``json.dumps``
argument is the JAX module's: the same ledger gives byte-identical
digests, Chrome traces, markdown and exposition in both packages.

``collect_network``, ``collect_monitor``, ``collect_control`` and
``collect_backend`` scrape the simulator's network, monitor, control plane
and ``SimBackend``; ``collect_trainer_backend`` is the trainer's
counterpart. ``collect_spans``, which the JAX module has not, exposes the
port's live spans (``repro_torch.spans`` records, on the wall clock).
"""
from __future__ import annotations

import hashlib
import json
import math
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.core.goodput import (
    CATEGORIES,
    classify,
    goodput_report,
    ledger_intervals_attributed,
)

# ---------------------------------------------------------------------------
# Span model
# ---------------------------------------------------------------------------


@dataclass
class Span:
    """One node of the span forest. ``cat`` is ``"event"`` for roots,
    a GoodPut category for BadPut children, or ``"lifecycle"`` for the
    training-overlapped windows (replication stream, reshard fetches,
    checkpoint push) that the accounting deliberately does not charge."""
    name: str
    cat: str
    t0: float
    t1: float
    seq: int
    subject: Tuple
    attrs: Dict = field(default_factory=dict)
    children: List["Span"] = field(default_factory=list)

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0

    def walk(self) -> Iterable["Span"]:
        yield self
        for c in self.children:
            yield from c.walk()


@dataclass
class SpanForest:
    """The stitched view of one replay: event roots (plus lost-work and
    cadence-checkpoint roots), the raw attributed BadPut windows the
    children were built from, cross-seq flow links, and the per-event rows
    benchmarks consume."""
    t_start: float
    t_end: float
    roots: List[Span] = field(default_factory=list)
    #: raw ``(t0, t1, cat, seq, subject)`` windows, exactly as the GoodPut
    #: classifier sees them — conservation is checked against these, not
    #: against the merged child spans.
    intervals: List[Tuple[float, float, str, int, Tuple]] = \
        field(default_factory=list)
    #: cross-seq causal links: {"src": i, "dst": j, "t_src", "t_dst",
    #: "label"} with i/j indices into ``roots``.
    flows: List[Dict] = field(default_factory=list)
    #: per-event detection/handling rows (the single source of truth the
    #: benchmarks' ``detection_rows`` delegates to).
    rows: List[Dict] = field(default_factory=list)

    def spans(self) -> Iterable[Span]:
        for r in self.roots:
            yield from r.walk()

    def badput_components(self) -> Dict[str, float]:
        """Classify this forest's own windows — bit-identical to
        ``goodput_report(ledger).components`` for the same ledger/window."""
        ivs = [(a, b, c) for (a, b, c, _s, _subj) in self.intervals]
        return classify(ivs, t_start=self.t_start, t_end=self.t_end)


# -- ledger-record vocabulary ------------------------------------------------

#: actions that open a lifecycle, mapped to the set of actions that may
#: close it. Well-formedness: each opener reaches *exactly one* terminal
#: within its group (see :func:`validate`).
_JOIN_TERMINALS = frozenset({"ready", "aborted"})
_RESHARD_TERMINALS = frozenset({"reshard-ready", "reshard-cancelled"})
_CKPT_TERMINALS = frozenset({"ckpt-complete", "ckpt-cancelled"})
_FAULT_TERMINALS = {
    "node-fault": frozenset({
        "node-failed", "aborted-inflight-join", "skipped-not-active",
        "skipped-scheduler-node", "skipped-min-cluster", "fault-undetected",
        "fault-cleared"}),
    "link-fault": frozenset({
        "link-failed", "skipped-no-link", "fault-undetected",
        "fault-cleared"}),
    "link-loss": frozenset({
        "link-failed", "skipped-no-link", "fault-undetected",
        "fault-cleared"}),
    "scheduler-fault": frozenset({"failover", "election-no-quorum"}),
}

#: record actions whose handling re-plans other seqs' in-flight work — flow
#: sources for same-instant ``replanned`` / ``re-adopted`` / ``aborted`` /
#: ``*-cancelled`` records on a different seq.
_FLOW_CAUSES = frozenset({
    "node-failed", "scaled-in", "link-failed", "link-disconnected",
    "link-degraded", "link-restored", "link-connected", "failover",
})
_FLOW_EFFECTS = frozenset({
    "replanned", "re-adopted", "aborted", "reshard-replanned",
    "reshard-cancelled", "ckpt-cancelled",
})


def _record_window(r) -> Tuple[float, float]:
    """The time extent a single record contributes to its root span."""
    d = r.detail
    t0 = t1 = float(r.t)
    for key in ("fault_t", "detected_t"):
        v = d.get(key)
        if v is not None:
            t0 = min(t0, float(v))
    if d.get("restore_s"):
        t0 = min(t0, r.t - float(d["restore_s"]))
    if d.get("decode_s"):
        t0 = min(t0, r.t - float(d["decode_s"]))
    if d.get("blocking_s"):
        t1 = max(t1, r.t + float(d["blocking_s"]))
    if r.action == "ckpt-started":
        t1 = max(t1, r.t + float(d.get("snapshot_s", 0.0)))
    if r.action == "failover" and d.get("detected_t") is not None \
            and d.get("election_s") is not None:
        t1 = max(t1, float(d["detected_t"]) + float(d["election_s"]))
    return t0, t1


def _merge_windows(windows: List[Tuple[float, float]]) \
        -> List[Tuple[float, float, int]]:
    """Merge overlapping/touching windows; returns (t0, t1, n_merged)."""
    out: List[List] = []
    for a, b in sorted(windows):
        if out and a <= out[-1][1] + 1e-12:
            out[-1][1] = max(out[-1][1], b)
            out[-1][2] += 1
        else:
            out.append([a, b, 1])
    return [(a, b, n) for a, b, n in out]


def _detection_row(r) -> Dict:
    return {
        "kind": r.kind,
        "subject": tuple(r.subject) if isinstance(r.subject, (tuple, list))
        else (r.subject,),
        "fault_t": r.detail.get("fault_t"),
        "detected_t": r.detail.get("detected_t"),
        "detection_s": r.detail.get("detection_s", 0.0),
        "handling_s": r.detail.get("blocking_s", 0.0),
    }


_FAULT_CLASS = {
    "node-failed": "node-failure",
    "link-failed": "link-failure",
    "failover": "scheduler-failure",
}


def _ttr_row(r) -> Optional[Dict]:
    """Time-to-recovery for a handled *failure* record: from the fault
    instant (injection time when known, else the handling instant) to the
    end of the blocking handling window. Replication rework and restore
    reads overlap training and are accounted separately (GoodPut
    categories), exactly as the paper's sub-20 ms handling claim scopes."""
    cls = _FAULT_CLASS.get(r.action)
    if cls is None:
        return None
    d = r.detail
    blocking = float(d.get("blocking_s", 0.0) or 0.0)
    fault_t = d.get("fault_t")
    ttr = (r.t + blocking - float(fault_t)) if fault_t is not None \
        else blocking
    return {
        "fault_class": cls,
        "kind": r.kind,
        "subject": tuple(r.subject) if isinstance(r.subject, (tuple, list))
        else (r.subject,),
        "ttr_s": ttr,
        "detection_s": float(d.get("detection_s", 0.0) or 0.0),
        "handling_s": blocking,
    }


# ---------------------------------------------------------------------------
# Span builder
# ---------------------------------------------------------------------------


def build_spans(ledger, *, t_start: Optional[float] = None,
                t_end: Optional[float] = None) -> SpanForest:
    """Stitch a finished ledger into a :class:`SpanForest`. Pure read."""
    records = list(ledger)
    if t_start is None:
        t_start = min((min(_record_window(r)) for r in records), default=0.0)
    if t_end is None:
        t_end = max((max(_record_window(r)) for r in records),
                    default=float(t_start))
    t_start, t_end = float(t_start), max(float(t_end), float(t_start))

    # Group: seq >= 0 by seq; cadence checkpoint records (seq == -1) by
    # their push epoch (each ckpt-started..terminal pair is its own root).
    by_seq: Dict[int, List] = {}
    cadence: Dict[Tuple, List] = {}
    for i, r in enumerate(records):
        if r.seq >= 0:
            by_seq.setdefault(r.seq, []).append(r)
        else:
            key = ("epoch", r.detail.get("epoch", ("rec", i)))
            cadence.setdefault(key, []).append(r)

    forest = SpanForest(t_start=t_start, t_end=t_end)
    forest.intervals = ledger_intervals_attributed(
        ledger, t_start=t_start, t_end=t_end)

    root_of: Dict[int, int] = {}  # seq -> index into forest.roots

    def _mk_root(recs: List, seq: int) -> Span:
        first = recs[0]
        lo = min(_record_window(r)[0] for r in recs)
        hi = max(_record_window(r)[1] for r in recs)
        subject = (tuple(first.subject)
                   if isinstance(first.subject, (tuple, list))
                   else (first.subject,))
        # Roots are NOT clamped to [t_start, t_end]: trace-borne record
        # times can predate the accounting window (events stamped with
        # trace time while the cluster warmed up) — the window bounds the
        # conservation check, not the span extents.
        span = Span(name=f"{first.kind} {first.subject}", cat="event",
                    t0=lo, t1=max(hi, lo), seq=seq, subject=subject)
        span.attrs["kind"] = first.kind
        span.attrs["actions"] = [(round(r.t, 9), r.action) for r in recs]
        span.attrs["fate"] = _root_fate(first.kind, [r.action for r in recs])
        return span

    # -- event roots (one per seq, in first-record order) --------------------
    for seq in sorted(by_seq):
        recs = by_seq[seq]
        span = _mk_root(recs, seq)
        # Lifecycle children: the training-overlapped windows.
        for opener, terms, nm in (
                ("scale-out-started", _JOIN_TERMINALS, "replication-stream"),
                ("reshard-started", _RESHARD_TERMINALS, "reshard-fetch"),
                ("ckpt-started", _CKPT_TERMINALS, "ckpt-push")):
            opens = [r for r in recs if r.action == opener]
            closes = [r for r in recs if r.action in terms]
            for o, c in zip(opens, closes):
                child = Span(name=nm, cat="lifecycle", t0=o.t, t1=c.t,
                             seq=seq, subject=span.subject,
                             attrs={"terminal": c.action})
                if "moved_bytes" in c.detail:
                    child.attrs["moved_bytes"] = c.detail["moved_bytes"]
                span.children.append(child)
        root_of[seq] = len(forest.roots)
        forest.roots.append(span)

    # Per-event rows (benchmarks' detection/TTR source of truth) — ledger
    # record order, exactly the order the pre-telemetry benchmark helper
    # returned, so ``rows[0]`` keeps its meaning in the harnesses.
    forest.rows = [_detection_row(r) for r in records
                   if r.action in ("node-failed", "scaled-in", "link-failed",
                                   "link-disconnected")]

    # -- cadence checkpoint roots -------------------------------------------
    for key in sorted(cadence, key=lambda k: str(k)):
        recs = cadence[key]
        span = _mk_root(recs, -1)
        span.cat = "checkpoint"
        span.name = f"ckpt epoch {recs[0].detail.get('epoch', '?')}"
        forest.roots.append(span)

    # -- BadPut children from the classifier's own windows -------------------
    # "lost" windows start at the previous durable checkpoint — long before
    # the failure event — so they become sibling roots with a flow arrow
    # from the failure span instead of impossible out-of-bounds children.
    grouped: Dict[Tuple[int, str], List[Tuple[float, float]]] = {}
    for (a, b, cat, seq, _subject) in forest.intervals:
        grouped.setdefault((seq, cat), []).append((a, b))
    for (seq, cat) in sorted(grouped, key=lambda k: (k[0], k[1])):
        windows = _merge_windows(grouped[(seq, cat)])
        if cat == "lost" or seq not in root_of:
            for (a, b, n) in windows:
                root = Span(name=cat, cat=cat, t0=a, t1=b, seq=seq,
                            subject=(), attrs={"n_windows": n})
                if cat == "lost" and seq in root_of:
                    forest.flows.append({
                        "src": root_of[seq], "dst": len(forest.roots),
                        "t_src": max(a, forest.roots[root_of[seq]].t0),
                        "t_dst": a, "label": "lost-work"})
                forest.roots.append(root)
            continue
        parent = forest.roots[root_of[seq]]
        for (a, b, n) in windows:
            a = max(a, parent.t0)
            b = min(max(b, a), parent.t1)
            parent.children.append(Span(
                name=cat, cat=cat, t0=a, t1=b, seq=seq,
                subject=parent.subject, attrs={"n_windows": n}))

    # -- cross-seq flow links (re-plans, re-adoptions, aborts) ---------------
    causes: List[Tuple[float, int, str]] = []
    for r in records:
        if r.seq >= 0 and r.action in _FLOW_CAUSES:
            causes.append((float(r.t), r.seq, r.action))
    for r in records:
        if r.seq < 0 or r.action not in _FLOW_EFFECTS:
            continue
        hits = [c for c in causes
                if abs(c[0] - r.t) < 1e-9 and c[1] != r.seq]
        if not hits or r.seq not in root_of:
            continue
        t_c, seq_c, action_c = min(hits, key=lambda c: c[1])
        if seq_c not in root_of:
            continue
        forest.flows.append({
            "src": root_of[seq_c], "dst": root_of[r.seq],
            "t_src": t_c, "t_dst": float(r.t),
            "label": f"{action_c}->{r.action}"})

    for span in forest.roots:
        span.children.sort(key=lambda c: (c.t0, c.name))
    return forest


# ---------------------------------------------------------------------------
# Well-formedness
# ---------------------------------------------------------------------------


def validate(ledger, forest: Optional[SpanForest] = None) -> List[str]:
    """Well-formedness audit; returns a list of violations (empty = good).

    Checks, per the tentpole contract:
    * every lifecycle opener (``scale-out-started`` / ``reshard-started`` /
      ``ckpt-started`` / ``fault-injected`` / fault-converted
      ``deferred-leaderless``) reaches **exactly one** terminal record in
      its group;
    * every child span lies inside its parent's bounds;
    * same-name sibling spans never overlap;
    * no span runs backwards (t1 >= t0).
    """
    out: List[str] = []
    records = list(ledger)
    if forest is None:
        forest = build_spans(ledger)

    # 1) opener/terminal pairing, straight off the ledger.
    joins: Dict[Tuple, List[str]] = {}
    resh: Dict[int, List[str]] = {}
    ckpt: Dict[Tuple, List[str]] = {}
    faults: Dict[Tuple, Dict] = {}
    for r in records:
        if r.kind == "join":
            joins.setdefault((r.seq, r.subject), []).append(r.action)
        if r.kind == "reshard":
            resh.setdefault(r.seq, []).append(r.action)
        if r.kind == "checkpoint":
            ckpt.setdefault((r.seq, r.detail.get("epoch")),
                            []).append(r.action)
        opener_kind = None
        if r.action == "fault-injected":
            opener_kind = r.kind
        elif (r.action == "deferred-leaderless"
              and r.detail.get("as") in _FAULT_TERMINALS):
            opener_kind = r.detail["as"]
        if opener_kind is not None:
            faults[(r.seq, opener_kind)] = {"terms": 0}
    for (seq, subject), actions in sorted(joins.items(), key=str):
        n_open = actions.count("scale-out-started")
        n_term = sum(actions.count(a) for a in _JOIN_TERMINALS)
        if n_open != n_term:
            out.append(f"join seq={seq} {subject}: {n_open} started, "
                       f"{n_term} terminal")
    for seq, actions in sorted(resh.items()):
        n_open = actions.count("reshard-started")
        n_term = sum(actions.count(a) for a in _RESHARD_TERMINALS)
        if n_open != n_term:
            out.append(f"reshard seq={seq}: {n_open} started, "
                       f"{n_term} terminal")
    for (seq, epoch), actions in sorted(ckpt.items(), key=str):
        n_open = actions.count("ckpt-started")
        n_term = sum(actions.count(a) for a in _CKPT_TERMINALS)
        if n_open != n_term:
            out.append(f"checkpoint seq={seq} epoch={epoch}: {n_open} "
                       f"started, {n_term} terminal")
    for r in records:
        key = (r.seq, r.kind) if (r.seq, r.kind) in faults else None
        if key is None:
            # Detection-synthesized records land under the fault's seq with
            # a different kind (node-fault -> node-failure): match on seq.
            for (seq, fk) in faults:
                if seq == r.seq and r.action in _FAULT_TERMINALS[fk]:
                    key = (seq, fk)
                    break
        if key is not None and r.action in _FAULT_TERMINALS[key[1]]:
            faults[key]["terms"] += 1
    for (seq, fk), st in sorted(faults.items(), key=str):
        if st["terms"] != 1:
            out.append(f"fault seq={seq} kind={fk}: {st['terms']} terminal "
                       f"records (want exactly 1)")

    # 2) + 3) + 4) structural checks on the forest.
    for root in forest.roots:
        for span in root.walk():
            if span.t1 < span.t0 - 1e-9:
                out.append(f"span {span.name} seq={span.seq} runs backwards "
                           f"({span.t0} -> {span.t1})")
            for c in span.children:
                if c.t0 < span.t0 - 1e-9 or c.t1 > span.t1 + 1e-9:
                    out.append(f"child {c.name} [{c.t0}, {c.t1}] escapes "
                               f"parent {span.name} [{span.t0}, {span.t1}] "
                               f"seq={span.seq}")
            by_name: Dict[str, List[Span]] = {}
            for c in span.children:
                by_name.setdefault(c.name, []).append(c)
            for nm, sibs in sorted(by_name.items()):
                sibs = sorted(sibs, key=lambda s: s.t0)
                for s1, s2 in zip(sibs, sibs[1:]):
                    if s2.t0 < s1.t1 - 1e-9:
                        out.append(f"siblings {nm} overlap in seq={span.seq}"
                                   f": [{s1.t0},{s1.t1}] vs [{s2.t0},{s2.t1}]")
    return out


# ---------------------------------------------------------------------------
# Cross-substrate span digest
# ---------------------------------------------------------------------------


def _root_fate(kind: str, actions: List[str]) -> str:
    """Collapse a root's records to a substrate-independent outcome class.

    The collapse deliberately discards what differs by construction between
    the simulator and the trainer: which terminal a silent fault reached
    (probabilistic probe detection vs event-boundary application), which
    deputy won an election, whether a join replanned mid-flight."""
    acts = set(actions)
    if "failover" in acts:
        return "failover"
    if "election-no-quorum" in acts:
        return "frozen"
    if kind in ("node-fault", "link-fault", "link-loss"):
        if acts & {"node-failed", "link-failed", "link-severed", "link-lossy",
                   "fault-undetected", "fault-cleared",
                   "aborted-inflight-join"}:
            return "handled"
        return "skipped"
    if kind == "join":
        if acts & {"ready", "scale-out"}:
            return "completed"
        if "aborted" in acts:
            return "aborted"
        return "skipped"
    if kind in ("leave", "node-failure"):
        if acts & {"scaled-in", "node-failed"}:
            return "removed"
        if "aborted-inflight-join" in acts:
            return "aborted-join"
        return "skipped"
    if kind in ("link-leave", "link-failure"):
        if acts & {"link-disconnected", "link-failed", "link-severed"}:
            return "down"
        return "skipped"
    if kind == "link-join":
        if acts & {"link-connected", "link-restored"}:
            return "up"
        return "skipped"
    if kind == "link-degrade":
        return "degraded" if "link-degraded" in acts else "skipped"
    if kind == "checkpoint":
        if acts & {"ckpt-complete", "ckpt-saved"}:
            return "completed"
        if "ckpt-cancelled" in acts:
            return "cancelled"
        return "skipped"
    if all(a.startswith("skipped") or a.startswith("noop") for a in acts):
        return "skipped"
    return "handled"


def _digest_subject(span: Span, by_action: Dict[str, Dict]) -> List:
    """Normalized subject for the digest row. Fail-overs project to the old
    home (the successor is substrate-local policy); cadence checkpoints to
    the empty subject (the coordinator identity drifts with fail-overs);
    links sort their endpoints."""
    kind = span.attrs.get("kind")
    if kind == "scheduler-fault":
        d = by_action.get("failover")
        if d is not None and d.get("old_home") is not None:
            return [d["old_home"]]
        return [span.subject[0]] if span.subject else []
    if kind == "checkpoint":
        return []
    return sorted(span.subject, key=str)


def span_digest(ledger, forest: Optional[SpanForest] = None) -> str:
    """Canonical digest of the substrate-independent span stream.

    Projects every event root (seq >= 0) to ``(seq, kind, subject, fate)``
    — dropping all times and substrate-local outcomes — orders rows by
    ``(seq, kind, subject)``, and hashes the canonical JSON lines. Same
    trace ⇒ the same digest from :class:`~repro_torch.core.engine.SimBackend`
    and :class:`~repro_torch.elastic.trainer.TrainerBackend` replays."""
    if forest is None:
        forest = build_spans(ledger)
    details: Dict[int, Dict[str, Dict]] = {}
    for r in ledger:
        if r.seq >= 0:
            details.setdefault(r.seq, {})[r.action] = r.detail
    rows = []
    for span in forest.roots:
        if span.seq < 0 or span.cat != "event":
            continue
        rows.append({
            "seq": span.seq,
            "kind": span.attrs.get("kind"),
            "subject": _digest_subject(span, details.get(span.seq, {})),
            "fate": span.attrs.get("fate"),
        })
    rows.sort(key=lambda r: (r["seq"], str(r["kind"]), str(r["subject"])))
    blob = "\n".join(json.dumps(r, sort_keys=True, separators=(",", ":"))
                     for r in rows)
    return hashlib.sha256(blob.encode()).hexdigest()


# ---------------------------------------------------------------------------
# Benchmark-facing rows (the consolidated timing helpers)
# ---------------------------------------------------------------------------


def detection_rows(ledger) -> List[Dict]:
    """Per-event detection/handling breakdown: every handled failure or
    departure with its ``detection_s`` (0 for omniscient events) and
    ``handling_s`` (the blocking portion, Table I semantics), in ledger
    record order. ``build_spans`` attaches the same rows to the forest."""
    return [_detection_row(r) for r in ledger
            if r.action in ("node-failed", "scaled-in", "link-failed",
                            "link-disconnected")]


def ttr_rows(ledger) -> List[Dict]:
    """Per-fault time-to-recovery rows (fault instant → end of blocking
    handling), labeled by fault class — the TTR histograms' input."""
    out = []
    for r in ledger:
        row = _ttr_row(r)
        if row is not None:
            out.append(row)
    return out


# ---------------------------------------------------------------------------
# Chrome/Perfetto trace_event export
# ---------------------------------------------------------------------------

PID_CONTROL, PID_NODES, PID_LINKS = 1, 2, 3
_TID_SCHEDULER, _TID_CHECKPOINT, _TID_RECOVERY = 1, 2, 3


def _us(t: float) -> float:
    v = round(float(t) * 1e6, 3)
    return int(v) if v == int(v) else v


def _place(span: Span, link_tids: Dict[Tuple, int]) -> Tuple[int, int]:
    kind = span.attrs.get("kind")
    if span.cat == "checkpoint" or kind == "checkpoint":
        return PID_CONTROL, _TID_CHECKPOINT
    if span.cat == "lost":
        return PID_CONTROL, _TID_RECOVERY
    if kind == "scheduler-fault":
        return PID_CONTROL, _TID_SCHEDULER
    if len(span.subject) == 2 and all(
            isinstance(x, int) for x in span.subject):
        key = tuple(sorted(span.subject))
        return PID_LINKS, link_tids.setdefault(key, len(link_tids) + 1)
    if len(span.subject) == 1 and isinstance(span.subject[0], int):
        return PID_NODES, int(span.subject[0])
    return PID_CONTROL, _TID_SCHEDULER


def _json_safe(v):
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    if isinstance(v, (int, float, str, bool)) or v is None:
        return v
    return str(v)


def trace_events(forest: SpanForest) -> List[dict]:
    """Render a span forest as Chrome ``trace_event`` dicts (``ph`` "X"
    complete slices, "i" instants for zero-duration spans, "M" metadata
    naming the tracks, "s"/"f" flow arrows). ``ts``/``dur`` are virtual
    microseconds — the ledger's (trace) clock, not wall time."""
    link_tids: Dict[Tuple, int] = {}
    events: List[dict] = []
    placed: List[Tuple[int, int]] = []

    for span in forest.roots:
        pid, tid = _place(span, link_tids)
        placed.append((pid, tid))
        for s in span.walk():
            args = {"seq": s.seq, "cat": s.cat,
                    **_json_safe({k: v for k, v in s.attrs.items()
                                  if k != "actions"})}
            base = {"name": s.name, "cat": s.cat, "pid": pid, "tid": tid,
                    "ts": _us(s.t0), "args": args}
            if s.t1 > s.t0:
                events.append({**base, "ph": "X",
                               "dur": max(_us(s.t1) - _us(s.t0), 1)})
            else:
                events.append({**base, "ph": "i", "s": "t"})

    for k, fl in enumerate(forest.flows):
        src_pid, src_tid = placed[fl["src"]]
        dst_pid, dst_tid = placed[fl["dst"]]
        common = {"name": fl["label"], "cat": "flow", "id": k + 1}
        events.append({**common, "ph": "s", "pid": src_pid, "tid": src_tid,
                       "ts": _us(fl["t_src"])})
        events.append({**common, "ph": "f", "bp": "e", "pid": dst_pid,
                       "tid": dst_tid, "ts": _us(fl["t_dst"])})

    meta: List[dict] = []
    for pid, pname in ((PID_CONTROL, "control-plane"), (PID_NODES, "nodes"),
                       (PID_LINKS, "links")):
        meta.append({"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
                     "args": {"name": pname}})
    named = set()
    control_names = {_TID_SCHEDULER: "scheduler", _TID_CHECKPOINT:
                     "checkpoint", _TID_RECOVERY: "recovery"}
    link_names = {tid: f"link {u}-{v}" for (u, v), tid in link_tids.items()}
    for pid, tid in sorted(set(placed)):
        if (pid, tid) in named:
            continue
        named.add((pid, tid))
        if pid == PID_CONTROL:
            nm = control_names.get(tid, f"track {tid}")
        elif pid == PID_LINKS:
            nm = link_names.get(tid, f"link {tid}")
        else:
            nm = f"node {tid}"
        meta.append({"ph": "M", "pid": pid, "tid": tid,
                     "name": "thread_name", "args": {"name": nm}})
    return meta + events


def validate_trace_events(events: List[dict]) -> List[str]:
    """Schema audit of a ``trace_event`` list (the CI smoke's contract):
    required keys per phase, numeric non-negative timestamps, paired flow
    ids, JSON-serializability. Returns violations (empty = loadable)."""
    out: List[str] = []
    flow_starts: Dict = {}
    flow_ends: Dict = {}
    for i, e in enumerate(events):
        ph = e.get("ph")
        if ph not in ("X", "i", "M", "s", "f", "B", "E", "C"):
            out.append(f"event {i}: unknown ph {ph!r}")
            continue
        if not isinstance(e.get("name"), str):
            out.append(f"event {i}: missing name")
        if ph == "M":
            if e.get("name") not in ("process_name", "thread_name") \
                    or "name" not in e.get("args", {}):
                out.append(f"event {i}: malformed metadata")
            continue
        for key in ("pid", "tid"):
            if not isinstance(e.get(key), int):
                out.append(f"event {i}: non-int {key}")
        ts = e.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            out.append(f"event {i}: bad ts {ts!r}")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                out.append(f"event {i}: bad dur {dur!r}")
        if ph == "s":
            flow_starts[e.get("id")] = i
        if ph == "f":
            flow_ends[e.get("id")] = i
            if e.get("bp") != "e":
                out.append(f"event {i}: flow end without bp='e'")
    for fid in flow_starts:
        if fid not in flow_ends:
            out.append(f"flow id {fid}: start without finish")
    for fid in flow_ends:
        if fid not in flow_starts:
            out.append(f"flow id {fid}: finish without start")
    try:
        json.dumps(events)
    except (TypeError, ValueError) as exc:
        out.append(f"not JSON-serializable: {exc}")
    return out


def write_chrome_trace(path, forest: SpanForest, *,
                       metadata: Optional[dict] = None) -> str:
    """Serialize the forest as a ``chaos-trace.json`` loadable in
    ``ui.perfetto.dev`` / ``chrome://tracing``. Deterministic bytes: sorted
    keys, compact separators, virtual-clock timestamps only."""
    payload = {
        "traceEvents": trace_events(forest),
        "displayTimeUnit": "ms",
        "otherData": _json_safe(metadata or {}),
    }
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    with open(path, "w") as fh:
        fh.write(blob)
    return str(path)


# ---------------------------------------------------------------------------
# Metrics registry (Prometheus text exposition)
# ---------------------------------------------------------------------------

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: fixed, sorted bucket edges — never derived from data, so exposition is
#: byte-stable across runs regardless of what was observed.
TTR_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 5.0, 10.0, 20.0,
               60.0, 120.0, 300.0)
DETECTION_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0,
                     32.0, 64.0)
STEP_TIME_BUCKETS = (0.003, 0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0)
SPAN_BUCKETS = (0.0001, 0.0003, 0.001, 0.003, 0.01, 0.03, 0.1, 0.3, 1.0,
                3.0, 10.0)


def _fmt(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class _Metric:
    def __init__(self, name: str, mtype: str, help_text: str,
                 label_names: Tuple[str, ...]):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in label_names:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.mtype = mtype
        self.help = help_text
        self.label_names = tuple(label_names)
        self.samples: Dict[Tuple[str, ...], object] = {}

    def _key(self, labels: Dict[str, object]) -> Tuple[str, ...]:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != declared "
                f"{sorted(self.label_names)}")
        return tuple(str(labels[ln]) for ln in self.label_names)

    def _label_str(self, key: Tuple[str, ...], extra: str = "") -> str:
        parts = [f'{ln}="{_escape(v)}"'
                 for ln, v in zip(self.label_names, key)]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""


class Counter(_Metric):
    def __init__(self, name, help_text="", label_names=()):
        super().__init__(name, "counter", help_text, tuple(label_names))

    def inc(self, amount: float = 1.0, **labels):
        if amount < 0:
            raise ValueError("counters only go up")
        key = self._key(labels)
        self.samples[key] = self.samples.get(key, 0.0) + amount

    def expose(self) -> List[str]:
        return [f"{self.name}{self._label_str(k)} {_fmt(v)}"
                for k, v in sorted(self.samples.items())]


class Gauge(_Metric):
    def __init__(self, name, help_text="", label_names=()):
        super().__init__(name, "gauge", help_text, tuple(label_names))

    def set(self, value: float, **labels):
        self.samples[self._key(labels)] = float(value)

    def expose(self) -> List[str]:
        return [f"{self.name}{self._label_str(k)} {_fmt(v)}"
                for k, v in sorted(self.samples.items())]


class Histogram(_Metric):
    def __init__(self, name, help_text="", label_names=(),
                 buckets: Tuple[float, ...] = TTR_BUCKETS):
        super().__init__(name, "histogram", help_text, tuple(label_names))
        edges = tuple(sorted(float(b) for b in buckets))
        if not edges:
            raise ValueError("histogram needs at least one bucket edge")
        self.edges = edges

    def observe(self, value: float, **labels):
        key = self._key(labels)
        st = self.samples.setdefault(
            key, {"counts": [0] * len(self.edges), "sum": 0.0, "count": 0})
        for i, edge in enumerate(self.edges):
            if value <= edge:
                st["counts"][i] += 1
                break
        st["sum"] += float(value)
        st["count"] += 1

    def expose(self) -> List[str]:
        lines = []
        for key, st in sorted(self.samples.items()):
            cum = 0
            for edge, n in zip(self.edges, st["counts"]):
                cum += n
                le = 'le="%s"' % _fmt(edge)
                lines.append(
                    f"{self.name}_bucket{self._label_str(key, le)} {cum}")
            inf = 'le="+Inf"'
            lines.append(
                f"{self.name}_bucket{self._label_str(key, inf)} "
                f"{st['count']}")
            lines.append(
                f"{self.name}_sum{self._label_str(key)} {_fmt(st['sum'])}")
            lines.append(
                f"{self.name}_count{self._label_str(key)} {st['count']}")
        return lines


class MetricsRegistry:
    """Deterministic metric store: get-or-create families, Prometheus text
    exposition with families sorted by name and samples by label value —
    no dict-iteration-order dependence anywhere, so same-seed scrapes are
    byte-identical."""

    def __init__(self):
        self._families: Dict[str, _Metric] = {}

    def _get(self, cls, name, help_text, label_names, **kw) -> _Metric:
        fam = self._families.get(name)
        if fam is not None:
            if not isinstance(fam, cls) or fam.label_names != tuple(
                    label_names):
                raise ValueError(f"metric {name!r} re-registered with a "
                                 f"different type or labels")
            return fam
        fam = cls(name, help_text, tuple(label_names), **kw)
        self._families[name] = fam
        return fam

    def counter(self, name, help_text="", labels=()) -> Counter:
        return self._get(Counter, name, help_text, labels)

    def gauge(self, name, help_text="", labels=()) -> Gauge:
        return self._get(Gauge, name, help_text, labels)

    def histogram(self, name, help_text="", labels=(),
                  buckets=TTR_BUCKETS) -> Histogram:
        fam = self._get(Histogram, name, help_text, labels, buckets=buckets)
        if fam.edges != tuple(sorted(float(b) for b in buckets)):
            raise ValueError(f"histogram {name!r} re-registered with "
                             f"different buckets")
        return fam

    def exposition(self) -> str:
        lines: List[str] = []
        for name in sorted(self._families):
            fam = self._families[name]
            if fam.help:
                lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.mtype}")
            lines.extend(fam.expose())
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Out-of-band collectors: snapshot reads of counters the layers keep anyway.
# ---------------------------------------------------------------------------


def collect_network(reg: MetricsRegistry, net, *, now=None) -> None:
    """Wire bytes, control datagrams, queue depth off a ``Network``."""
    snap = net.metrics_snapshot(now=now)
    reg.counter("chaos_network_data_wire_bytes_total",
                "Payload bytes of contending data transfers"
                ).inc(snap["data_wire_bytes"])
    reg.counter("chaos_network_control_wire_bytes_total",
                "Bytes of non-contending control datagrams"
                ).inc(snap["control_wire_bytes"])
    reg.counter("chaos_network_control_messages_total",
                "Control datagrams sent").inc(snap["control_messages"])
    reg.counter("chaos_network_bytes_total",
                "All bytes placed on the wire").inc(snap["bytes_on_wire"])
    reg.gauge("chaos_network_queue_backlog_seconds",
              "Summed per-link busy time beyond now (queue depth)"
              ).set(snap["queue_backlog_s"])
    reg.gauge("chaos_network_queued_links",
              "Links with a non-empty transmit queue"
              ).set(snap["queued_links"])


def collect_monitor(reg: MetricsRegistry, mon, *, now=None) -> None:
    """Phi scores, sweep periods, piggyback hits off a ``ClusterMonitor``."""
    snap = mon.metrics_snapshot(now=now)
    reg.counter("chaos_monitor_control_datagrams_total",
                "Heartbeats/probes/acks sent by the monitor"
                ).inc(snap["control_datagrams"])
    reg.counter("chaos_monitor_piggybacked_probes_total",
                "Probes satisfied by bulk-transfer deliveries"
                ).inc(snap["piggybacked_probes"])
    reg.counter("chaos_monitor_piggybacked_heartbeats_total",
                "Heartbeats satisfied by bulk-transfer deliveries"
                ).inc(snap["piggybacked_heartbeats"])
    g = reg.gauge("chaos_monitor_sweep_period_seconds",
                  "Current adaptive sweep period", labels=("sweep",))
    g.set(snap["heartbeat_period_s"], sweep="heartbeat")
    g.set(snap["probe_period_s"], sweep="probe")
    reg.gauge("chaos_monitor_phi_threshold",
              "Suspicion threshold for declaring a node dead"
              ).set(snap["phi_threshold"])
    reg.gauge("chaos_monitor_sweeps_on",
              "1 while detection sweeps are running").set(
        1.0 if snap["sweeps_on"] else 0.0)
    reg.gauge("chaos_monitor_pending_faults",
              "Injected faults not yet detected or expired",
              labels=("family",))
    for fam, n in sorted(snap["pending_faults"].items()):
        reg.gauge("chaos_monitor_pending_faults",
                  labels=("family",)).set(n, family=fam)
    phi = reg.gauge("chaos_monitor_phi_score",
                    "Current phi suspicion per monitored node",
                    labels=("node",))
    for node, score in sorted(snap["suspicion"].items()):
        phi.set(score, node=node)


def collect_control(reg: MetricsRegistry, control) -> None:
    """Election terms and sync wire bytes off a ``ControlPlane``."""
    snap = control.metrics_snapshot()
    reg.counter("chaos_control_terms_total",
                "Scheduler elections installed").inc(snap["term"])
    reg.counter("chaos_control_sync_wire_bytes_total",
                "Bytes of deputy state-sync traffic"
                ).inc(snap["sync_wire_bytes"])
    reg.gauge("chaos_control_replicas",
              "Deputies holding a scheduler-state replica"
              ).set(snap["replicas"])
    reg.gauge("chaos_control_leaderless",
              "1 while no scheduler can grant requests").set(
        1.0 if snap["leaderless"] else 0.0)
    reg.gauge("chaos_control_frozen",
              "1 after a no-quorum election froze the cluster").set(
        1.0 if snap["frozen"] else 0.0)


def collect_ledger(reg: MetricsRegistry, ledger) -> None:
    """Engine-level metrics derived purely from ledger records: per-fault-
    class TTR histograms, detection-latency histograms, recovery-action
    counts, record counts, replication credit totals."""
    ttr = reg.histogram("chaos_engine_ttr_seconds",
                        "Fault instant to end of blocking handling",
                        labels=("fault_class",), buckets=TTR_BUCKETS)
    for row in ttr_rows(ledger):
        ttr.observe(row["ttr_s"], fault_class=row["fault_class"])
    det = reg.histogram("chaos_monitor_detection_latency_seconds",
                        "Fault injection to monitor detection",
                        labels=("kind",), buckets=DETECTION_BUCKETS)
    for row in detection_rows(ledger):
        det.observe(row["detection_s"], kind=row["kind"])
    recs = reg.counter("chaos_engine_ledger_records_total",
                       "Ledger records by kind/action",
                       labels=("kind", "action"))
    actions = reg.counter("chaos_engine_recovery_actions_total",
                          "recovery-decided records by chosen action",
                          labels=("action",))
    credited = reg.counter("chaos_engine_credited_bytes_total",
                           "Delivered bytes credited on cancelled streams")
    replanned = reg.counter("chaos_engine_replanned_bytes_total",
                            "Bytes re-planned after churn")
    replans = reg.counter("chaos_engine_replans_total",
                          "Replication re-plan events")
    moved = reg.counter("chaos_reshard_moved_bytes_total",
                        "Bytes moved by completed reshards")
    for r in ledger:
        recs.inc(kind=r.kind, action=r.action)
        if r.action == "recovery-decided":
            actions.inc(action=r.detail.get("chosen", "none"))
        if r.action in ("replanned", "reshard-replanned", "ckpt-cancelled"):
            credited.inc(r.detail.get("credited_bytes", 0) or 0)
            replanned.inc(r.detail.get("replanned_bytes", 0) or 0)
            if r.action == "replanned":
                replans.inc()
        if r.action == "reshard-ready":
            moved.inc(r.detail.get("moved_bytes", 0) or 0)


def collect_goodput(reg: MetricsRegistry, report) -> None:
    """GoodPut components as gauges (virtual seconds per category)."""
    g = reg.gauge("chaos_goodput_seconds",
                  "Virtual seconds per GoodPut category",
                  labels=("category",))
    for cat in sorted(CATEGORIES):
        g.set(report.components.get(cat, 0.0), category=cat)
    reg.gauge("chaos_goodput_fraction",
              "Productive fraction of the run wall-clock"
              ).set(report.goodput_fraction)


def collect_trainer(reg: MetricsRegistry, trainer) -> None:
    """Step-time histograms off an ``ElasticTrainer`` (wall seconds)."""
    snap = trainer.metrics_snapshot()
    hist = reg.histogram("chaos_trainer_step_seconds",
                         "Per-step wall time by active device count",
                         labels=("n_active",), buckets=STEP_TIME_BUCKETS)
    for n, times in sorted(snap["step_times"].items()):
        for dt in times:
            hist.observe(dt, n_active=n)
    reg.gauge("chaos_trainer_active_devices",
              "Devices currently training").set(snap["n_active"])
    reg.counter("chaos_trainer_steps_total",
                "Optimizer steps taken").inc(snap["step_count"])


def collect_backend(reg: MetricsRegistry, backend, ledger, *,
                    report=None, now=None) -> MetricsRegistry:
    """One-stop scrape of a finished ``SimBackend`` replay: network,
    monitor, control plane, scheduler counters, ledger-derived histograms,
    and (when provided) the GoodPut report."""
    snap = backend.metrics_snapshot(now=now)
    collect_network(reg, backend.cluster.net, now=now)
    collect_monitor(reg, backend.cluster.scheduler.monitor, now=now)
    collect_control(reg, backend.control)
    collect_ledger(reg, ledger)
    reg.counter("chaos_replication_payload_bytes_total",
                "Pre-codec payload bytes of replication streams"
                ).inc(snap["replication_payload_bytes"])
    reg.counter("chaos_replication_wire_bytes_total",
                "Post-codec wire bytes of replication streams"
                ).inc(snap["replication_wire_bytes"])
    reg.gauge("chaos_engine_active_nodes",
              "Active nodes at scrape time").set(snap["n_active"])
    reg.gauge("chaos_engine_degraded",
              "1 after park-and-degrade relaxed redundancy").set(
        1.0 if snap["degraded"] else 0.0)
    if report is not None:
        collect_goodput(reg, report)
    return reg


def collect_trainer_backend(reg: MetricsRegistry, backend, ledger, *,
                            report=None) -> MetricsRegistry:
    """One-stop scrape of a finished ``TrainerBackend`` replay: ledger-derived
    histograms, the trainer's step times, the degraded flag and (when
    provided) the GoodPut report."""
    collect_ledger(reg, ledger)
    # getattr-guard: membership-only trainer doubles (the test idiom)
    # predate the snapshot API and carry no step-time observables anyway.
    if hasattr(backend.trainer, "metrics_snapshot"):
        collect_trainer(reg, backend.trainer)
    reg.gauge("chaos_engine_degraded",
              "1 after park-and-degrade relaxed redundancy").set(
        1.0 if backend.degraded else 0.0)
    if report is not None:
        collect_goodput(reg, report)
    return reg


def collect_spans(reg: MetricsRegistry, records) -> MetricsRegistry:
    """The port's spans (``repro_torch.spans.drain()``): a
    ``chaos_span_seconds`` histogram by span name, and for each counter key
    a ``chaos_span_<key>_total`` counter by span name."""
    hist = reg.histogram("chaos_span_seconds", "Wall time of the program's spans",
                         labels=("span",), buckets=SPAN_BUCKETS)
    for r in records:
        hist.observe(r.seconds, span=r.name)
        for key, n in sorted(r.counters.items()):
            reg.counter(f"chaos_span_{key}_total", f"Counter {key} of the program's spans",
                        labels=("span",)).inc(n, span=r.name)
    return reg


# ---------------------------------------------------------------------------
# Markdown report
# ---------------------------------------------------------------------------


def markdown_report(ledger, forest: SpanForest, *, report=None,
                    title: str = "Chaos trace report") -> str:
    """Human-readable timeline + TTR summary for ``tools/trace_report.py``.
    Deterministic: virtual times only, sorted rows."""
    lines = [f"# {title}", ""]
    lines.append(f"Window: `{forest.t_start:.3f}s .. {forest.t_end:.3f}s` "
                 f"virtual; {len(forest.roots)} spans, "
                 f"{len(forest.flows)} causal links, "
                 f"{len(list(ledger))} ledger records.")
    lines.append("")
    if report is not None:
        lines.append("## GoodPut")
        lines.append("")
        lines.append("| category | seconds |")
        lines.append("|---|---|")
        for cat in CATEGORIES:
            lines.append(f"| {cat} | {report.components.get(cat, 0.0):.3f} |")
        lines.append(f"| **goodput fraction** | "
                     f"**{report.goodput_fraction:.4f}** |")
        lines.append("")
    rows = ttr_rows(ledger)
    lines.append("## Time to recovery")
    lines.append("")
    if rows:
        lines.append("| fault class | n | mean TTR (s) | max TTR (s) | "
                     "mean detection (s) | mean handling (s) |")
        lines.append("|---|---|---|---|---|---|")
        classes = sorted({r["fault_class"] for r in rows})
        for cls in classes:
            sub = [r for r in rows if r["fault_class"] == cls]
            mean = math.fsum(r["ttr_s"] for r in sub) / len(sub)
            mx = max(r["ttr_s"] for r in sub)
            mdet = math.fsum(r["detection_s"] for r in sub) / len(sub)
            mh = math.fsum(r["handling_s"] for r in sub) / len(sub)
            lines.append(f"| {cls} | {len(sub)} | {mean:.3f} | {mx:.3f} | "
                         f"{mdet:.3f} | {mh:.3f} |")
    else:
        lines.append("No handled faults in this trace.")
    lines.append("")
    lines.append("## Timeline")
    lines.append("")
    lines.append("| t0 (s) | dur (s) | span | fate | children |")
    lines.append("|---|---|---|---|---|")
    for span in sorted(forest.roots, key=lambda s: (s.t0, s.seq)):
        kids = ", ".join(f"{c.name}:{c.duration_s:.3f}s"
                         for c in span.children) or "-"
        lines.append(f"| {span.t0:.3f} | {span.duration_s:.3f} | "
                     f"{span.name} | {span.attrs.get('fate', '-')} | "
                     f"{kids} |")
    lines.append("")
    return "\n".join(lines)
