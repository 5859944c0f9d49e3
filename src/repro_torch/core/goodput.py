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

Not ported here: ``SimCheckpointTier``, the simulator's checkpoint tier.
It drives pushes as contending transfers on the simulated network
(``simulator.TransferHandle``) and comes with the simulator substrate.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

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
