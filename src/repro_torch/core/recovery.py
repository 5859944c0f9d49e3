"""Unified recovery-policy layer: per-fault-class action selection, from
``repro/core/recovery.py`` (all of it).

* :data:`RECOVERY_ACTIONS` — ``credit-replan``, ``restore-replica``,
  ``restore-checkpoint``, ``reshard`` and ``park-and-degrade``.
* :class:`FaultContext` — everything a decision may consult.
* :class:`FixedPolicy` — a static preference chain per fault class, no
  decision records.
* :class:`AdaptivePolicy` — scores each feasible action with a
  :class:`CostModel` calibrated online, picks the cheapest, and ledgers
  every choice as a ``recovery-decided`` record.

Decisions are substrate-independent: the JAX simulator's ``SimBackend``
and the port's ``TrainerBackend`` build the same pure :class:`FaultContext`
fields from a trace, so :func:`decision_digest` is byte-identical across
them on the same trace.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.core.plans import (
    RESHARD_MODES,
    ParallelismPlan,
    ReshardPolicy,
    decide_reshard,
    default_reshard_policy,
    reshard_moved_bytes,
)

#: the recovery-action vocabulary (per-event ``ChurnEvent.recovery``
#: annotations must name one of these).
RECOVERY_ACTIONS = ("credit-replan", "restore-replica", "restore-checkpoint",
                    "reshard", "park-and-degrade")

#: decision contexts — the fault classes a policy is consulted on.
CONTEXTS = ("node-failure", "stream-churn", "membership-change",
            "re-adoption")

#: modeled opportunity cost of parking a dead node's capacity instead of
#: restoring its redundancy: the cluster trains on, but degraded — one
#: fewer worker and a relaxed sync policy until the next scale-out.
PARK_DEGRADE_COST_S = 30.0
#: modeled work-loss of a *cold* checkpoint restore (no durable push yet):
#: everything back to the cold base is gone, which the policy cannot bound
#: better than this prior until it has observed real ``lost_s`` values.
COLD_RESTORE_LOST_S = 120.0

#: the substrate-independent projection of a decision record — what
#: :func:`decision_digest` hashes. Scores are excluded: cost estimates are
#: calibrated from each substrate's own clock and may differ; the *choices*
#: must not.
PARITY_FIELDS = ("context", "chosen", "policy", "forced")


class CostModel:
    """Running-mean cost estimates, calibrated online from the ledger's own
    measurements. Priors cover the cold start (nothing observed yet), the
    same way the adaptive checkpoint cadence falls back to its fixed
    baseline before the first measured fault. Deterministic: estimates are
    pure functions of the observation sequence, which is itself derived
    from virtual-clock measurements only."""

    PRIORS = {
        "detection": 8.0,            # monitor sweep latency (PR 3-4 scale)
        "election": 1.0,             # quorum election (PR 5 scale)
        "handling": 0.1,             # blocking protocol charge per event
        "replan": 0.01,              # solver charge per credit-aware re-plan
        "restore-checkpoint": 2.0,   # restore read from the holder
        "snapshot": 0.25,            # per-push synchronous stall
        "lost": 15.0,                # work lost per checkpoint restore
    }

    def __init__(self):
        self._sum: Dict[str, float] = {}
        self._n: Dict[str, int] = {}

    def observe(self, key: str, value) -> None:
        if value is None:
            return
        self._sum[key] = self._sum.get(key, 0.0) + float(value)
        self._n[key] = self._n.get(key, 0) + 1

    def count(self, key: str) -> int:
        return self._n.get(key, 0)

    def estimate(self, key: str) -> float:
        n = self._n.get(key, 0)
        if n:
            return self._sum[key] / n
        return self.PRIORS.get(key, 0.0)

    def to_json(self) -> dict:
        return {k: {"n": self._n[k],
                    "mean_s": round(self._sum[k] / self._n[k], 6)}
                for k in sorted(self._n)}


@dataclass(frozen=True)
class FaultContext:
    """One recovery decision's inputs. Every field is derivable from the
    trace plus state the ledger already records, so both substrates can
    build identical contexts (modulo the documented substrate-local fields:
    ``detection_s``, ``ckpt_age_s``, ``link_mbps``, credit counters — those
    feed the *scores*, never the parity projection)."""
    kind: str                      # one of CONTEXTS
    t: float                       # decision time (virtual / trace order)
    subject: Tuple                 # node id or (u, v)
    n_active: int                  # live membership after the event
    min_active: int
    state_bytes: int
    detection_s: Optional[float] = None
    inflight_credit_bytes: int = 0
    link_mbps: Tuple[float, ...] = ()   # live link bandwidth classes
    # node-failure action feasibility:
    replica_feasible: bool = True  # a full peer replica survives (dp > 1)
    ckpt_available: bool = False   # a checkpoint tier is attached
    ckpt_age_s: Optional[float] = None  # None = cold (no durable push yet)
    # re-adoption:
    replicated: bool = True        # in the elected winner's deputy replica
    # membership-change (the reshard candidate):
    plan: Optional[ParallelismPlan] = None
    reshard_mode: Optional[str] = None  # per-event override; None = standing
    pinned_shape: Optional[Tuple[int, ...]] = None
    devices: Tuple[int, ...] = ()
    tensor_sizes: Tuple[int, ...] = ()
    # per-event ChurnEvent.recovery annotation (forces the action):
    override: Optional[str] = None

    def __post_init__(self):
        if self.kind not in CONTEXTS:
            raise ValueError(f"unknown fault context {self.kind!r}")
        if self.override is not None and self.override not in RECOVERY_ACTIONS:
            raise ValueError(f"unknown recovery action {self.override!r}")


@dataclass
class RecoveryDecision:
    """One policy verdict. ``action`` None means no recovery work (adopt an
    in-flight transfer in place / keep the current layout); ``scores`` maps
    every *feasible* candidate to its modeled cost in virtual seconds;
    ``reshard``/``baseline`` carry the membership-change payload the caller
    executes."""
    action: Optional[str]
    scores: Dict[str, float] = field(default_factory=dict)
    policy: str = "fixed"
    forced: bool = False
    reshard: Optional[dict] = None
    baseline: Optional[ParallelismPlan] = None


def evaluate_membership(reshard_policy: ReshardPolicy,
                        plan: Optional[ParallelismPlan],
                        devices: Sequence[int], state_bytes: int,
                        tensor_sizes: Sequence[int], *, mode: str,
                        pinned_shape=None
                        ) -> Tuple[Optional[dict],
                                   Optional[ParallelismPlan]]:
    """The membership-change candidate evaluation both substrates share.

    Returns ``(decision, baseline)``: ``decision`` is the
    :func:`~repro_torch.core.plans.decide_reshard` payload to execute (including
    the forced fall-back to replicate-only when the mode is ``"never"``
    while the cluster is sharded — survivors' intervals moved, staying put
    is not an option), or None to keep the layout. ``(None, None)`` is the
    pure pre-reshard path: no plan state, no records, byte-identical
    replays."""
    if mode == "never" and (plan is None or plan.tp == 1):
        return None, None
    devs = sorted(devices)
    if not devs:
        return None, None
    decision, baseline = decide_reshard(reshard_policy, plan, devs,
                                        state_bytes, tensor_sizes,
                                        mode=mode, pinned_shape=pinned_shape)
    if decision is None and plan is not None and plan.tp > 1:
        decision = {
            "plan": baseline,
            "step_s": reshard_policy.step_time(baseline, state_bytes,
                                               tensor_sizes),
            "baseline_step_s": reshard_policy.step_time(baseline, state_bytes,
                                                        tensor_sizes),
            "moved_bytes": reshard_moved_bytes(plan, baseline, state_bytes),
            "old_shape": plan.signature(),
            "new_shape": baseline.signature(),
        }
    return decision, baseline


class RecoveryPolicy:
    """The selector interface: :meth:`decide` maps a :class:`FaultContext`
    to a :class:`RecoveryDecision`. Subclasses implement the per-context
    verdicts; the base class owns the shared plumbing (feasibility, the
    reshard candidate, online cost observation)."""

    name = "base"
    #: whether choices are ledgered as ``recovery-decided`` records.
    #: FixedPolicy stays silent so pre-policy digests replay byte-identical;
    #: a per-event ``recovery=`` override records regardless (the
    #: annotation itself is new, so no old trace carries one).
    records = False

    def __init__(self, *, reshard: str = "never",
                 reshard_policy: Optional[ReshardPolicy] = None,
                 state_bytes: int = 1):
        if reshard not in RESHARD_MODES:
            raise ValueError(f"unknown reshard mode {reshard!r}")
        self.reshard_mode = reshard
        self.reshard_policy = (reshard_policy if reshard_policy is not None
                               else default_reshard_policy(
                                   reshard, int(state_bytes) or 1))
        self.costs = CostModel()

    # -- online calibration --------------------------------------------------

    def observe(self, key: str, value) -> None:
        """Feed one measured cost (detection_s, election_s, restore_s,
        blocking_s, ...) into the cost model. Harmless for FixedPolicy —
        it never consults the estimates."""
        self.costs.observe(key, value)

    # -- the selector --------------------------------------------------------

    def decide(self, ctx: FaultContext) -> RecoveryDecision:
        if ctx.kind == "membership-change":
            return self._membership(ctx)
        if ctx.kind == "stream-churn":
            return self._stream(ctx)
        if ctx.kind == "re-adoption":
            return self._readoption(ctx)
        return self._failure(ctx)

    def _feasible(self, ctx: FaultContext) -> Tuple[str, ...]:
        """Feasible node-failure actions, in vocabulary order. Parking is
        always available (it asks nothing of the dead node's state); a
        replica restore needs a surviving full copy; a checkpoint restore
        needs an attached tier (a cold tier still restores — at cold
        cost)."""
        acts = []
        if ctx.replica_feasible:
            acts.append("restore-replica")
        if ctx.ckpt_available:
            acts.append("restore-checkpoint")
        acts.append("park-and-degrade")
        return tuple(acts)

    def _membership(self, ctx: FaultContext) -> RecoveryDecision:
        mode = (ctx.reshard_mode if ctx.reshard_mode is not None
                else self.reshard_mode)
        decision, baseline = evaluate_membership(
            self.reshard_policy, ctx.plan, ctx.devices, ctx.state_bytes,
            ctx.tensor_sizes, mode=mode, pinned_shape=ctx.pinned_shape)
        scores = {}
        if decision is not None:
            scores = {"reshard": decision["step_s"],
                      "keep-layout": decision["baseline_step_s"]}
        return RecoveryDecision("reshard" if decision is not None else None,
                                scores, self.name, reshard=decision,
                                baseline=baseline)

    def _stream(self, ctx: FaultContext) -> RecoveryDecision:
        raise NotImplementedError

    def _readoption(self, ctx: FaultContext) -> RecoveryDecision:
        raise NotImplementedError

    def _failure(self, ctx: FaultContext) -> RecoveryDecision:
        raise NotImplementedError


class FixedPolicy(RecoveryPolicy):
    """Today's hard-wired behavior as a policy: a static preference chain
    per fault class, first feasible action wins. ``prefer`` replaces the
    old ``recovery="replica"|"checkpoint"`` engine knob (plus the new
    ``"park"``); the reshard gate is the standing mode, exactly as before.
    Writes no decision records, so every pre-policy trace digest replays
    byte-identically."""

    PREFERENCE = {
        "replica": ("restore-replica", "restore-checkpoint",
                    "park-and-degrade"),
        "checkpoint": ("restore-checkpoint", "restore-replica",
                       "park-and-degrade"),
        "park": ("park-and-degrade", "restore-replica",
                 "restore-checkpoint"),
    }

    def __init__(self, prefer: str = "replica", **kw):
        if prefer not in self.PREFERENCE:
            raise ValueError(f"unknown fixed recovery preference {prefer!r}")
        super().__init__(**kw)
        self.prefer = prefer
        self.name = f"fixed-{prefer}"

    def _failure(self, ctx: FaultContext) -> RecoveryDecision:
        feasible = self._feasible(ctx)
        if ctx.override is not None and ctx.override in feasible:
            return RecoveryDecision(ctx.override, {}, self.name, forced=True)
        for a in self.PREFERENCE[self.prefer]:
            if a in feasible:
                return RecoveryDecision(a, {}, self.name)
        return RecoveryDecision("park-and-degrade", {}, self.name)

    def _stream(self, ctx: FaultContext) -> RecoveryDecision:
        return RecoveryDecision("credit-replan", {}, self.name)

    def _readoption(self, ctx: FaultContext) -> RecoveryDecision:
        return RecoveryDecision(None if ctx.replicated else "credit-replan",
                                {}, self.name)


class AdaptivePolicy(RecoveryPolicy):
    """Chameleon-style selection: score every feasible action with the
    online cost model and pick the cheapest (deterministic tie-break on the
    action name). Ledgers every choice — ``recovery-decided`` records with
    the scored alternatives are how GoodPut attributes badput per chosen
    action and how the benchmark counts distinct actions."""

    name = "adaptive"
    records = True

    def __init__(self, *, reshard: str = "auto", **kw):
        super().__init__(reshard=reshard, **kw)

    def _failure(self, ctx: FaultContext) -> RecoveryDecision:
        est = self.costs.estimate
        scores: Dict[str, float] = {}
        if ctx.replica_feasible:
            # Neighbor replicas re-seed the state in place; only the sync
            # policy swap blocks.
            scores["restore-replica"] = est("handling")
        if ctx.ckpt_available:
            lost = (ctx.ckpt_age_s if ctx.ckpt_age_s is not None
                    else max(COLD_RESTORE_LOST_S, est("lost")))
            scores["restore-checkpoint"] = est("restore-checkpoint") + lost
        scores["park-and-degrade"] = PARK_DEGRADE_COST_S + est("handling")
        if ctx.override is not None and ctx.override in scores:
            return RecoveryDecision(ctx.override, scores, self.name,
                                    forced=True)
        chosen = min(sorted(scores), key=lambda a: scores[a])
        return RecoveryDecision(chosen, scores, self.name)

    def _stream(self, ctx: FaultContext) -> RecoveryDecision:
        # Credit-aware replan vs. throwing the delivered prefix away and
        # restarting: the forfeited bytes re-cross the wire at the best
        # live rate. Replanning always wins — the scores make the margin
        # visible in the ledger.
        replan = self.costs.estimate("replan") + self.costs.estimate(
            "handling")
        rate_mbps = max(ctx.link_mbps) if ctx.link_mbps else 100.0
        restart = replan + (ctx.inflight_credit_bytes * 8.0
                            / (rate_mbps * 1e6))
        return RecoveryDecision("credit-replan",
                                {"credit-replan": replan,
                                 "restart-scratch": restart}, self.name)

    def _readoption(self, ctx: FaultContext) -> RecoveryDecision:
        # The new leader re-prices the in-flight recovery under its own
        # measured costs: adopting a replicated scale-out costs one
        # handling charge; a scale-out missing from its replica *must* be
        # rebuilt (there is no plan to adopt).
        est = self.costs.estimate
        scores = {"credit-replan": est("replan") + est("handling")}
        if ctx.replicated:
            scores["adopt"] = est("handling")
            return RecoveryDecision(None, scores, self.name)
        return RecoveryDecision("credit-replan", scores, self.name)


#: string shorthands accepted wherever a policy is configured.
POLICY_NAMES = ("fixed", "fixed-replica", "fixed-checkpoint", "fixed-park",
                "adaptive")


def make_policy(policy="fixed", *, reshard: str = "never",
                reshard_policy: Optional[ReshardPolicy] = None,
                state_bytes: int = 1) -> RecoveryPolicy:
    """Resolve a policy spec (string shorthand or instance) into a fresh
    :class:`RecoveryPolicy`. ``reshard``/``reshard_policy`` configure the
    membership-change candidate exactly as the old standalone knobs did;
    an instance passes through untouched (its own reshard settings win)."""
    if isinstance(policy, RecoveryPolicy):
        return policy
    if policy is None:
        policy = "fixed"
    kw = dict(reshard=reshard, reshard_policy=reshard_policy,
              state_bytes=state_bytes)
    if policy == "adaptive":
        return AdaptivePolicy(**kw)
    if policy == "fixed":
        return FixedPolicy("replica", **kw)
    if isinstance(policy, str) and policy.startswith("fixed-"):
        return FixedPolicy(policy[len("fixed-"):], **kw)
    raise ValueError(f"unknown recovery policy {policy!r} "
                     f"(expected one of {POLICY_NAMES} or an instance)")


def decision_detail(ctx: FaultContext, dec: RecoveryDecision) -> dict:
    """The ``recovery-decided`` ledger payload: context, chosen action,
    policy, and the scored alternatives (rounded — virtual seconds only)."""
    chosen = dec.action
    if chosen is None:
        chosen = {"re-adoption": "adopt",
                  "membership-change": "keep-layout"}.get(ctx.kind, "none")
    out = {"context": ctx.kind, "chosen": chosen, "policy": dec.policy}
    if dec.scores:
        out["scores"] = {k: round(float(v), 6)
                         for k, v in sorted(dec.scores.items())}
    if dec.forced:
        out["forced"] = True
    return out


def decision_digest(ledger) -> str:
    """Canonical digest of the substrate-independent decision stream.

    Projects every ``recovery-decided`` record to
    ``(seq, subject, context, chosen, policy, forced)`` — dropping times
    and scores, which are measured on each substrate's own clock — and
    hashes the canonical JSON lines. Rows are ordered canonically by
    (seq, context, subject) rather than append order: the simulator decides
    a join's membership change when its replication *completes* (possibly
    after later events), the trainer at the event boundary. Same trace +
    same policy config ⇒ both substrates produce the same digest."""
    rows = []
    for r in ledger:
        if r.action != "recovery-decided":
            continue
        row = {"seq": r.seq, "subject": list(r.subject)}
        for f in PARITY_FIELDS:
            if f in r.detail:
                row[f] = r.detail[f]
        rows.append(row)
    rows.sort(key=lambda x: (x["seq"], x.get("context", ""), x["subject"]))
    payload = "\n".join(json.dumps(x, sort_keys=True, separators=(",", ":"))
                        for x in rows)
    return hashlib.sha256(payload.encode()).hexdigest()


def chosen_actions(ledger) -> Dict[str, int]:
    """Count of ``recovery-decided`` choices per chosen action — the
    distinct-actions metric the policy benchmark reports. Pure read."""
    out: Dict[str, int] = {}
    for r in ledger:
        if r.action == "recovery-decided":
            c = r.detail.get("chosen", "none")
            out[c] = out.get(c, 0) + 1
    return dict(sorted(out.items()))
