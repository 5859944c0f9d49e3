"""Replication and parallelism plans, copied from ``repro/core/plans.py``:
the one replication-plan path (paper §III problems P1–P3, Algorithms 1–2;
§IV-B peer negotiation consumes the plans; §VI-F ablations).

Every component that turns "node X needs the training state" into "which
source sends which bytes over which route" goes through this module: the
simulator's scheduler (``negotiation.py``), the churn pipeline
(``engine.py``), the elastic trainer (``replication.plan_replication``) and
the recovery-policy layer (``core.recovery``).

``plan_assignment`` is the canonical Algorithm 1+2 entry point: Algorithm 1
binary-searches the shard size s, Algorithm 2 greedily assigns shards to
neighbors by least estimated load. The ``Topology``-based whole-plan
builders (``measured_neighbors``, ``chaos_plan``, ``chaos_even_plan``,
``single_source_plan``, ``multi_source_plan``, ``build_plan``) run on the
port's own ``core.topology``, as does ``reshard_plan``. The parallelism-plan
(reshard) layer: ``ParallelismPlan``, ``candidate_plans``,
``replicated_fraction``, ``ReshardPolicy``, ``default_reshard_policy``,
``reshard_moved_bytes``, ``ReshardPlan``, ``reshard_plan``,
``decide_reshard`` and ``trim_tensor_sizes``.

Every function is kept operation for operation, so plans, routes and
summaries equal the JAX package's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import codec as wire_codec
from repro_torch.core.sharding_alg import (
    Assignment,
    NeighborLink,
    auto_greedy_solver,
    binary_search_assignment,
    even_assignment,
)
from repro_torch.core.topology import Topology


@dataclass
class ReplicationPlan:
    """What each source sends to the new node, with predicted delay.

    ``shard_size`` is the Algorithm-1 shard granularity in bytes; 0 for the
    baseline strategies that stream unsharded. It doubles as the credit
    granularity when churn interrupts the plan: a cancelled stream keeps
    its whole-shard delivered prefix (partial shards are re-sent).

    ``sources`` stays in **payload** bytes (what the joining node must
    install); ``codecs``/``wire_sources`` carry the per-source negotiated
    codec and the bytes that actually cross the wire — payload plus
    per-block scale framing, framed per shard so whole-wire-shard prefixes
    decode to whole payload shards (partial-credit exactness). Both stay
    empty under the ``"none"`` policy so plan summaries — and therefore
    ledgers — are byte-identical to the pre-codec format."""
    strategy: str
    sources: Dict[int, int]  # source node -> payload bytes to send
    routes: Dict[int, List[int]]  # source node -> path to new node
    predicted_delay_s: float
    shard_size: int = 0  # Alg-1 shard bytes; 0 = unsharded stream
    codecs: Dict[int, str] = field(default_factory=dict)  # source -> codec
    wire_sources: Dict[int, int] = field(default_factory=dict)  # source -> wire bytes

    def codec_for(self, u: int) -> str:
        return self.codecs.get(u, wire_codec.CODEC_NONE)

    def wire_for(self, u: int):
        """Wire bytes for source ``u`` (== payload bytes under ``none``)."""
        if u in self.wire_sources:
            return self.wire_sources[u]
        return self.sources.get(u, 0)

    def wire_shard_for(self, u: int) -> int:
        """Credit granularity on the wire for source ``u``: each payload
        shard is encoded independently, so one wire shard is
        ``wire_bytes(codec, shard_size)`` framed bytes."""
        if self.shard_size <= 0:
            return 0
        return int(wire_codec.wire_bytes(self.codec_for(u), self.shard_size))

    def codec_active(self) -> bool:
        return any(c != wire_codec.CODEC_NONE for c in self.codecs.values())

    def total_wire_bytes(self):
        return sum(self.wire_for(u) for u in self.sources)

    def summary(self) -> dict:
        """Deterministic dict for event ledgers (sorted keys, ints/floats).
        Codec fields appear only when a non-``none`` codec was negotiated —
        ``codec="none"`` summaries are byte-identical to the legacy format."""
        out = {
            "strategy": self.strategy,
            "sources": {str(u): int(b) for u, b in sorted(self.sources.items())},
            "predicted_delay_s": float(self.predicted_delay_s),
            "shard_size": int(self.shard_size),
        }
        if self.codec_active():
            out["codecs"] = {str(u): c for u, c in sorted(self.codecs.items())}
            out["wire_bytes"] = {str(u): int(self.wire_for(u))
                                 for u in sorted(self.sources)}
        return out


def plan_assignment(
    tensor_sizes: Sequence[int], neighbors: Dict[int, NeighborLink], **kw
) -> Assignment:
    """Algorithm 1 over the auto-dispatched Algorithm 2 (heap or vectorized —
    identical results, different wall time)."""
    return binary_search_assignment(tensor_sizes, neighbors,
                                    solver=auto_greedy_solver, **kw)


def measured_neighbors(
    topo: Topology, new_node: int, sync: Optional[Dict[int, float]] = None
) -> Dict[int, NeighborLink]:
    """Monitor measurement of direct neighbors (iperf stand-in, §IV-A)."""
    out = {}
    for u in topo.neighbors(new_node):
        l = topo.link(u, new_node)
        out[u] = NeighborLink(l.latency_s, l.trans_delay_per_byte,
                              (sync or {}).get(u, 0.0))
    return out


def _negotiated_codecs(
    topo: Topology, new_node: int, neighbors: Sequence[int], codec: str
) -> Dict[int, str]:
    """Per-neighbor codec negotiation over the measured direct links."""
    return {u: wire_codec.negotiate(codec,
                                    topo.link(u, new_node).bandwidth_mbps)
            for u in neighbors}


def _derated_neighbors(
    nb: Dict[int, NeighborLink], codecs: Dict[int, str]
) -> Dict[int, NeighborLink]:
    """Planner view of the links under the negotiated codecs: per-payload-byte
    time shrinks by the wire ratio and grows by the amortized encode/decode
    compute, so Algorithm 1+2 loads sources codec-aware."""
    return {u: NeighborLink(
        l.prop_s,
        wire_codec.effective_trans_s_per_byte(codecs[u], l.trans_s_per_byte),
        l.sync_s) for u, l in nb.items()}


def _wire_fields(sources: Dict[int, int], codecs: Dict[int, str],
                 shard_size: int) -> Tuple[Dict[int, str], Dict[int, int]]:
    """(codecs, wire_sources) for a plan — both empty when every negotiated
    codec is ``none`` so the plan (and its ledger summary) stays byte-identical
    to the pre-codec format. Wire bytes are framed **per shard**: ``n`` whole
    payload shards cost ``n * wire_bytes(shard)`` on the wire."""
    active = {u: codecs.get(u, wire_codec.CODEC_NONE) for u in sources}
    if all(c == wire_codec.CODEC_NONE for c in active.values()):
        return {}, {}
    wire: Dict[int, int] = {}
    for u, nbytes in sources.items():
        c = active[u]
        if shard_size > 0 and nbytes:
            n_whole, rem = divmod(int(nbytes), int(shard_size))
            w = n_whole * wire_codec.wire_bytes(c, shard_size)
            if rem:
                w += wire_codec.wire_bytes(c, rem)
            wire[u] = int(w)
        else:
            wire[u] = int(wire_codec.wire_bytes(c, nbytes))
    return active, wire


def chaos_plan(
    topo: Topology, new_node: int, state_bytes: int,
    tensor_sizes: Sequence[int], sync: Optional[Dict[int, float]] = None,
    solver=plan_assignment, codec: str = wire_codec.CODEC_NONE,
) -> ReplicationPlan:
    """Multi-neighbor replication with Algorithm 1+2 shard scheduling."""
    nb = measured_neighbors(topo, new_node, sync)
    codecs = _negotiated_codecs(topo, new_node, list(nb), codec)
    planner_nb = (nb if all(c == wire_codec.CODEC_NONE for c in codecs.values())
                  else _derated_neighbors(nb, codecs))
    asg = solver(tensor_sizes, planner_nb)
    sources = {u: len(ks) * asg.shard_size for u, ks in
               asg.shards_per_neighbor.items() if ks}
    routes = {u: [u, new_node] for u in sources}
    cds, wire = _wire_fields(sources, codecs, int(asg.shard_size))
    return ReplicationPlan("chaos", sources, routes, asg.completion_s,
                           shard_size=int(asg.shard_size),
                           codecs=cds, wire_sources=wire)


def chaos_even_plan(topo, new_node, state_bytes, tensor_sizes, sync=None,
                    codec: str = wire_codec.CODEC_NONE):
    """Multi-neighbor replication with *even* shards (ablation variant)."""
    nb = measured_neighbors(topo, new_node, sync)
    codecs = _negotiated_codecs(topo, new_node, list(nb), codec)
    planner_nb = (nb if all(c == wire_codec.CODEC_NONE for c in codecs.values())
                  else _derated_neighbors(nb, codecs))
    k = len(nb)
    s = math.ceil(state_bytes / k)
    asg = even_assignment(k, s, planner_nb)
    sources = {u: len(ks) * s for u, ks in asg.shards_per_neighbor.items() if ks}
    cds, wire = _wire_fields(sources, codecs, int(s))
    return ReplicationPlan("multi-neighbor-even", sources,
                           {u: [u, new_node] for u in sources}, asg.completion_s,
                           shard_size=int(s), codecs=cds, wire_sources=wire)


def single_source_plan(
    topo: Topology, new_node: int, state_bytes: int, sync=None,
    codec: str = wire_codec.CODEC_NONE,
) -> ReplicationPlan:
    """EDL+ [13]/Elan [14]: pull everything from the fastest neighbor."""
    nb = measured_neighbors(topo, new_node, sync)
    if not nb:
        raise ValueError("new node has no neighbors")
    codecs = _negotiated_codecs(topo, new_node, list(nb), codec)
    best_u, best_t = None, float("inf")
    for u, l in nb.items():
        per = wire_codec.effective_trans_s_per_byte(codecs[u],
                                                    l.trans_s_per_byte)
        t = l.prop_s + l.sync_s + state_bytes * per
        if t < best_t:
            best_u, best_t = u, t
    cds, wire = _wire_fields({best_u: state_bytes}, codecs, 0)
    return ReplicationPlan("single-source", {best_u: state_bytes},
                           {best_u: [best_u, new_node]}, best_t,
                           codecs=cds, wire_sources=wire)


def multi_source_plan(
    topo: Topology, new_node: int, state_bytes: int, sync=None,
    codec: str = wire_codec.CODEC_NONE,
) -> ReplicationPlan:
    """Autoscaling [18]: even shards from ALL active nodes, routed along
    shortest paths — multi-hop forwards included (Fig 1c pathology)."""
    others = [n for n in topo.active_nodes()
              if n != new_node and topo.has_path(n, new_node)]
    if not others:
        raise ValueError("no sources")
    share = math.ceil(state_bytes / len(others))
    sources, routes, codecs = {}, {}, {}
    link_load: Dict[Tuple[int, int], float] = {}
    worst_path = 0.0
    for u in others:
        path = topo.shortest_path(u, new_node, share)
        prop, trans = topo.path_delay_per_byte(path)
        # Multi-hop negotiation keys off the path bottleneck: the encoded
        # stream is forwarded verbatim, so one codec serves the whole path.
        codecs[u] = wire_codec.negotiate(
            codec, wire_codec.link_bandwidth_mbps(
                max(topo.link(a, b).trans_delay_per_byte
                    for a, b in zip(path, path[1:]))))
        eff = wire_codec.effective_trans_s_per_byte(codecs[u], trans)
        sources[u] = share
        routes[u] = path
        worst_path = max(worst_path, prop + share * eff + (sync or {}).get(u, 0.0))
        wire_share = wire_codec.wire_bytes(codecs[u], share)
        for a, b in zip(path, path[1:]):
            key = (min(a, b), max(a, b))
            link_load[key] = link_load.get(key, 0.0) + wire_share
    # Multi-hop routes serialize on shared links (Fig 1c): the completion time
    # is bounded below by the most-loaded link's drain time (in wire bytes).
    bottleneck = max(
        (load * topo.link(a, b).trans_delay_per_byte
         for (a, b), load in link_load.items()),
        default=0.0,
    )
    cds, wire = _wire_fields(sources, codecs, 0)
    return ReplicationPlan("multi-source", sources, routes,
                           max(worst_path, bottleneck),
                           codecs=cds, wire_sources=wire)


STRATEGY_BUILDERS = {
    "chaos": chaos_plan,
    "chaos-even": chaos_even_plan,
    "single-source": single_source_plan,
    "multi-source": multi_source_plan,
}


def build_plan(
    strategy: str, topo: Topology, new_node: int, state_bytes: int,
    tensor_sizes: Sequence[int], sync: Optional[Dict[int, float]] = None,
    codec: str = wire_codec.CODEC_NONE,
) -> ReplicationPlan:
    """Strategy-dispatched plan construction — the single entry point used by
    the scheduler, the churn engine, and the benchmarks. ``codec`` is the
    scheduler policy (``none``/``int8``/``int8+topk``/``auto``); negotiation
    resolves it per source link."""
    if strategy in ("chaos",):
        return chaos_plan(topo, new_node, state_bytes, tensor_sizes, sync,
                          codec=codec)
    if strategy == "chaos-even":
        return chaos_even_plan(topo, new_node, state_bytes, tensor_sizes, sync,
                               codec=codec)
    if strategy == "single-source":
        return single_source_plan(topo, new_node, state_bytes, sync,
                                  codec=codec)
    if strategy == "multi-source":
        return multi_source_plan(topo, new_node, state_bytes, sync,
                                 codec=codec)
    raise ValueError(f"unknown strategy {strategy!r}")


# ---------------------------------------------------------------------------
# Parallelism plans (ElasWave-style elastic resharding).
#
# A ParallelismPlan is the layout half of the planning contract: where
# ReplicationPlan says which bytes move between nodes, ParallelismPlan says
# which (dp, tp) mesh the cluster trains on and which byte interval of the
# model state each device therefore holds. ``reshard_plan`` bridges the two:
# given an old and a new layout it emits one ReplicationPlan per fetching
# node covering exactly the interval deltas, so mid-reshard churn rides the
# same shard-aligned credit and ``negotiate()`` machinery as scale-out
# replication.
# ---------------------------------------------------------------------------

RESHARD_MODES = ("never", "auto", "always")


@dataclass(frozen=True)
class ParallelismPlan:
    """One parallelism layout: mesh shape + axes + device assignment.

    ``devices`` lists node ids in row-major mesh order (the ``model`` axis
    fastest), so device ``i`` has tensor-parallel index ``i % tp`` and holds
    byte interval ``[tp_i*S//tp, (tp_i+1)*S//tp)`` of the training state.
    ``devices=None`` is a layout template (launch meshes bind real devices
    later). ``microbatch`` is the gradient-accumulation split the step-time
    model chose for this layout."""
    shape: Tuple[int, ...]
    axes: Tuple[str, ...] = ("data", "model")
    devices: Optional[Tuple[int, ...]] = None
    microbatch: int = 1

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError("shape/axes rank mismatch")
        if len(set(self.axes)) != len(self.axes):
            raise ValueError("duplicate mesh axis")
        if any(int(s) < 1 for s in self.shape):
            raise ValueError("mesh axis sizes must be >= 1")
        if self.devices is not None and len(self.devices) != self.n_devices:
            raise ValueError("device count != prod(shape)")

    @property
    def n_devices(self) -> int:
        return int(math.prod(self.shape))

    def axis_size(self, name: str, default: int = 1) -> int:
        for a, s in zip(self.axes, self.shape):
            if a == name:
                return int(s)
        return default

    @property
    def dp(self) -> int:
        """Data-parallel ways (the ``pod`` axis is DP-outer)."""
        return self.axis_size("data") * self.axis_size("pod")

    @property
    def tp(self) -> int:
        return self.axis_size("model")

    @property
    def pp(self) -> int:
        return self.axis_size("pipe")

    def tp_index(self, node: int) -> Optional[int]:
        if self.devices is None or node not in self.devices:
            return None
        return self.devices.index(node) % self.tp

    def shard_interval(self, node: int, state_bytes: int) -> Optional[Tuple[int, int]]:
        """Byte interval ``[lo, hi)`` of the state this node holds under
        tensor parallelism (the full state when ``tp == 1``); None when the
        node is not in the plan."""
        ti = self.tp_index(node)
        if ti is None:
            return None
        s = int(state_bytes)
        return (ti * s // self.tp, (ti + 1) * s // self.tp)

    def signature(self) -> List[int]:
        """Ledger-friendly shape (plain ints, JSON-stable)."""
        return [int(s) for s in self.shape]

    def to_json(self) -> dict:
        out = {"shape": self.signature(), "axes": list(self.axes),
               "microbatch": int(self.microbatch)}
        if self.devices is not None:
            out["devices"] = [int(d) for d in self.devices]
        return out

    @classmethod
    def from_json(cls, d: dict) -> "ParallelismPlan":
        devs = d.get("devices")
        return cls(tuple(int(s) for s in d["shape"]),
                   tuple(d.get("axes", ("data", "model"))),
                   tuple(int(x) for x in devs) if devs is not None else None,
                   int(d.get("microbatch", 1)))


def candidate_plans(devices: Sequence[int], *,
                    axes: Tuple[str, str] = ("data", "model"),
                    max_tp: Optional[int] = None) -> List[ParallelismPlan]:
    """The divisor chain of the surviving device count: one (dp, tp)
    candidate per divisor tp of n, smallest tp first (the paper's
    divisibility-chain argument applied to mesh shapes)."""
    devs = tuple(sorted(int(d) for d in devices))
    n = len(devs)
    out: List[ParallelismPlan] = []
    for t in range(1, n + 1):
        if n % t:
            continue
        if max_tp is not None and t > max_tp:
            break
        out.append(ParallelismPlan((n // t, t), tuple(axes), devs))
    return out


def replicated_fraction(tensor_sizes: Sequence[int], tp: int) -> float:
    """Fraction of state bytes a tp-way layout cannot shard (tensors whose
    byte size tp does not divide degrade to replication — the simulator-side
    stand-in for ``models.sharding._div``; ``shard_report`` measures the
    real-array counterpart)."""
    if tp <= 1 or not tensor_sizes:
        return 0.0
    total = float(sum(int(t) for t in tensor_sizes))
    if total <= 0:
        return 0.0
    bad = float(sum(int(t) for t in tensor_sizes if int(t) % tp))
    return bad / total


@dataclass(frozen=True)
class ReshardPolicy:
    """Step-time model + decision rule for churn-driven layout changes.

    The model is deliberately pure (a function of layout and byte counts
    only, never of simulator state), so SimBackend and TrainerBackend reach
    *identical* decisions on the same trace — ``link_s_per_byte`` is a
    policy parameter, not a topology measurement. Per device and step:

    * state memory: ``rf*S + (1-rf)*S/tp`` (``rf`` = non-divisible
      replicated fraction) — tp frees memory;
    * micro-batching: the per-device batch runs in gradient-accumulation
      passes whose size is bounded by free memory over
      ``act_bytes_per_sample``; each pass pays ``pass_overhead_s`` plus a
      tp activation all-reduce;
    * dp gradient all-reduce: ``2*(dp-1)/dp`` times the per-device state.

    ``auto`` reshards when the new layout's step time plus the movement
    cost amortized over ``amortize_steps`` beats the replicate-only layout
    by ``hysteresis``; ``always`` reshards whenever the best shape differs;
    ``never`` disables the path entirely (byte-identical replays)."""
    mode: str = "never"
    memory_bytes: float = float("inf")
    act_bytes_per_sample: float = 0.0
    act_comm_bytes: float = 0.0
    global_batch: int = 64
    compute_s_per_sample: float = 0.01
    pass_overhead_s: float = 0.05
    link_s_per_byte: float = 1e-8
    hysteresis: float = 0.05
    amortize_steps: int = 50
    max_tp: Optional[int] = None

    def __post_init__(self):
        if self.mode not in RESHARD_MODES:
            raise ValueError(f"unknown reshard mode {self.mode!r}")

    def state_per_device(self, tp: int, state_bytes: int,
                         tensor_sizes: Sequence[int]) -> float:
        s = float(state_bytes)
        if tp <= 1:
            return s
        rf = replicated_fraction(tensor_sizes, tp)
        return rf * s + (1.0 - rf) * s / tp

    def step_time(self, plan: ParallelismPlan, state_bytes: int,
                  tensor_sizes: Sequence[int]) -> float:
        dp, tp = plan.dp, plan.tp
        spd = self.state_per_device(tp, state_bytes, tensor_sizes)
        per_dev = math.ceil(self.global_batch / dp)
        if self.act_bytes_per_sample > 0 and math.isfinite(self.memory_bytes):
            free = self.memory_bytes - spd
            if free < self.act_bytes_per_sample:
                return float("inf")  # not even a one-sample micro-batch fits
            mb = max(1, min(per_dev, int(free // self.act_bytes_per_sample)))
        else:
            mb = per_dev
        passes = math.ceil(per_dev / mb)
        tp_comm = (2.0 * (tp - 1) / tp * self.act_comm_bytes
                   * self.link_s_per_byte if tp > 1 else 0.0)
        dp_comm = (2.0 * (dp - 1) / dp * spd * self.link_s_per_byte
                   if dp > 1 else 0.0)
        return (per_dev * self.compute_s_per_sample
                + passes * (self.pass_overhead_s + tp_comm) + dp_comm)

    def best_plan(self, devices: Sequence[int], state_bytes: int,
                  tensor_sizes: Sequence[int],
                  ) -> Tuple[ParallelismPlan, float]:
        """Best candidate on the divisor chain; ties keep the smaller tp
        (candidates iterate tp ascending)."""
        best: Optional[Tuple[ParallelismPlan, float]] = None
        for p in candidate_plans(devices, max_tp=self.max_tp):
            t = self.step_time(p, state_bytes, tensor_sizes)
            if best is None or t < best[1] - 1e-12:
                best = (p, t)
        assert best is not None, "no devices to plan over"
        return best


def default_reshard_policy(mode: str, state_bytes: int,
                           global_batch: int = 64) -> ReshardPolicy:
    """Engine default: a memory-constrained profile scaled to the cluster's
    state size (device memory 1.125x the full state, activation memory S/8
    per sample), so pure DP is gradient-accumulation-bound and tp layouts
    genuinely free memory — the regime where resharding pays."""
    s = float(max(int(state_bytes), 1))
    return ReshardPolicy(mode=mode, memory_bytes=1.125 * s,
                         act_bytes_per_sample=s / 8.0,
                         act_comm_bytes=s / 256.0,
                         global_batch=int(global_batch))


def _holding(old_plan: Optional[ParallelismPlan], node: int,
             state_bytes: int) -> Tuple[int, int]:
    """Byte interval ``node`` holds under the old layout. Nodes outside the
    old plan (pre-reshard members and fresh joiners, both of which
    replicated the *full* state) hold everything — which is also why the
    very first DP→TP reshard moves zero bytes."""
    if old_plan is None:
        return (0, int(state_bytes))
    iv = old_plan.shard_interval(node, state_bytes)
    return iv if iv is not None else (0, int(state_bytes))


def _interval_missing(need: Tuple[int, int],
                      have: Tuple[int, int]) -> List[Tuple[int, int]]:
    """``need`` minus ``have``, as up to two disjoint intervals."""
    lo, hi = need
    h0, h1 = have
    out = []
    if lo < min(h0, hi):
        out.append((lo, min(h0, hi)))
    if max(h1, lo) < hi:
        out.append((max(h1, lo), hi))
    return [iv for iv in out if iv[0] < iv[1]]


def reshard_moved_bytes(old_plan: Optional[ParallelismPlan],
                        new_plan: ParallelismPlan, state_bytes: int) -> int:
    """Total bytes the layout change must move — a pure function of the two
    plans (no topology), shared by both substrates so their decision
    records carry identical ``moved_bytes``."""
    moved = 0
    for node in (new_plan.devices or ()):
        need = new_plan.shard_interval(node, state_bytes)
        for a, b in _interval_missing(need, _holding(old_plan, node,
                                                     state_bytes)):
            moved += b - a
    return moved


@dataclass
class ReshardPlan:
    """The weight-movement schedule between two layouts: one codec-aware
    ReplicationPlan per node that must fetch interval deltas. Nodes whose
    new interval is a subset of their old holdings appear in no fetch
    (DP→TP reshards move nothing). ``lost_bytes`` counts intervals no
    surviving holder covers (all old holders of a tp shard died) — the
    checkpoint tier's problem, not the reshard's."""
    old_plan: Optional[ParallelismPlan]
    new_plan: ParallelismPlan
    fetches: Dict[int, ReplicationPlan]
    moved_bytes: int
    lost_bytes: int = 0


def reshard_plan(old_plan: Optional[ParallelismPlan],
                 new_plan: ParallelismPlan, topo: Topology, state_bytes: int,
                 *, codec: str = wire_codec.CODEC_NONE) -> ReshardPlan:
    """Compute the codec-aware movement schedule from ``old_plan`` to
    ``new_plan``. Missing intervals split at old-layout shard boundaries;
    each chunk pulls from the cheapest surviving holder (direct link first,
    else shortest path), with the codec negotiated per source link exactly
    as scale-out replication negotiates it. Every fetch's ``shard_size``
    divides all its streams, so mid-reshard churn credits delivered wire
    shards exactly (``replan_scale_out`` semantics)."""
    s = int(state_bytes)
    devs = list(new_plan.devices or ())
    holdings = {m: _holding(old_plan, m, s) for m in devs}
    bounds = sorted({x for iv in holdings.values() for x in iv} | {0, s})
    fetches: Dict[int, ReplicationPlan] = {}
    moved = 0
    lost = 0
    for node in devs:
        need = new_plan.shard_interval(node, s)
        missing: List[Tuple[int, int]] = []
        for a, b in _interval_missing(need, holdings[node]):
            cuts = [a] + [c for c in bounds if a < c < b] + [b]
            missing += list(zip(cuts, cuts[1:]))
        if not missing:
            continue
        sources: Dict[int, int] = {}
        routes: Dict[int, List[int]] = {}
        codecs: Dict[int, str] = {}
        worst = 0.0
        for a, b in missing:
            best = None
            for m in devs:
                if m == node:
                    continue
                h0, h1 = holdings[m]
                if not (h0 <= a and b <= h1):
                    continue
                if topo.has_link(m, node):
                    link = topo.link(m, node)
                    route = [m, node]
                    prop, trans = link.latency_s, link.trans_delay_per_byte
                    cname = wire_codec.negotiate(codec, link.bandwidth_mbps)
                elif topo.has_path(m, node):
                    route = topo.shortest_path(m, node, b - a)
                    prop, trans = topo.path_delay_per_byte(route)
                    cname = wire_codec.negotiate(
                        codec, wire_codec.link_bandwidth_mbps(
                            max(topo.link(x, y).trans_delay_per_byte
                                for x, y in zip(route, route[1:]))))
                else:
                    continue
                eff = wire_codec.effective_trans_s_per_byte(cname, trans)
                t = prop + (b - a) * eff
                if best is None or t < best[0] - 1e-15:
                    best = (t, m, route, cname)
            if best is None:
                lost += b - a
                continue
            t, m, route, cname = best
            sources[m] = sources.get(m, 0) + (b - a)
            routes[m] = route
            codecs[m] = cname
            worst = max(worst, t)
            moved += b - a
        if not sources:
            continue
        shard = 0
        for v in sources.values():
            shard = math.gcd(shard, int(v))
        cds, wire = _wire_fields(sources, codecs, shard)
        fetches[node] = ReplicationPlan("reshard", sources, routes, worst,
                                        shard_size=shard, codecs=cds,
                                        wire_sources=wire)
    return ReshardPlan(old_plan, new_plan, fetches, moved, lost)


def decide_reshard(policy: ReshardPolicy,
                   current: Optional[ParallelismPlan],
                   devices: Sequence[int], state_bytes: int,
                   tensor_sizes: Sequence[int], *,
                   mode: Optional[str] = None,
                   pinned_shape: Optional[Sequence[int]] = None,
                   ) -> Tuple[Optional[dict], ParallelismPlan]:
    """The shared (substrate-independent) decision point.

    Returns ``(decision, baseline)``: ``baseline`` is the replicate-only
    layout at the surviving size (old tp kept when it still divides, else
    pure DP); ``decision`` is None to stay on the baseline, or a dict with
    the chosen plan, both step times, and the pure ``moved_bytes`` both
    substrates ledger identically. A trace event's ``new_shape`` pins the
    target layout when it matches the surviving device count.

    Callers do not invoke this directly on membership change: the
    recovery-policy layer (``repro_torch.core.recovery``) routes here when it
    selects the ``reshard`` action, so the go/no-go is one ledgered
    decision alongside restore and park."""
    mode = policy.mode if mode is None else mode
    if mode not in RESHARD_MODES:
        raise ValueError(f"unknown reshard mode {mode!r}")
    devs = tuple(sorted(int(d) for d in devices))
    n = len(devs)
    old_tp = current.tp if current is not None else 1
    base_tp = old_tp if old_tp >= 1 and n % max(old_tp, 1) == 0 else 1
    baseline = ParallelismPlan((n // base_tp, base_tp), devices=devs)
    if mode == "never" or n == 0:
        return None, baseline
    cand = None
    if pinned_shape is not None:
        shape = tuple(int(x) for x in pinned_shape)
        if len(shape) == 2 and math.prod(shape) == n:
            cand = ParallelismPlan(shape, devices=devs)
            t_new = policy.step_time(cand, state_bytes, tensor_sizes)
    if cand is None:
        cand, t_new = policy.best_plan(devs, state_bytes, tensor_sizes)
    t_base = policy.step_time(baseline, state_bytes, tensor_sizes)
    moved = reshard_moved_bytes(current, cand, state_bytes)
    # Once tp > 1, a membership change *forces* movement (survivors' shard
    # intervals shift) — there is no zero-cost replicate-only fallback, so
    # both auto and always reshard to the best layout.
    forced = old_tp > 1
    if not forced:
        if mode == "always":
            if cand.shape == baseline.shape:
                return None, baseline
        else:  # auto: amortized movement + hysteresis must beat the baseline
            amortized = (moved * policy.link_s_per_byte
                         / max(policy.amortize_steps, 1))
            if not (t_new + amortized < t_base * (1.0 - policy.hysteresis)):
                return None, baseline
    return ({"plan": cand, "step_s": t_new, "baseline_step_s": t_base,
             "moved_bytes": int(moved),
             "old_shape": (current.signature() if current is not None
                           else baseline.signature()),
             "new_shape": cand.signature()}, baseline)


def trim_tensor_sizes(tensor_sizes: Sequence[int], nbytes: int) -> List[int]:
    """Prefix of ``tensor_sizes`` covering exactly ``nbytes`` (last entry
    truncated). Used when re-planning an interrupted replication: only the
    not-yet-delivered bytes need new sources."""
    out: List[int] = []
    left = int(nbytes)
    for t in tensor_sizes:
        if left <= 0:
            break
        take = min(int(t), left)
        out.append(take)
        left -= take
    if left > 0:  # caller asked for more than the manifest holds
        out.append(left)
    return out
