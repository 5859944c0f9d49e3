"""ElasticTrainer: stop-free autoscaling over logical devices of one card,
from ``repro/elastic/trainer.py``.

The paper's mechanism on real tensors: synchronous data-parallel training
whose membership grows and shrinks without restarts.

  * The pool holds logical devices (objects with an ``.id``), all bound to
    one ``torch.device``. A step runs on the global batch (per-device batch
    × active count), which is the same math as the JAX trainer's jit over a
    data-parallel mesh.
  * scale-out: a joining device gets the training state via a Chaos
    replication plan (Algorithm 1/2 over the per-device link model); under
    a non-``none`` codec the fp32 state is int8-encoded and decoded through
    the shard-codec kernels, the wire bytes are reported and the ``scale/2``
    round-trip bound is checked. The installed state stays exact.
  * scale-in / failure: the device leaves; the state survives (synchronous
    DP ⇒ identical replicas).
  * link events (degrade / sever / restore / loss) land on a per-device
    link-override table over ``link_model`` and reshape later plans.
  * reshard: ``apply_reshard`` records the (dp, tp) layout and the
    micro-batch split a reshard policy chose; a membership change resets
    them to tp 1, micro-batch 1.
  * recovery tiers (``attach_recovery``): ``checkpoint`` pushes the live
    state to a ``MemoryReplicaStore`` (shards on the card) and/or an
    ``AsyncCheckpointer`` (a host copy written to disk off-thread);
    ``restore_from`` reinstalls it from either, bit for bit.
  * churn traces: ``replay_scenario`` drives the trainer through the
    ``ChurnEngine`` with :class:`TrainerBackend`, the same pipeline and
    ledger as the JAX package's trainer and simulator.

On one card there is nothing to move and nothing to recompile: the JAX
trainer's per-mesh compile cache and its ``device_put`` onto the enlarged
or resharded mesh have no counterpart, and the state tensors stay where
they are. ``apply_reshard`` therefore moves nothing; the JAX step does not
read the micro-batch split either.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core import codec as wire_codec
from repro_torch.core.codec import MBPS
from repro_torch.core.engine import MIN_LINK_MBPS, ChurnEngine, ChurnEvent, EventLedger
from repro_torch.core.plans import ParallelismPlan, ReshardPolicy
from repro_torch.core.recovery import FaultContext, decision_detail, make_policy
from repro_torch.core.replication import (
    decode_state,
    encode_state,
    plan_replication,
    roundtrip_max_error_ok,
)
from repro_torch.core.sharding_alg import NeighborLink

#: per-byte transmission delay standing in for a severed link: the Alg-1/2
#: planner derates such a neighbor to (near) zero shards.
SEVERED_TRANS_S_PER_BYTE = 1.0


@dataclass(frozen=True)
class LogicalDevice:
    """One data-parallel member; several share a physical device."""
    id: int
    device: torch.device

    def __str__(self) -> str:
        return f"{self.device}#{self.id}"


@dataclass
class ScaleEvent:
    kind: str
    device: str
    step: int
    wall_s: float
    plan_summary: Optional[dict] = None


class ElasticTrainer:
    def __init__(self, model, *, devices: Optional[Sequence] = None,
                 pool_size: int = 8, initial: int = 2,
                 per_device_batch: int = 2,
                 link_model: Optional[Callable[[int], NeighborLink]] = None,
                 on_reshard: Optional[Callable[[List[int]], None]] = None,
                 seed: int = 0, codec: str = wire_codec.CODEC_NONE):
        """``devices``: the pool; by default ``pool_size`` logical devices
        on the model's device."""
        self.model = model
        #: wire codec for scale-out state movement ("none" / "int8" / ...).
        self.codec = wire_codec.validate_policy(codec)
        self.pool = list(devices if devices is not None else
                         (LogicalDevice(i, model.device) for i in range(pool_size)))
        if not 1 <= initial <= len(self.pool):
            raise ValueError(f"initial={initial} outside a pool of {len(self.pool)}")
        self.active: List = list(self.pool[:initial])
        self.per_device_batch = per_device_batch
        self.on_reshard = on_reshard
        self.link_model = link_model or (lambda i: NeighborLink(0.001, 1e-9, 0.0))
        # Trace link events override the static link model per device id,
        # keyed per (device, trace link); the slowest impairment wins.
        self._link_overrides: Dict[int, Dict[object, NeighborLink]] = {}
        self._step_fn = None
        self.last_backend = None
        # Current parallelism layout: tp-ways of tensor parallelism over the
        # active devices and the micro-batch split the reshard policy chose.
        self._tp = 1
        self._microbatch = 1
        self.step_count = 0
        self.events: List[ScaleEvent] = []
        self._step_times: Dict[int, list] = {}
        self.state = None
        self._seed = seed
        # Recovery tiers (attach_recovery): the in-memory neighbor-replica
        # store (fast tier) and the async disk checkpointer (cold tier).
        self.replica_store = None
        self.checkpointer = None
        self._replica_owner = 0

    @property
    def tp(self) -> int:
        return self._tp

    def parallelism_plan(self) -> ParallelismPlan:
        """The layout the trainer is currently running, as the same plan
        object the churn engine reasons about."""
        n = len(self.active)
        return ParallelismPlan((n // self._tp, self._tp),
                               devices=tuple(self.device_ids()),
                               microbatch=self._microbatch)

    @property
    def global_batch(self) -> int:
        return self.per_device_batch * len(self.active)

    def device_ids(self) -> List[int]:
        return [d.id for d in self.active]

    def _sync(self) -> None:
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)

    # -- per-device link model (trace link events land here) --------------------

    def effective_link(self, device_id: int) -> NeighborLink:
        """The link the planner sees for ``device_id``: the slowest
        trace-applied override still in force, or the static link model."""
        ovs = self._link_overrides.get(device_id)
        if not ovs:
            return self.link_model(device_id)
        return max(ovs.values(), key=lambda nl: nl.trans_s_per_byte)

    def replication_neighbors(self) -> Dict[int, NeighborLink]:
        """Measured neighbor set a joining device plans over — every active
        device through its *effective* link."""
        return {d.id: self.effective_link(d.id) for d in self.active}

    def apply_link_event(self, kind: str, device_ids: Sequence[int],
                         bandwidth_mbps: Optional[float] = None,
                         latency_s: Optional[float] = None,
                         link: Optional[Sequence[int]] = None,
                         loss_rate: Optional[float] = None):
        """Map a trace link event onto the per-device link model: degrade
        (``link-degrade``), sever (``link-failure`` / ``link-leave`` /
        ``link-fault``), inflate by retransmissions (``link-loss``) or
        restore (``link-join``) each named device's link, per trace link.
        Same semantics as the JAX trainer's method."""
        key = tuple(sorted(link)) if link is not None else None
        if bandwidth_mbps is not None:
            bandwidth_mbps = max(float(bandwidth_mbps), MIN_LINK_MBPS)
        for did in device_ids:
            base = self.link_model(did)
            ovs = self._link_overrides.setdefault(did, {})
            if kind == "link-join":
                if bandwidth_mbps is None:
                    ovs.pop(key, None)
                else:
                    ovs[key] = NeighborLink(
                        latency_s if latency_s is not None else base.prop_s,
                        1.0 / (bandwidth_mbps * MBPS), base.sync_s)
            elif kind == "link-degrade":
                cur = ovs.get(key, base)
                trans = (1.0 / (bandwidth_mbps * MBPS)
                         if bandwidth_mbps is not None
                         else cur.trans_s_per_byte)
                ovs[key] = NeighborLink(
                    latency_s if latency_s is not None else cur.prop_s,
                    trans, cur.sync_s)
            elif kind in ("link-leave", "link-failure", "link-fault"):
                ovs[key] = NeighborLink(
                    base.prop_s, SEVERED_TRANS_S_PER_BYTE, base.sync_s)
            elif kind == "link-loss":
                # Retransmissions inflate the per-byte time by 1/(1-loss); a
                # missing rate or a rate >= 1 severs the link outright.
                rate = 1.0 if loss_rate is None else float(loss_rate)
                rate = min(max(rate, 0.0), 1.0)
                if rate >= 1.0:
                    ovs[key] = NeighborLink(
                        base.prop_s, SEVERED_TRANS_S_PER_BYTE, base.sync_s)
                else:
                    cur = ovs.get(key, base)
                    ovs[key] = NeighborLink(
                        cur.prop_s, cur.trans_s_per_byte / (1.0 - rate),
                        cur.sync_s)
            else:
                raise ValueError(f"not a link event kind: {kind!r}")

    # -- lifecycle ---------------------------------------------------------------

    def init(self, generator: Optional[torch.Generator] = None, state=None):
        """Initialise the training state from ``generator`` (default: seeded
        with ``seed``), or install a given ``state`` (e.g. one converted
        from the JAX package)."""
        if state is None:
            if generator is None:
                generator = torch.Generator(device=self.model.device)
                generator.manual_seed(self._seed)
            state = self.model.init_train_state(generator)
        self.state = state
        if self.on_reshard:
            self.on_reshard(self.device_ids())
        return self.state

    def step(self, batch: dict):
        """batch arrays lead with global_batch (= per_device × n_active):
        the tokens and a vlm's patches or an encdec model's frames. Every array goes
        to the model's device and the whole dict to the step, as the JAX
        trainer puts the whole batch on its mesh."""
        n = len(self.active)
        moved = {}
        for key, x in batch.items():
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.asarray(x))
            if x.shape[0] != self.global_batch:
                raise ValueError(f"batch[{key!r}] of {x.shape[0]} rows; the "
                                 f"global batch is {self.global_batch}")
            moved[key] = x.to(self.model.device, non_blocking=True)
        if self._step_fn is None:
            self._step_fn = self.model.make_train_step()
        t0 = time.perf_counter()
        self.state, metrics = self._step_fn(self.state, moved)
        metrics = {k: float(v) for k, v in metrics.items()}
        dt = time.perf_counter() - t0
        self._step_times.setdefault(n, []).append(dt)
        self.step_count += 1
        return metrics

    # -- elasticity -----------------------------------------------------------------

    def scale_out(self, device=None, codec: Optional[str] = None) -> ScaleEvent:
        """Stop-free join: plan shard pulls with Chaos, admit the device,
        reshard the data pipeline. No checkpoint, no restart.

        Under a non-``none`` codec (standing policy or per-call override)
        the fp32 state is int8-encoded and decoded through the shard-codec
        kernels to account wire bytes and check the ``scale/2`` round-trip
        bound; the state the trainer keeps stays exact."""
        eff_codec = self.codec if codec is None else wire_codec.validate_policy(codec)
        candidates = [d for d in self.pool if d not in self.active]
        if device is None:
            if not candidates:
                raise RuntimeError("device pool exhausted")
            device = candidates[0]
        t0 = time.perf_counter()
        neighbors = self.replication_neighbors()
        plan = plan_replication(self.state, neighbors)
        codec_summary = None
        if eff_codec != wire_codec.CODEC_NONE:
            enc, manifest, wire = encode_state(self.state, eff_codec)
            decoded = decode_state(enc, manifest)
            if not roundtrip_max_error_ok(self.state, decoded, enc):
                raise RuntimeError(
                    "shard codec round-trip exceeded the scale/2 error bound")
            codec_summary = {
                "codec": eff_codec,
                "payload_bytes": int(manifest.total_bytes),
                "wire_bytes": int(wire),
                "wire_reduction": (float(manifest.total_bytes) / wire
                                   if wire else 1.0),
            }
            del enc, decoded
        # A membership change resets the layout to the replicate-only
        # baseline; a reshard policy re-applies tp via apply_reshard.
        self._tp = 1
        self._microbatch = 1
        self.active = self.active + [device]
        self._sync()
        wall = time.perf_counter() - t0
        if self.on_reshard:
            self.on_reshard(self.device_ids())
        summary = {
            "shard_size": plan.assignment.shard_size,
            "n_shards": plan.assignment.n_shards,
            "bytes_per_source": plan.bytes_per_source,
            "predicted_completion_s": plan.assignment.completion_s,
        }
        if codec_summary is not None:
            summary["codec"] = codec_summary
        ev = ScaleEvent("scale-out", str(device), self.step_count, wall, summary)
        self.events.append(ev)
        return ev

    def scale_in(self, device=None, failure: bool = False) -> ScaleEvent:
        """Node leaves/fails: the state survives on the remaining replicas
        (synchronous DP). Stop-free."""
        if device is None:
            device = self.active[-1]
        if len(self.active) <= 1:
            raise RuntimeError("cannot scale below one device")
        t0 = time.perf_counter()
        self._tp = 1
        self._microbatch = 1
        self.active = [d for d in self.active if d != device]
        self._sync()
        wall = time.perf_counter() - t0
        if self.on_reshard:
            self.on_reshard(self.device_ids())
        ev = ScaleEvent("node-failure" if failure else "scale-in",
                        str(device), self.step_count, wall)
        self.events.append(ev)
        return ev

    def apply_reshard(self, tp: int, microbatch: int = 1) -> ScaleEvent:
        """Apply a parallelism-plan change: validate ``tp`` against the
        active devices and record the (dp, tp) layout and micro-batch
        split. Logical devices of one card hold the whole state, so nothing
        moves (the JAX trainer's ``device_put`` to the new shardings)."""
        tp = int(tp)
        n = len(self.active)
        if tp < 1 or n % tp:
            raise ValueError(f"tp={tp} does not divide {n} active devices")
        t0 = time.perf_counter()
        self._tp = tp
        self._microbatch = max(1, int(microbatch))
        wall = time.perf_counter() - t0
        ev = ScaleEvent("reshard", str(self.active[0]), self.step_count,
                        wall, {"shape": [n // tp, tp],
                               "microbatch": self._microbatch})
        self.events.append(ev)
        if self.on_reshard:
            self.on_reshard(self.device_ids())
        return ev

    # -- recovery tiers (repro_torch.checkpoint wired into the trainer) --------

    def attach_recovery(self, *, replica_store=None, checkpointer=None,
                        owner: int = 0):
        """Wire the checkpoint layer in: a
        :class:`~repro_torch.checkpoint.MemoryReplicaStore` (fast tier —
        neighbor replicas) and/or an
        :class:`~repro_torch.checkpoint.AsyncCheckpointer` (cold tier —
        durable disk). ``owner`` keys the replica set (the coordinator's
        trace node id)."""
        self.replica_store = replica_store
        self.checkpointer = checkpointer
        self._replica_owner = int(owner)

    def checkpoint(self, step: Optional[int] = None) -> dict:
        """Push the current training state to every attached tier.

        The replica store shards the live state across the active devices'
        effective links (Alg 1/2 balanced; its flatten copies the state),
        and the async checkpointer copies it to the host and writes it to
        disk off-thread. Returns which tiers took the push — both restore
        paths reproduce this state bit for bit."""
        if self.replica_store is None and self.checkpointer is None:
            raise RuntimeError("no recovery tier attached (attach_recovery)")
        step = self.step_count if step is None else int(step)
        tiers = []
        if self.replica_store is not None:
            self.replica_store.push(self._replica_owner, step, self.state,
                                    self.replication_neighbors())
            tiers.append("replica")
        if self.checkpointer is not None:
            self.checkpointer.save(step, self.state)
            tiers.append("checkpoint")
        return {"step": step, "tiers": tiers}

    def restore_from(self, tier: str) -> int:
        """Reinstall the training state from a recovery tier ("replica" or
        "checkpoint") on the model's device; returns the restored step. Both
        tiers round-trip the exact bytes the matching :meth:`checkpoint`
        pushed, so restoring from either lands bit-identical state."""
        if tier == "replica":
            if self.replica_store is None:
                raise RuntimeError("no replica store attached")
            tree, step = self.replica_store.restore(self._replica_owner)
        elif tier == "checkpoint":
            if self.checkpointer is None:
                raise RuntimeError("no checkpointer attached")
            self.checkpointer.wait()  # async writes must land before reads
            tree, step = self.checkpointer.restore_latest(self.state)
            if tree is None:
                raise RuntimeError("no checkpoint on disk")
        else:
            raise ValueError(f"unknown recovery tier {tier!r}")
        device = self.model.device
        self.state = T.tree_map(lambda t: t.to(device), tree)
        self._sync()
        return step

    # -- scenario replay (the unified churn pipeline) ---------------------------------

    def replay_scenario(self, events, *, batch_fn=None, steps_between: int = 1,
                        min_active: int = 2, reshard: str = "never",
                        reshard_policy: Optional[ReshardPolicy] = None,
                        state_bytes: int = 0,
                        tensor_sizes: Optional[Sequence[int]] = None,
                        policy="fixed",
                        ) -> EventLedger:
        """Drive this trainer with a churn trace through the same
        :class:`~repro_torch.core.engine.ChurnEngine` pipeline the
        simulator uses. ``policy`` selects the recovery policy
        (``repro_torch.core.recovery``) — the same spec ``SimBackend``
        gets yields the same decisions on the same trace.
        ``batch_fn()`` gives the global batch of each step taken before an
        event. Returns the event ledger; per-event wall times land in
        ``self.events``, and the replay's backend stays in
        ``self.last_backend`` for a metrics scrape
        (``core.telemetry.collect_trainer_backend``)."""
        self.last_backend = TrainerBackend(self, batch_fn=batch_fn,
                                           steps_between=steps_between,
                                           min_active=min_active,
                                           reshard=reshard,
                                           reshard_policy=reshard_policy,
                                           state_bytes=state_bytes,
                                           tensor_sizes=tensor_sizes,
                                           policy=policy)
        return ChurnEngine(self.last_backend).run(events)

    def metrics_snapshot(self) -> dict:
        """Point-in-time read of training observables for telemetry scrapes.
        Pure read; wall-clock step times stay raw."""
        return {
            "n_active": len(self.active),
            "step_count": self.step_count,
            "step_times": {n: list(ts) for n, ts in
                           sorted(self._step_times.items())},
        }

    # -- stragglers ------------------------------------------------------------------

    def straggler_report(self, threshold: float = 2.0) -> dict:
        """Step-time statistics per cluster size (the first step at each
        size is dropped, as in the JAX trainer where it compiles)."""
        out = {}
        for n, times in self._step_times.items():
            arr = np.asarray(times[1:] or times)
            out[n] = {"mean_s": float(arr.mean()),
                      "p95_s": float(np.percentile(arr, 95)),
                      "n_steps": len(arr)}
        return out


# ---------------------------------------------------------------------------
# Churn-engine backend: the trace files the JAX simulator replays drive the
# port's ElasticTrainer.
# ---------------------------------------------------------------------------


class TrainerBackend:
    """Executes churn events on an :class:`ElasticTrainer`, from the JAX
    package's ``TrainerBackend``, line for line.

    Real hardware applies events sequentially (there is no virtual clock to
    overlap on), but the pipeline, the trace format, and the ledger are
    shared with the JAX package's ``SimBackend`` and ``TrainerBackend`` —
    one scenario file exercises the protocol in simulation and on the
    card. It also drives membership-only trainer doubles that lack the
    recovery tiers (``getattr`` below). Ledger
    records carry only deterministic fields (device ids, step indices, plan
    shapes); wall-clock timings stay in ``trainer.events``.

    Link events resolve their endpoints to devices (via the trace-node map,
    falling back to matching pool device ids) and are applied through
    :meth:`ElasticTrainer.apply_link_event`, so degraded or severed links
    change the plan shapes of later joins; events whose endpoints resolve to
    no device stay ``noop-link`` for trace parity.

    Fault kinds route like their detected outcomes: there is no virtual
    clock to sweep on, so the trainer's monitor stand-in "detects" at the
    next event boundary — ``node-fault`` scales the device in as a failure,
    ``link-fault`` severs the per-device link, ``link-loss`` inflates the
    link's effective per-byte time by the goodput factor. Ledger records
    keep the fault kind and mark ``detected`` so detected-mode traces stay
    diffable across substrates.
    """

    def __init__(self, trainer: ElasticTrainer, *, batch_fn=None,
                 steps_between: int = 1, min_active: int = 2,
                 reshard: str = "never",
                 reshard_policy: Optional[ReshardPolicy] = None,
                 state_bytes: int = 0,
                 tensor_sizes: Optional[Sequence[int]] = None,
                 policy="fixed"):
        self.trainer = trainer
        self.batch_fn = batch_fn
        self.steps_between = steps_between
        self.min_active = min_active
        self.results: Dict[int, object] = {}
        self._node_device: Dict[int, object] = {}  # trace node id -> device
        self._departed: set = set()  # trace nodes that already left/failed
        self._link_faulted: set = set()  # trace links with an applied fault
        # Unified recovery policy: the trainer backend runs the *same* pure
        # decision layer as SimBackend (core.recovery over trace
        # membership + byte counts), so one trace yields identical
        # ``recovery-decided`` / reshard decisions on both substrates
        # (``recovery.decision_digest`` pins the parity); the chosen tp is
        # then applied on real arrays when it divides the live device
        # count. ``state_bytes`` / ``tensor_sizes`` parameterize the shared
        # step-time model — pass the simulated cluster's values for
        # cross-substrate parity.
        self.policy = make_policy(policy, reshard=reshard,
                                  reshard_policy=reshard_policy,
                                  state_bytes=int(state_bytes) or 1)
        self.degraded = False
        self.state_bytes = int(state_bytes)
        self.tensor_sizes = list(tensor_sizes or ())
        self.plan: Optional[ParallelismPlan] = None
        #: trace-level membership (node ids), mirroring the simulator's
        #: ``topo.active_nodes()`` — the decision input that must match.
        self._members = {d.id for d in trainer.active}
        #: device standing in for the scheduler/coordinator (defaults to
        #: the lowest-id active device — the simulator's home convention);
        #: a replayed ``scheduler-fault`` moves this, keeping one trace
        #: file runnable on both substrates.
        self._coordinator = None

    # -- engine protocol -----------------------------------------------------

    def advance_to(self, t: float, ledger: EventLedger):
        if self.batch_fn is None:
            return
        for _ in range(self.steps_between):
            self.trainer.step(self.batch_fn())

    def metrics_snapshot(self) -> Dict:
        """Backend-level telemetry snapshot, mirroring
        ``SimBackend.metrics_snapshot``'s shape where both substrates have
        the observable. Pure read."""
        return {
            "n_active": len(self.trainer.active),
            "degraded": self.degraded,
            "members": sorted(self._members, key=str),
        }

    def coordinator_device(self):
        """The device currently playing scheduler: the explicitly installed
        one while it remains active, else the lowest-id active device."""
        tr = self.trainer
        if self._coordinator is not None and self._coordinator in tr.active:
            return self._coordinator
        return min(tr.active, key=lambda d: d.id) if tr.active else None

    def handle(self, seq: int, ev: ChurnEvent, ledger: EventLedger):
        tr = self.trainer
        if ev.kind == "scheduler-fault":
            # Coordinator swap, trainer-side: no virtual clock to elect on,
            # so the fail-over resolves at the event boundary — the dead
            # coordinator's device is shed (it failed silently) and the
            # deterministic successor (trace preference first, else lowest
            # remaining device id) takes the role. Training state survives
            # on the replicas; the next step recompiles at most.
            old = self.coordinator_device()
            if ev.node is not None and (old is None
                                        or self._device_for(ev.node)
                                        is not old):
                # Mirror SimBackend: a fault naming a non-current home
                # (e.g. re-killing the original scheduler after an earlier
                # fail-over moved the role) is skipped on both substrates.
                ledger.append(seq, ev.t, ev.kind, ev.node,
                              "skipped-not-scheduler",
                              {"home": old.id if old else None})
                return
            cands = sorted((d for d in tr.active if d is not old),
                           key=lambda d: d.id)
            if old is None or not cands:
                ledger.append(seq, ev.t, ev.kind, ev.node,
                              "skipped-no-deputy")
                return
            preferred = self._device_for(ev.new_home)
            new = (preferred if preferred is not None and preferred in cands
                   else cands[0])
            shed = False
            if len(tr.active) > self.min_active:
                sev = tr.scale_in(old, failure=True)
                self.results[seq] = sev
                shed = True
                self._members.discard(old.id)
            self._coordinator = new
            ledger.append(seq, ev.t, ev.kind, (old.id, new.id), "failover", {
                "old_home": old.id, "new_home": new.id, "shed": shed,
                "n_active": len(tr.active), "detected": True,
            })
            return
        if ev.kind == "checkpoint":
            # Trace-borne checkpoint request, mirroring SimBackend: push to
            # the attached recovery tiers now, or acknowledge with a
            # terminal skip so the trace stays diffable across substrates.
            # getattr: trainer doubles in older tests predate the tiers.
            coord = self.coordinator_device()
            subject = (ev.node if ev.node is not None
                       else (coord.id if coord is not None else -1))
            if (getattr(tr, "replica_store", None) is None
                    and getattr(tr, "checkpointer", None) is None):
                ledger.append(seq, ev.t, ev.kind, subject,
                              "ckpt-skipped-no-checkpointer")
                return
            info = tr.checkpoint()
            ledger.append(seq, ev.t, ev.kind, subject, "ckpt-saved",
                          {"step": info["step"], "tiers": info["tiers"]})
            return
        if ev.kind == "join":
            free = [d for d in tr.pool if d not in tr.active]
            if not free:
                ledger.append(seq, ev.t, ev.kind, ev.node, "skipped-pool-exhausted")
                return
            device = free[0]
            # Pass codec only when the event carries one: trainer doubles
            # (tests' fakes) may predate the kwarg, and an absent field
            # must leave the trainer's standing policy untouched.
            if ev.codec is None:
                sev = tr.scale_out(device)
            else:
                sev = tr.scale_out(device, codec=ev.codec)
            # The device may be a reuse of one an earlier trace node shed;
            # purge stale mappings so later events can't mis-target it.
            self._node_device = {n: d for n, d in self._node_device.items()
                                 if d is not device}
            self._node_device[ev.node] = device
            self._departed.discard(ev.node)
            self.results[seq] = sev
            detail = {
                "device": device.id, "step": sev.step,
                "n_active": len(tr.active),
                "n_shards": sev.plan_summary["n_shards"],
                "shard_size": sev.plan_summary["shard_size"],
            }
            # Codec wire accounting rides the ledger only when a codec was
            # active — codec-none traces stay byte-identical across PRs.
            if "codec" in sev.plan_summary:
                cs = sev.plan_summary["codec"]
                detail["codec"] = cs["codec"]
                detail["wire_bytes"] = cs["wire_bytes"]
            ledger.append(seq, ev.t, ev.kind, ev.node, "scale-out", detail)
            self._members.add(ev.node)
            self._maybe_reshard(seq, ev, ledger)
            return
        if ev.kind in ("leave", "node-failure", "node-fault"):
            failure = ev.kind in ("node-failure", "node-fault")
            detected = ev.kind == "node-fault"
            if ev.node in self._departed:  # duplicate departure in the trace
                ledger.append(seq, ev.t, ev.kind, ev.node, "skipped-not-active")
                return
            if len(tr.active) <= self.min_active:
                ledger.append(seq, ev.t, ev.kind, ev.node, "skipped-min-cluster")
                return
            device = self._node_device.get(ev.node)
            if device is not None and device not in tr.active:
                ledger.append(seq, ev.t, ev.kind, ev.node, "skipped-not-active")
                return
            if device is None:
                # Unmapped trace node: deterministically shed the newest
                # device that isn't standing in for a mapped trace node
                # (pool order is stable).
                mapped_live = {d for d in self._node_device.values()
                               if d in tr.active}
                cands = [d for d in tr.active if d not in mapped_live]
                device = (cands or tr.active)[-1]
            sev = tr.scale_in(device, failure=failure)
            self._node_device[ev.node] = device
            self._departed.add(ev.node)
            self.results[seq] = sev
            detail = {"device": device.id, "step": sev.step,
                      "n_active": len(tr.active)}
            if detected:
                detail["detected"] = True
            ledger.append(seq, ev.t, ev.kind, ev.node,
                          "node-failed" if failure else "scaled-in", detail)
            self._members.discard(ev.node if ev.node in self._members
                                  else device.id)
            if failure:
                # The same per-fault-class selection SimBackend runs: build
                # the substrate-independent context fields, decide, record.
                # Execution differs by substrate (state already lives on
                # the surviving replicas here; there is no wire to restore
                # over), but the *choice* — what decision_digest projects —
                # must match the simulator's.
                ctx = FaultContext(
                    kind="node-failure", t=ev.t, subject=(ev.node,),
                    n_active=len(tr.active), min_active=self.min_active,
                    state_bytes=self.state_bytes,
                    replica_feasible=(self.plan is None or self.plan.dp > 1),
                    ckpt_available=(getattr(tr, "checkpointer", None)
                                    is not None),
                    override=ev.recovery)
                dec = self.policy.decide(ctx)
                self._record_decision(seq, ev.t, ledger, ctx, dec)
                if dec.action == "park-and-degrade":
                    # No restore: train on without the dead device's
                    # redundancy. Terminal record mirrors the simulator's.
                    self.degraded = True
                    ledger.append(seq, ev.t, "recovery", ev.node,
                                  "parked-degraded",
                                  {"n_active": len(tr.active)})
            self._maybe_reshard(seq, ev, ledger)
            return
        # Link events: project the trace link onto its endpoint devices'
        # per-device link model. Unresolvable endpoints keep the historical
        # noop-link acknowledgement for trace parity.
        dev_ids = sorted({d.id for d in (self._device_for(ev.u),
                                         self._device_for(ev.v))
                          if d is not None and d in tr.active})
        if not dev_ids:
            ledger.append(seq, ev.t, ev.kind, (ev.u, ev.v), "noop-link")
            return
        link_key = (min(ev.u, ev.v), max(ev.u, ev.v))
        if ev.kind in ("link-fault", "link-loss"):
            # Mirror SimBackend's duplicate-fault dedup: re-applying a loss
            # factor would compound 1/(1-loss) and diverge the substrates.
            if link_key in self._link_faulted:
                ledger.append(seq, ev.t, ev.kind, (ev.u, ev.v),
                              "skipped-duplicate-fault")
                return
            self._link_faulted.add(link_key)
        elif ev.kind == "link-join":
            self._link_faulted.discard(link_key)
        tr.apply_link_event(ev.kind, dev_ids, bandwidth_mbps=ev.bandwidth_mbps,
                            latency_s=ev.latency_s, link=(ev.u, ev.v),
                            loss_rate=ev.loss_rate)
        action = {"link-join": "link-restored",
                  "link-degrade": "link-degraded",
                  "link-loss": "link-lossy"}.get(ev.kind, "link-severed")
        detail = {"devices": dev_ids}
        if ev.bandwidth_mbps is not None:
            detail["bandwidth_mbps"] = ev.bandwidth_mbps
        if ev.loss_rate is not None:
            detail["loss_rate"] = ev.loss_rate
        if ev.kind in ("link-fault", "link-loss"):
            detail["detected"] = True
        ledger.append(seq, ev.t, ev.kind, (ev.u, ev.v), action, detail)

    def _record_decision(self, seq: int, t: float, ledger: EventLedger,
                         ctx: FaultContext, dec) -> None:
        """Mirror of ``SimBackend._record_decision``: silent policies write
        nothing (pre-policy ledgers stay byte-identical), adaptive/forced
        choices become ``recovery-decided`` records whose parity projection
        (``recovery.decision_digest``) matches the simulator's."""
        if not (self.policy.records or dec.forced):
            return
        ledger.append(seq, t, "recovery", ctx.subject, "recovery-decided",
                      decision_detail(ctx, dec))

    def _maybe_reshard(self, seq: int, ev: ChurnEvent, ledger: EventLedger):
        """The trainer side of parallelism-plan resharding: route the
        membership change through the shared recovery policy (the same
        ``evaluate_membership`` SimBackend consults, forced replicate-only
        fall-back included), ledger the decision with the *pure*
        ``moved_bytes`` (identical to SimBackend's), and apply the chosen
        tp on real arrays. There is no virtual clock, so ``reshard-ready``
        lands immediately after ``reshard-started`` (recovery *time* is the
        simulator's job; layout parity is this one's)."""
        coord = self.coordinator_device()
        devices = tuple(sorted(self._members))
        ctx = FaultContext(
            kind="membership-change", t=ev.t,
            subject=(coord.id if coord is not None else -1,),
            n_active=len(devices), min_active=self.min_active,
            state_bytes=self.state_bytes,
            plan=self.plan, reshard_mode=ev.reshard,
            pinned_shape=ev.new_shape, devices=devices,
            tensor_sizes=tuple(self.tensor_sizes))
        dec = self.policy.decide(ctx)
        self._record_decision(seq, ev.t, ledger, ctx, dec)
        if dec.reshard is None:
            if dec.baseline is not None and self.plan is not None:
                self.plan = dec.baseline
            return
        decision = dec.reshard
        cand: ParallelismPlan = decision["plan"]
        tr = self.trainer
        coord = self.coordinator_device()
        subject = coord.id if coord is not None else -1
        ledger.append(seq, ev.t, "reshard", subject, "reshard-started", {
            "old_shape": decision["old_shape"],
            "new_shape": decision["new_shape"],
            "moved_bytes": decision["moved_bytes"],
            "step_s": decision["step_s"],
            "baseline_step_s": decision["baseline_step_s"],
        })
        self.plan = cand
        if cand.tp >= 1 and len(tr.active) % cand.tp == 0:
            sev = tr.apply_reshard(cand.tp, microbatch=cand.microbatch)
            self.results[seq] = sev
        ledger.append(seq, ev.t, "reshard", subject, "reshard-ready", {
            "old_shape": decision["old_shape"],
            "new_shape": decision["new_shape"],
            "moved_bytes": decision["moved_bytes"],
        })

    def _device_for(self, node):
        """Trace node → device: the explicit map from joins/leaves first,
        else the pool device whose id equals the trace node id (the base
        cluster's natural labeling)."""
        if node is None:
            return None
        d = self._node_device.get(node)
        if d is not None:
            return d
        for d in self.trainer.pool:
            if d.id == node:
                return d
        return None

    def drain(self, ledger: EventLedger):
        pass
