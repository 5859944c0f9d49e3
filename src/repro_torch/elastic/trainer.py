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

On one card there is nothing to move and nothing to recompile: the JAX
trainer's per-mesh compile cache and its ``device_put`` onto the enlarged
mesh have no counterpart, and the state tensors stay where they are.
``apply_reshard``, the recovery tiers (``attach_recovery``/``checkpoint``/
``restore_from``), ``replay_scenario`` and ``TrainerBackend`` are not ported
yet.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import codec as wire_codec
from repro_torch.core.codec import MBPS
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
#: floor for link bandwidths from trace events (``repro/core/engine.py``).
MIN_LINK_MBPS = 1e-6


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
        self.step_count = 0
        self.events: List[ScaleEvent] = []
        self._step_times: Dict[int, list] = {}
        self.state = None
        self._seed = seed

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
        """batch arrays lead with global_batch (= per_device × n_active)."""
        n = len(self.active)
        tokens = batch["tokens"]
        if not isinstance(tokens, torch.Tensor):
            tokens = torch.from_numpy(np.asarray(tokens))
        if tokens.shape[0] != self.global_batch:
            raise ValueError(f"batch of {tokens.shape[0]} rows; the global "
                             f"batch is {self.global_batch}")
        if self._step_fn is None:
            self._step_fn = self.model.make_train_step()
        tokens = tokens.to(self.model.device, non_blocking=True)
        t0 = time.perf_counter()
        self.state, metrics = self._step_fn(self.state, {"tokens": tokens})
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
        self.active = [d for d in self.active if d != device]
        self._sync()
        wall = time.perf_counter() - t0
        if self.on_reshard:
            self.on_reshard(self.device_ids())
        ev = ScaleEvent("node-failure" if failure else "scale-in",
                        str(device), self.step_count, wall)
        self.events.append(ev)
        return ev

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
