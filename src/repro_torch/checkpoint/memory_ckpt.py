"""In-memory neighbor-replicated checkpoints (Gemini [20] tier, built on the
Chaos replication engine), from ``repro/checkpoint/memory_ckpt.py``.

Every node periodically pushes *shards* of its training state to its
neighbors (planned by Algorithm 1/2 so pushes balance across links). On
node failure, the replacement pulls the shards back from the surviving
neighbors — no disk in the loop. This is the fast tier of the self-healing
stack; ``AsyncCheckpointer`` is the cold one.

Placement differs from the JAX store. There the trainer snapshots its
state to numpy before a push, so shards are host ``bytes``. Here shards
are ``uint8`` tensors on the device of the tree pushed, because
``flatten_state`` and ``extract_shards`` keep the leaves' device. On one
card the holders are logical devices of that card, so a replica push and
restore never touch the host.

Memory: the flat buffer is dropped as soon as the shards are cut, so a
push peaks at three times the state (the state, the buffer, the shards)
and a restore at three times too (the state it replaces, the shards, the
assembled buffer whose views the restored leaves are).

One departure from the JAX store: a push replaces everything the owner
pushed before. The JAX store merges a new push into the old shard sets, so
after a second push with another assignment a restore can read a stale
shard of the first push that another holder still keeps.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.core.replication import (
    StateManifest,
    assemble_shards,
    extract_shards,
    flatten_state,
    make_shard_ranges,
    unflatten_state,
)
from repro_torch.core.sharding_alg import NeighborLink, binary_search_assignment


@dataclass
class ReplicaMeta:
    step: int
    manifest: StateManifest
    ranges: list
    holders: Dict[int, List[int]]  # neighbor -> shard indices held


class MemoryReplicaStore:
    """Holds replicated shard sets per (owner node, step)."""

    def __init__(self, redundancy: int = 1):
        self.redundancy = redundancy
        # (owner, holder) -> {shard index: uint8 tensor}
        self._shards: Dict[tuple, Dict[int, torch.Tensor]] = {}
        self._meta: Dict[int, ReplicaMeta] = {}

    # -- owner side ---------------------------------------------------------

    def push(self, owner: int, step: int, tree,
             neighbors: Dict[int, NeighborLink]) -> ReplicaMeta:
        """Shard the state and place shards on neighbors (Alg 1/2 balanced).
        With redundancy r > 1, each shard goes to r distinct holders."""
        for key in [k for k in self._shards if k[0] == owner]:
            del self._shards[key]
        buf, manifest = flatten_state(tree)
        asg = binary_search_assignment(manifest.tensor_sizes, neighbors)
        ranges = make_shard_ranges(manifest.total_bytes, asg.shard_size)
        holders: Dict[int, List[int]] = {u: [] for u in neighbors}
        order = sorted(neighbors)
        for u, ks in asg.shards_per_neighbor.items():
            ks = [k for k in ks if k < len(ranges)]
            holder_ring = [u] + [v for v in order if v != u]
            for r in range(self.redundancy):
                h = holder_ring[r % len(holder_ring)]
                shards = extract_shards(buf, [ranges[k] for k in ks])
                key = (owner, h)
                self._shards.setdefault(key, {}).update(shards)
                holders.setdefault(h, []).extend(ks)
        del buf
        meta = ReplicaMeta(step, manifest, ranges, holders)
        self._meta[owner] = meta
        return meta

    # -- recovery side --------------------------------------------------------

    def restore(self, owner: int, *, available: Optional[Sequence[int]] = None):
        """Reassemble the owner's state from surviving holders.
        Returns (tree, step) or raises if shards are missing. The leaves are
        views of one new buffer; the held shards stay untouched."""
        meta = self._meta.get(owner)
        if meta is None:
            raise KeyError(f"no replica for node {owner}")
        merged: Dict[int, torch.Tensor] = {}
        for (own, holder), shards in self._shards.items():
            if own != owner:
                continue
            if available is not None and holder not in available:
                continue
            merged.update(shards)
        missing = {r.index for r in meta.ranges} - set(merged)
        if missing:
            raise RuntimeError(
                f"replica incomplete: {len(missing)} shards lost "
                f"(raise redundancy or fall back to disk checkpoint)")
        buf = assemble_shards(merged, meta.ranges, meta.manifest.total_bytes)
        return unflatten_state(buf, meta.manifest), meta.step

    def drop_holder(self, holder: int):
        """Simulate losing a holder node (its replica shards vanish)."""
        for key in [k for k in self._shards if k[1] == holder]:
            del self._shards[key]

    def bytes_held(self, holder: int) -> int:
        return sum(
            sum(b.numel() for b in shards.values())
            for (own, h), shards in self._shards.items() if h == holder
        )
