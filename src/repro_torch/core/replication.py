"""State-replication engine: training-state tree ⇄ byte shards, from
``repro/core/replication.py``.

The paper replicates "model weights, optimizer states, and runtime info"
(§III, Fig 3). The training state (a nested dict of tensors) is flattened
to one contiguous byte view with a manifest; Algorithm 1/2 plans over the
byte sizes; shards are materialized (optionally int8-encoded), shipped, and
reassembled into an identical state on the joining node.

Leaves stay on their device. The walk visits dict keys in sorted order, as
``jax.tree_util`` does, so manifests (paths, shapes, dtypes, offsets) and
byte streams equal the JAX package's for the same state. The 0-d
``opt/step`` int32 leaf takes 4 bytes like any other.

On the card the int8 codec runs the shard-codec kernels
(``kernels.ops.shard_encode_many`` and ``shard_decode_many``, one launch
each per state). The JAX package's
``verify_kernel`` cross-check against the reference on every encode has no
counterpart here: the kernels are held to their plain versions by the tests
and by ``chip_smoke.py``, never on the main path.

Counters of the innermost open span (``repro_torch.spans``): ``copies``
(the flatten's one concatenation, each shard cut out), ``shards`` (a
plan's), ``leaves``, ``payload_bytes`` and ``wire_bytes`` (an encode's or
a decode's), and ``syncs`` (each check of the round trip that waits for
the device).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch import spans
from repro_torch import tree as T
from repro_torch.core import codec as wire_codec
from repro_torch.core.plans import plan_assignment
from repro_torch.core.sharding_alg import Assignment, NeighborLink
from repro_torch.kernels import ops as kernel_ops
from repro_torch.optim.compression import Q_BLOCK, compressed_bytes


@dataclass(frozen=True)
class TensorEntry:
    path: str
    shape: Tuple[int, ...]
    dtype: str
    offset: int  # byte offset in the flat stream
    nbytes: int


@dataclass
class StateManifest:
    entries: List[TensorEntry]
    total_bytes: int
    treedef: object = None  # the leaves' key paths, for unflatten

    @property
    def tensor_sizes(self) -> List[int]:
        return [e.nbytes for e in self.entries]


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def build_manifest(tree) -> StateManifest:
    entries = []
    paths = []
    off = 0
    for path, leaf in T.flatten_with_paths(tree):
        nbytes = leaf.numel() * leaf.element_size()
        entries.append(TensorEntry("/".join(path), tuple(leaf.shape),
                                   _dtype_name(leaf.dtype), off, nbytes))
        paths.append(path)
        off += nbytes
    return StateManifest(entries, off, tuple(paths))


def _bytes_of(leaf: torch.Tensor) -> torch.Tensor:
    return leaf.contiguous().reshape(-1).view(torch.uint8)


def flatten_state(tree) -> Tuple[torch.Tensor, StateManifest]:
    """Concatenate all leaves into one uint8 stream (on the leaves' device)
    + manifest."""
    manifest = build_manifest(tree)
    buf = torch.cat([_bytes_of(leaf) for leaf in T.leaves(tree)])
    spans.count("copies")
    return buf, manifest


def unflatten_state(buf: torch.Tensor, manifest: StateManifest):
    leaves = []
    for e in manifest.entries:
        raw = buf[e.offset: e.offset + e.nbytes]
        leaves.append(raw.view(getattr(torch, e.dtype)).reshape(e.shape))
    return T.unflatten(manifest.treedef, leaves)


# ---------------------------------------------------------------------------
# Shards.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShardRange:
    index: int
    start: int
    end: int

    @property
    def nbytes(self) -> int:
        return self.end - self.start


def make_shard_ranges(total_bytes: int, shard_size: int) -> List[ShardRange]:
    return [ShardRange(i, start, min(start + shard_size, total_bytes))
            for i, start in enumerate(range(0, total_bytes, shard_size))]


def extract_shards(buf: torch.Tensor,
                   ranges: Sequence[ShardRange]) -> Dict[int, torch.Tensor]:
    spans.count("copies", len(ranges))
    return {r.index: buf[r.start: r.end].clone() for r in ranges}


def assemble_shards(shards: Dict[int, torch.Tensor],
                    ranges: Sequence[ShardRange],
                    total_bytes: int) -> torch.Tensor:
    parts = []
    for r in ranges:
        data = shards[r.index]
        if data.numel() != r.nbytes:
            raise ValueError(f"shard {r.index}: {data.numel()} bytes, "
                             f"expected {r.nbytes}")
        parts.append(data)
    buf = torch.cat(parts)
    if buf.numel() != total_bytes:
        raise ValueError(f"assembled {buf.numel()} of {total_bytes} bytes")
    return buf


# ---------------------------------------------------------------------------
# Wire codec on real tensors: fp32 leaves ship as int8 codes + per-block fp32
# scales; other dtypes ship raw (the scale/2 error bound is an fp32 contract,
# and integer runtime state must survive exactly).
# ---------------------------------------------------------------------------


@dataclass
class EncodedLeaf:
    """One tensor of an encoded state: either int8 codes + scales, or the
    raw tensor (non-fp32 dtypes, or the ``none`` codec)."""
    kind: str  # "int8" | "raw"
    payload_bytes: int
    wire_bytes: int
    codes: Optional[torch.Tensor] = None
    scales: Optional[torch.Tensor] = None
    meta: Optional[tuple] = None  # (shape, dtype)
    raw: Optional[torch.Tensor] = None


def encode_state(tree, codec: str = wire_codec.CODEC_INT8):
    """Encode a training state for the wire.

    Returns ``(leaves, manifest, total_wire_bytes)``. fp32 leaves are
    int8-block-quantized by the shard-codec kernel (one fp32 scale per
    ``Q_BLOCK`` elements), all of them in one launch; each int8
    ``EncodedLeaf`` holds views of its rows of the shared codes and scales
    buffers. Other dtypes ship raw, as a copy. Any non-``none`` codec
    quantizes the same way (see the JAX function for why)."""
    manifest = build_manifest(tree)
    leaves = T.leaves(tree)
    coded = [codec != wire_codec.CODEC_NONE and leaf.dtype == torch.float32
             and leaf.numel() > 0 for leaf in leaves]
    if any(coded):
        codes, scales, firsts = kernel_ops.shard_encode_many(
            [leaf for leaf, c in zip(leaves, coded) if c])
    out: List[EncodedLeaf] = []
    total_wire = 0
    j = 0
    for entry, leaf, c in zip(manifest.entries, leaves, coded):
        if c:
            lo, hi = firsts[j], firsts[j + 1]
            j += 1
            lc, ls = codes[lo:hi], scales[lo:hi]
            wire = int(compressed_bytes(lc, ls))
            out.append(EncodedLeaf("int8", entry.nbytes, wire, codes=lc,
                                   scales=ls, meta=(entry.shape, leaf.dtype)))
        else:
            wire = entry.nbytes
            out.append(EncodedLeaf("raw", entry.nbytes, wire, raw=leaf.clone()))
        total_wire += wire
    spans.count("leaves", len(out))
    spans.count("payload_bytes", manifest.total_bytes)
    spans.count("wire_bytes", total_wire)
    return out, manifest, total_wire


def decode_state(leaves: Sequence[EncodedLeaf], manifest: StateManifest):
    """Inverse of :func:`encode_state`: rebuild the state on the joining
    node. The int8 leaves decode through the shard-codec kernel, all of them
    in one launch (fp32-exact ``code * scale``, bit-identical to
    ``int8_dequantize``); raw leaves are taken as they are. Every decoded
    fp32 element satisfies ``|decoded - original| <= scale_of_its_block / 2``."""
    coded = [e for e in leaves if e.kind == "int8"]
    decoded = iter(kernel_ops.shard_decode_many(
        [e.codes for e in coded], [e.scales for e in coded],
        [math.prod(e.meta[0]) for e in coded]))
    arrs = []
    for e in leaves:
        if e.kind == "raw":
            arrs.append(e.raw)
            continue
        shape, dtype = e.meta
        arrs.append(next(decoded).reshape(shape).to(dtype))
    if spans.on():
        spans.count("leaves", len(arrs))
        spans.count("payload_bytes", manifest.total_bytes)
        spans.count("wire_bytes", sum(e.wire_bytes for e in leaves))
    return T.unflatten(manifest.treedef, arrs)


#: Relative slack on the ``scale/2`` bound for fp32 rounding. The ratio
#: ``x / scale`` (|x/scale| <= 127.5) is rounded once, moving the code
#: decision by up to 127.5 * 2^-24 of a scale; ``code * scale`` is rounded
#: once more (127 * 2^-24 of a scale); and the error itself is rounded when
#: computed. Against scale/2 that is 2 * 254.5 * 2^-24 ≈ 3.03e-5, plus one
#: ulp. The JAX package allows 1e-5, which real states exceed: a reduced
#: GPT-2 state after one Adam step already has an element at 1.7e-5.
ROUNDTRIP_SLACK = 4e-5


def roundtrip_max_error_ok(tree, decoded_tree,
                           leaves: Sequence[EncodedLeaf]) -> bool:
    """Check the documented bound: every int8-encoded fp32 element is within
    ``scale/2`` of the original (raw leaves must match exactly), up to
    :data:`ROUNDTRIP_SLACK`. Runs on the leaves' device."""
    for o, d, e in zip(T.leaves(tree), T.leaves(decoded_tree), leaves):
        if e.kind == "raw":
            spans.count("syncs")
            if not torch.equal(o, d):
                return False
            continue
        err = torch.abs(o.to(torch.float32) - d.to(torch.float32)).reshape(-1)
        err = F.pad(err, (0, (-err.numel()) % Q_BLOCK)).reshape(-1, Q_BLOCK)
        bound = e.scales[:, None] / 2.0
        spans.count("syncs")
        if not bool(torch.all(err <= bound * (1.0 + ROUNDTRIP_SLACK))):
            return False
    return True


# ---------------------------------------------------------------------------
# End-to-end replication (used by the elastic runtime and tests).
# ---------------------------------------------------------------------------


@dataclass
class ReplicationExecution:
    assignment: Assignment
    ranges: List[ShardRange]
    manifest: StateManifest
    bytes_per_source: Dict[int, int]


def plan_replication(tree, neighbors: Dict[int, NeighborLink]) -> ReplicationExecution:
    """Plan shard pulls for a full training state (identical across sources
    — synchronous DP, the paper's setting)."""
    buf_manifest = build_manifest(tree)
    asg = plan_assignment(buf_manifest.tensor_sizes, neighbors)
    spans.count("shards", asg.n_shards)
    ranges = make_shard_ranges(buf_manifest.total_bytes, asg.shard_size)
    per_source = {
        u: sum(ranges[k].nbytes for k in ks if k < len(ranges))
        for u, ks in asg.shards_per_neighbor.items()
    }
    return ReplicationExecution(asg, ranges, buf_manifest, per_source)


def execute_replication(tree, plan: ReplicationExecution):
    """Materialize shards per source and reassemble — the data path a
    joining node runs; returns (reassembled_tree, shards_by_source)."""
    buf, manifest = flatten_state(tree)
    by_source: Dict[int, Dict[int, torch.Tensor]] = {}
    for u, ks in plan.assignment.shards_per_neighbor.items():
        rs = [plan.ranges[k] for k in ks if k < len(plan.ranges)]
        by_source[u] = extract_shards(buf, rs)
    merged: Dict[int, torch.Tensor] = {}
    for shards in by_source.values():
        merged.update(shards)
    out = assemble_shards(merged, plan.ranges, manifest.total_bytes)
    return unflatten_state(out, manifest), by_source


def plan_for_sharded_state(
    rank_of_neighbor: Dict[int, int],
    my_rank_sources: Dict[int, NeighborLink],
    tree,
) -> ReplicationExecution:
    """TP/EP-sharded training state: only neighbors holding the same shard
    rank are valid sources. Callers pass the same-rank neighbor subset; this
    is a thin wrapper documenting the grouping contract."""
    assert my_rank_sources, "no same-rank neighbors — fall back to checkpoint tier"
    return plan_replication(tree, my_rank_sources)
