"""Bytes-on-the-wire codec layer for state-bearing transfers.

A copy of ``repro/core/codec.py`` (the port must not import the JAX package).

Chaos's scale-out delay is dominated by shipping state shards over
heterogeneous WAN links (paper §III–§IV), but until this module the byte
model moved raw fp32: ``kernels/shard_codec.py`` (Pallas int8 encode/decode)
and ``optim/compression.py`` (int8 reference, top-k) were dead code on the
replication path. This module is the *cost model* half of wiring them in —
the single place that answers, for a payload of N raw bytes on a given link:

* which codec the negotiation picks (``negotiate``): per-link by bandwidth
  class under the ``"auto"`` policy, or forced by an explicit policy;
* how many bytes actually cross the wire (``wire_bytes``): int8 codes plus
  per-block fp32 scale framing (one scale per ``Q_BLOCK``-element block —
  the exact framing ``kernels/shard_codec.py`` produces), optionally top-k
  sparsified with 4-byte indices;
* what encode/decode compute costs on the virtual clock (``encode_s`` /
  ``decode_s``): linear-in-payload charges at kernel-class throughputs,
  charged before the first byte is sent and before install respectively.

Framing is **per shard**: every shard is encoded independently and carries
its own scale block, so a delivered wire-byte prefix that covers ``n`` whole
wire-shards decodes to exactly ``n`` whole payload shards — which is what
keeps PR 2's partial-transfer credit exact under compression (see
``negotiation.replan_scale_out``).

The ``"none"`` codec is the strict identity: ``wire_bytes(p) == p`` (same
object, float payloads preserved) and zero compute charge, so every code
path that adds ``encode_s``/``decode_s`` or swaps payload for wire bytes is
bit-identical to the pre-codec arithmetic — the ledger byte-identity
invariant the engine tests pin down.
"""
from __future__ import annotations

from repro_torch.core.topology import MBPS

#: quantization block: one fp32 scale per 256 elements (kernels/shard_codec).
Q_BLOCK = 256
#: raw payload element size — replication state is fp32 (paper §III, Fig 3).
ELEM_BYTES = 4
#: per-block framing: one fp32 scale.
SCALE_BYTES = 4
#: top-k entry: 1-byte int8 code + 4-byte element index.
TOPK_INDEX_BYTES = 4
#: fraction of elements the top-k codec keeps (magnitude-ranked).
TOPK_KEEP_FRAC = 1.0 / 16.0

#: encode/decode throughput charged on the virtual clock, bytes of *payload*
#: per second. VMEM-resident int8 block quantization is memory-bound — a
#: few GB/s on the host-class nodes the paper targets; decode is a cheaper
#: multiply. Top-k pays an extra selection pass.
ENCODE_BPS = 4e9
DECODE_BPS = 8e9
TOPK_SELECT_BPS = 2e9

#: link bandwidth classes for ``"auto"`` negotiation (Mbit/s). At LAN rates
#: the quantization compute is not worth the byte savings; WAN links take
#: int8; starved links below ``WAN_MBPS`` take the heaviest codec.
LAN_MBPS = 2000.0
WAN_MBPS = 150.0

CODEC_NONE = "none"
CODEC_INT8 = "int8"
CODEC_INT8_TOPK = "int8+topk"

CODECS = (CODEC_NONE, CODEC_INT8, CODEC_INT8_TOPK)
#: valid scheduler policies: a forced codec, or per-link auto-negotiation.
POLICIES = CODECS + ("auto",)


def validate_policy(policy: str) -> str:
    if policy not in POLICIES:
        raise ValueError(
            f"unknown codec policy {policy!r}; expected one of {POLICIES}")
    return policy


def negotiate(policy: str, bandwidth_mbps: float) -> str:
    """Pick the codec for one link: a forced policy wins outright; under
    ``"auto"`` the link's bandwidth class decides (§IV-A measurement feeds
    the bandwidth)."""
    if policy != "auto":
        return validate_policy(policy)
    if bandwidth_mbps >= LAN_MBPS:
        return CODEC_NONE
    if bandwidth_mbps >= WAN_MBPS:
        return CODEC_INT8
    return CODEC_INT8_TOPK


def wire_bytes(codec: str, payload):
    """Bytes that cross the wire for ``payload`` raw bytes.

    ``"none"`` returns ``payload`` unchanged (identity — floats preserved,
    the byte-identity invariant). int8: 1 byte per element + one fp32 scale
    per ``Q_BLOCK``-element block. int8+topk: only the top ``TOPK_KEEP_FRAC``
    elements survive, each shipped as (code, index), plus the scale framing.
    """
    if codec == CODEC_NONE:
        return payload
    p = int(payload)
    if p <= 0:
        return 0
    elems = -(-p // ELEM_BYTES)
    blocks = -(-elems // Q_BLOCK)
    if codec == CODEC_INT8:
        return elems + blocks * SCALE_BYTES
    if codec == CODEC_INT8_TOPK:
        kept = max(1, int(elems * TOPK_KEEP_FRAC))
        return kept * (1 + TOPK_INDEX_BYTES) + blocks * SCALE_BYTES
    raise ValueError(f"unknown codec {codec!r}")


def wire_ratio(codec: str) -> float:
    """Asymptotic wire/payload ratio (large block-aligned payloads)."""
    if codec == CODEC_NONE:
        return 1.0
    if codec == CODEC_INT8:
        return (Q_BLOCK + SCALE_BYTES) / float(Q_BLOCK * ELEM_BYTES)
    if codec == CODEC_INT8_TOPK:
        per_elem = TOPK_KEEP_FRAC * (1 + TOPK_INDEX_BYTES) + SCALE_BYTES / Q_BLOCK
        return per_elem / ELEM_BYTES
    raise ValueError(f"unknown codec {codec!r}")


def encode_s(codec: str, payload) -> float:
    """Virtual-clock encode charge for ``payload`` raw bytes (source side,
    before the first byte hits the wire)."""
    if codec == CODEC_NONE:
        return 0.0
    p = float(payload)
    t = p / ENCODE_BPS
    if codec == CODEC_INT8_TOPK:
        t += p / TOPK_SELECT_BPS
    return t


def decode_s(codec: str, payload) -> float:
    """Virtual-clock decode charge (joining-node side, before install)."""
    if codec == CODEC_NONE:
        return 0.0
    return float(payload) / DECODE_BPS


def effective_trans_s_per_byte(codec: str, trans_s_per_byte: float) -> float:
    """Planner-visible per-*payload*-byte time over a link with per-byte
    transmission delay ``trans_s_per_byte``: wire compression shrinks the
    transmission term, and the linear encode/decode charges amortize to a
    constant per-byte compute cost. ``"none"`` is the exact identity."""
    if codec == CODEC_NONE:
        return trans_s_per_byte
    per = trans_s_per_byte * wire_ratio(codec) + 1.0 / ENCODE_BPS + 1.0 / DECODE_BPS
    if codec == CODEC_INT8_TOPK:
        per += 1.0 / TOPK_SELECT_BPS
    return per


def link_bandwidth_mbps(trans_s_per_byte: float) -> float:
    """Invert a measured per-byte delay back to Mbit/s (monitor measurements
    carry per-byte times; negotiation thinks in bandwidth classes)."""
    if trans_s_per_byte <= 0.0:
        return float("inf")
    return 1.0 / (trans_s_per_byte * MBPS)
