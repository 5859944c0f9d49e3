"""The yardstick: the card's peaks and the work each measured kernel does.

Frozen copies, so that a change to the program cannot move what it is
measured against:

- ``attention`` and ``admitted_pairs``: ``repro_torch/kernels/cost.py``
  (operations and bytes of one attention launch);
- ``codec_bytes``: the bytes ``chip_smoke.py``'s ``time_codec`` counts for
  the shard codec's many-leaf encode and decode;
- the peaks: NVIDIA's H100 SXM data sheet (dense rates), as in
  ``chip_smoke.py``.

``tests/test_chaosbench_yardstick.py`` holds each copy to its original.
"""
from __future__ import annotations

import math

import numpy as np

PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
Q_BLOCK = 256


def admitted_pairs(kind, window, prefix_len, Sq, Skv, q_offset=0):
    """(query, key) pairs of one head that the mask admits for queries at
    positions ``q_offset + i`` over keys ``0..Skv-1``: ``full`` all of
    them; ``causal`` the keys up to the query; ``prefix`` also every key
    of the first ``prefix_len`` positions for a query among them. A
    ``window`` keeps the keys less than ``window`` behind the query, and
    under ``prefix`` the prefix keys too."""
    if kind == "full":
        return Sq * Skv
    q = q_offset + np.arange(Sq, dtype=np.int64)
    P = prefix_len if kind == "prefix" else 0
    hi = np.minimum(np.where(q < P, P, q + 1), Skv)  # admitted before the window: [0, hi)
    if window <= 0:
        return int(hi.sum())
    lo = np.maximum(q - window + 1, 0)
    kept = np.minimum(P, hi)  # prefix keys, which the window keeps
    return int((kept + np.maximum(hi - np.maximum(lo, kept), 0)).sum())


def attention(B, Sq, Skv, H, K, hd, pairs, *, kv_rows=None, itemsize=2):
    """(operations, bytes) of attention over ``pairs`` admitted (query,
    key) pairs per head: 4·hd operations a pair and head (QKᵀ and PV), q
    read and o written, K and V read over ``kv_rows`` rows."""
    kv_rows = Skv if kv_rows is None else kv_rows
    flops = 4 * B * H * hd * pairs
    nbytes = itemsize * (2 * B * Sq * H * hd + 2 * B * kv_rows * K * hd)
    return flops, nbytes


def blocks(numel: int) -> int:
    return -(-int(numel) // Q_BLOCK)


def codec_bytes(numels) -> int:
    """Bytes an int8 encode (or decode) of leaves of these sizes moves: the
    fp32 values, the int8 codes in whole blocks and the fp32 scales, each
    read or written once."""
    n = sum(int(x) for x in numels)
    nb = sum(blocks(x) for x in numels)
    return 4 * n + nb * Q_BLOCK + 4 * nb


def bound_s(flops, nbytes, peak_flops):
    """The least time the card could take: the larger of operations over
    ``peak_flops`` and bytes over the memory rate."""
    return max(flops / peak_flops, nbytes / PEAK_BYTES_PER_S)


def percentile(values, q):
    """The nearest-rank ``q``-th percentile (0 < q <= 100)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    return xs[max(0, math.ceil(q / 100 * len(xs)) - 1)]
