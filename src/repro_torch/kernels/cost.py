"""The work each kernel of ``kernels/ops.py`` does, counted analytically:
operations and bytes from the shapes of one call. ``chip_smoke.py`` divides
them by the card's peak rates for each kernel's bound, and the dry run's
trace (``launch/trace_analysis.py``) counts a kernel call by them as one
op, so that the plain versions' loops are never traced.

Bytes count each input read once and each output written once. Attention
counts the (query, key) pairs its mask admits (``admitted_pairs``), 4·hd
operations a pair and head (QKᵀ and PV, a multiply-add each), its backward
10·hd (the five products QKᵀ, PᵀdO, dO Vᵀ, dSᵀQ and dS K); WKV6 the
recurrence's 5 fp32 operations per state element and step; SSD the
chunked form's four products (2 operations a multiply-add) over its
64-row chunks, or the recurrence's 5 per state element at one step.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

SSD_CHUNK = 64


def attention(B, Sq, Skv, H, K, hd, pairs, *, kv_rows=None, itemsize=2):
    """(operations, bytes) of attention over ``pairs`` admitted (query,
    key) pairs per head: q read and o written (B·Sq·H·hd each), K and V
    read over ``kv_rows`` rows (default ``Skv``)."""
    kv_rows = Skv if kv_rows is None else kv_rows
    flops = 4 * B * H * hd * pairs
    nbytes = itemsize * (2 * B * Sq * H * hd + 2 * B * kv_rows * K * hd)
    return flops, nbytes


def attention_bwd(B, Sq, Skv, H, K, hd, pairs, *, itemsize=2):
    """(operations, bytes) of attention's backward over ``pairs`` admitted
    pairs per head: q, o and dO read and dq written (B·Sq·H·hd each), K and
    V read and dK and dV written (B·Skv·K·hd each), and each query row's
    log-sum-exp and D = rowsum(dO ∘ O) in fp32."""
    flops = 10 * B * H * hd * pairs
    nbytes = itemsize * (4 * B * Sq * H * hd + 4 * B * Skv * K * hd) + 4 * 2 * B * H * Sq
    return flops, nbytes


@functools.lru_cache(maxsize=256)
def admitted_pairs(kind, window, prefix_len, Sq, Skv, q_offset=0):
    """(query, key) pairs of one head that ``layers._mask_block`` admits for
    queries at positions ``q_offset + i`` over keys ``0..Skv-1``."""
    if kind == "full":
        return Sq * Skv
    if kind == "prefix" and prefix_len > 0:
        from repro_torch.models.layers import MaskSpec, _mask_block

        spec = MaskSpec(kind, window, prefix_len)
        kv = torch.arange(Skv)
        total = 0
        for start in range(0, Sq, 256):  # rows in blocks: no Sq × Skv mask
            q = q_offset + torch.arange(start, min(Sq, start + 256))
            total += int(_mask_block(spec, q, kv).sum())
        return total
    p = q_offset + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(p + 1, Skv)  # keys 0..p
    lo = np.maximum(p - window + 1, 0) if window > 0 else np.zeros_like(p)
    return int(np.maximum(hi - lo, 0).sum())


def wkv6(B, S, H, hd, *, state_in=False, itemsize=4):
    """(operations, bytes) of the WKV6 recurrence: r, k, v (``itemsize``)
    and the fp32 log-decays read, the fp32 output written, ``u`` read, the
    final fp32 state written (and the initial one read, ``state_in``)."""
    n = B * S * H * hd
    nbytes = (3 * itemsize + 4 + 4) * n + 4 * H * hd + 4 * B * H * hd * hd
    if state_in:
        nbytes += 4 * B * H * hd * hd
    return 5 * n * hd, nbytes


def ssd(B, S, H, P, N, *, state_in=False, itemsize=2):
    """(operations, bytes) of the SSD scan: x, B and C read (``itemsize``),
    dt and A_log read and y written (fp32), the final fp32 state written
    (and the initial one read, ``state_in``). Over S > 1 the chunked form's
    products per (b, h) and chunk of L = 64 — C·Bᵀ (L·L·N), M·X (L·L·P),
    C·hᵀ (L·N·P) and the state update (L·P·N); at S = 1 the recurrence's
    5 fp32 operations per state element."""
    nbytes = (itemsize * B * S * H * P + 4 * B * S * H * P + 4 * B * S * H + 4 * H
              + 2 * itemsize * B * S * N + 4 * B * H * P * N)
    if state_in:
        nbytes += 4 * B * H * P * N
    if S == 1:
        return 5 * B * H * P * N, nbytes
    L = SSD_CHUNK
    chunks = B * H * -(-S // L)
    return 2 * chunks * (L * L * N + L * L * P + 2 * L * N * P), nbytes
