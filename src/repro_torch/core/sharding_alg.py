"""Shard-assignment algorithms for multi-neighbor state replication
(paper §III — problems P1/P2/P3, Algorithms 1 and 2), copied from
``repro/core/sharding_alg.py``.

Objective (P1, Eq. 4):  min over (s, x)  of  max_u  t_u + τ_u^sync,
  t_u = t_u^prop + s · t_u^trans · |K_u|.

* ``greedy_shard_assignment``      — Algorithm 2 (least-estimated-load greedy).
  Heap reference.
* ``greedy_shard_assignment_vec``  — the same algorithm solved in closed form
  with NumPy; exact heap equivalence.
* ``binary_search_assignment``     — Algorithm 1 (binary search over shard
  size s, calling Algorithm 2 per candidate).

The plans must be identical to the JAX package's, so the arithmetic is kept
operation for operation. The ablation baselines and the ``Topology``-based
helpers come with the simulator's port.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class NeighborLink:
    """Measured link from neighbor u to the new node (monitor §IV-A)."""
    prop_s: float  # t^prop (propagation delay, seconds)
    trans_s_per_byte: float  # t^trans (per-byte transmission delay)
    sync_s: float = 0.0  # τ^sync (all-reduce finish skew)


@dataclass
class Assignment:
    """Result: shards (byte sizes) per neighbor + objective value."""
    shard_size: int
    shards_per_neighbor: Dict[int, List[int]]  # u -> shard indices
    completion_s: float  # objective θ (Eq. 8)
    per_neighbor_s: Dict[int, float]

    @property
    def n_shards(self) -> int:
        return sum(len(v) for v in self.shards_per_neighbor.values())


def completion_time(
    counts: Dict[int, int], s: int, neighbors: Dict[int, NeighborLink]
) -> Tuple[float, Dict[int, float]]:
    """Eq. (4): max_u (prop + s·trans·|K_u| + sync) over neighbors with work."""
    per = {}
    for u, link in neighbors.items():
        c = counts.get(u, 0)
        per[u] = link.prop_s + link.sync_s + s * link.trans_s_per_byte * c if c else 0.0
    worst = max(per.values()) if per else 0.0
    return worst, per


# ---------------------------------------------------------------------------
# Algorithm 2 — greedy least-estimated-load (P3).
# ---------------------------------------------------------------------------


def greedy_shard_assignment(
    n_shards: int, s: int, neighbors: Dict[int, NeighborLink]
) -> Assignment:
    """Paper Algorithm 2. l_u ← prop_u + sync_u (initial term); repeatedly give
    the next shard to argmin_u (l_u + s·trans_u) and bump l_u (update term).

    O(K log |U|) with a heap. The priority of neighbor u's c-th shard is
    computed as ``base_u + c·inc_u`` (one multiply) rather than by repeated
    addition, so the vectorized solver below reproduces the exact same
    floating-point values — and therefore the exact same assignment.
    """
    if not neighbors:
        raise ValueError("no neighbors to pull from")
    base = {u: l.prop_s + l.sync_s for u, l in neighbors.items()}
    inc = {u: s * l.trans_s_per_byte for u, l in neighbors.items()}
    heap = [(base[u] + inc[u], u, 1) for u in neighbors]
    heapq.heapify(heap)
    shards: Dict[int, List[int]] = {u: [] for u in neighbors}
    for k in range(n_shards):
        est, u, c = heapq.heappop(heap)
        shards[u].append(k)
        heapq.heappush(heap, (base[u] + (c + 1) * inc[u], u, c + 1))
    counts = {u: len(v) for u, v in shards.items()}
    worst, per = completion_time(counts, s, neighbors)
    return Assignment(s, shards, worst, per)


def greedy_shard_assignment_vec(
    n_shards: int, s: int, neighbors: Dict[int, NeighborLink]
) -> Assignment:
    """Vectorized Algorithm 2: identical output to the heap reference.

    The heap greedy selects the K smallest priorities from the union of the
    per-neighbor ladders {base_u + c·inc_u : c ≥ 1}, ties broken by (value,
    u, c). Instead of popping one shard at a time, bisect a threshold window
    (lo, hi] with batched exact rung counts until it holds only O(|U|)
    candidate rungs, then pick the remaining winners with one lexsort in the
    heap's exact (value, u, c) pop order. The per-shard Python loop is gone,
    which is what keeps planning sub-millisecond at ≥256 neighbors.
    """
    if not neighbors:
        raise ValueError("no neighbors to pull from")
    us = sorted(neighbors)
    nU = len(us)
    base = np.array([neighbors[u].prop_s + neighbors[u].sync_s for u in us])
    inc = np.array([s * neighbors[u].trans_s_per_byte for u in us])
    if np.any(inc <= 0.0) or not np.all(np.isfinite(base + inc)):
        return greedy_shard_assignment(n_shards, s, neighbors)  # degenerate

    K = int(n_shards)

    def counts_leq(theta: float) -> np.ndarray:
        """Per-neighbor count of rungs with base + c·inc <= theta (exact in
        the same float arithmetic as the heap's priorities)."""
        est = np.floor((theta - base) / inc)
        est = np.minimum(np.maximum(est, 0.0), K).astype(np.int64)
        for _ in range(64):  # fp correction: settle on the true boundary
            over = (est > 0) & (base + est * inc > theta)
            under = (est < K) & (base + (est + 1) * inc <= theta)
            if not (over.any() or under.any()):
                break
            est[over] -= 1
            est[under & ~over] += 1
        return est

    counts = None
    # Fast path: the real-valued water level θ with Σ_u max(0, (θ−b_u)/i_u)
    # = K (active-set iteration). Its floored counts undershoot K by at most
    # ~|U| rungs; merge the deficit rungs with a tiny frontier heap in the
    # heap solver's exact (value, u, c) pop order.
    w = 1.0 / inc
    active = np.ones(nU, bool)
    theta = 0.0
    for _ in range(nU + 2):
        denom = w[active].sum()
        theta = (K + (base[active] * w[active]).sum()) / denom
        nxt = base < theta
        if not nxt.any():
            break
        if (nxt == active).all():
            break
        active = nxt
    if np.isfinite(theta):
        cl = counts_leq(theta)
        d = K - int(cl.sum())
        if 0 <= d <= max(64, 4 * nU):
            frontier = [(base[j] + (cl[j] + 1) * inc[j], j, cl[j] + 1)
                        for j in range(nU)]
            heapq.heapify(frontier)
            counts = cl.copy()
            for _ in range(d):
                _, j, c = heapq.heappop(frontier)
                counts[j] += 1
                heapq.heappush(frontier, (base[j] + (c + 1) * inc[j], j, c + 1))

    if counts is None:
        # Fallback: threshold bisection with exact counts. Invariant:
        # total(lo) < K <= total(hi); shrink until the window holds a handful
        # of candidate rungs (or the floats are adjacent), then enumerate.
        lo = np.nextafter(float(np.min(base + inc)), -np.inf)
        cl = counts_leq(lo)
        if cl.sum() >= K:  # no rung below the min — safety only
            return greedy_shard_assignment(n_shards, s, neighbors)
        hi = float(np.max(base + K * inc))  # one neighbor takes everything
        ch = counts_leq(hi)
        cap = max(64, 4 * nU)
        while int(ch.sum() - cl.sum()) > cap and hi > np.nextafter(lo, np.inf):
            mid = 0.5 * (lo + hi)
            if mid <= lo or mid >= hi:
                break
            cm = counts_leq(mid)
            if cm.sum() >= K:
                hi, ch = mid, cm
            else:
                lo, cl = mid, cm
        # Take the window's remaining R winners in (value, u, c) pop order.
        m = ch - cl
        M = int(m.sum())
        u_win = np.repeat(np.arange(nU), m)
        c_win = (np.arange(M)
                 - np.repeat(np.concatenate(([0], np.cumsum(m)[:-1])), m)
                 + np.repeat(cl, m) + 1)
        v_win = base[u_win] + c_win * inc[u_win]
        # Pairs are laid out in (u, c) order, so a stable value sort breaks
        # ties by position — exactly the heap's (value, u, c) pop order.
        order = np.argsort(v_win, kind="stable")
        chosen = order[:K - int(cl.sum())]
        counts = cl + np.bincount(u_win[chosen], minlength=nU)

    # Reconstruct the heap's shard indices: pop order == sort by (value, u, c).
    # Pairs are laid out in (u, c) order, so a stable value sort breaks ties
    # by position — the heap's exact pop order.
    u_idx = np.repeat(np.arange(nU), counts)
    offs = np.concatenate(([0], np.cumsum(counts)[:-1]))
    c_arr = np.arange(K) - np.repeat(offs, counts) + 1
    values = base[u_idx] + c_arr * inc[u_idx]
    order = np.argsort(values, kind="stable")
    ranks = np.empty(K, np.int64)
    ranks[order] = np.arange(K)
    # Within one neighbor values ascend with c, so its ranks are already
    # ascending — matching the heap's append order without another sort.
    shards: Dict[int, List[int]] = {u: [] for u in neighbors}
    pos = 0
    for j, u in enumerate(us):
        n = int(counts[j])
        shards[u] = ranks[pos:pos + n].tolist()
        pos += n
    cmap = {u: len(v) for u, v in shards.items()}
    worst, per = completion_time(cmap, s, neighbors)
    return Assignment(s, shards, worst, per)


VEC_SOLVER_MIN_NEIGHBORS = 32  # below this the heap's constant factor wins


def auto_greedy_solver(
    n_shards: int, s: int, neighbors: Dict[int, NeighborLink]
) -> Assignment:
    """Dispatch Algorithm 2 to the vectorized solver on wide instances.

    Both solvers produce the identical assignment, so the dispatch threshold
    never changes results — only wall time.
    """
    if len(neighbors) >= VEC_SOLVER_MIN_NEIGHBORS and n_shards > len(neighbors):
        return greedy_shard_assignment_vec(n_shards, s, neighbors)
    return greedy_shard_assignment(n_shards, s, neighbors)


# ---------------------------------------------------------------------------
# Algorithm 1 — binary search over shard size s (P2).
# ---------------------------------------------------------------------------


def binary_search_assignment(
    tensor_sizes: Sequence[int],
    neighbors: Dict[int, NeighborLink],
    *,
    max_shards: int = 8192,
    solver=greedy_shard_assignment,
) -> Assignment:
    """Paper Algorithm 1. s ranges over [min tensor size, max tensor size];
    binary search assumes quasi-monotonicity of θ(s) (§III-A).

    ``max_shards`` keeps K = ⌈|w|/s⌉ bounded (production guard; the paper's
    range start at min-layer-size can make K huge for LLM states).
    """
    total = int(sum(tensor_sizes))
    if total <= 0:
        raise ValueError("empty training state")
    s_lo = max(1, min(int(t) for t in tensor_sizes if t > 0))
    s_hi = max(int(t) for t in tensor_sizes)
    s_lo = max(s_lo, math.ceil(total / max_shards))
    s_hi = max(s_hi, s_lo)

    best: Optional[Assignment] = None
    lo, hi = s_lo, s_hi
    while lo <= hi:
        s = (lo + hi) // 2
        k = math.ceil(total / s)
        cand = solver(k, s, neighbors)
        if best is None or cand.completion_s < best.completion_s:
            best = cand
            hi = s - 1  # improvement → try smaller shards (finer balance)
        else:
            lo = s + 1  # worse → try larger shards (less overhead)
    return best
