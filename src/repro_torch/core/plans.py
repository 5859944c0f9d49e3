"""Replication-plan entry point, from ``repro/core/plans.py``.

Only ``plan_assignment`` is ported so far: the elastic trainer's
``replication.plan_replication`` is its one caller on the port's path. The
simulator's whole-plan strategies come with the simulator.
"""
from __future__ import annotations

from typing import Dict, Sequence

from repro_torch.core.sharding_alg import (
    Assignment,
    NeighborLink,
    auto_greedy_solver,
    binary_search_assignment,
)


def plan_assignment(
    tensor_sizes: Sequence[int], neighbors: Dict[int, NeighborLink], **kw
) -> Assignment:
    """Algorithm 1 over the auto-dispatched Algorithm 2 (heap or vectorized —
    identical results, different wall time)."""
    return binary_search_assignment(tensor_sizes, neighbors,
                                    solver=auto_greedy_solver, **kw)
