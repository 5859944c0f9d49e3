"""Comparison systems (paper §VI-A), copied from ``repro/core/baselines.py``:

* Pollux [8]  — stop-resume checkpointing: pause all nodes, write the training
  state to disk, re-initialize the cluster, read the checkpoint back, resume.
* EDL+ [13,14] — stop-free, single-source replication from the fastest
  neighbor, with the extra all-node barrier the paper measures (§VI-C).
* Autoscaling [18] — stop-free, multi-source replication from all nodes over
  shortest paths (multi-hop redundant traffic).
* Chaos (ours) — multi-neighbor replication + Algorithm 1/2 scheduling.

All stop-free systems share the SimCluster protocol machinery with different
plan strategies; Pollux is modeled separately as it bypasses replication.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

from repro_torch.core.negotiation import ScaleOutResult, SimCluster
from repro_torch.core.sharding_alg import ReplicationPlan
from repro_torch.core.topology import Link, Topology

DISK_WRITE_BPS = 150e6  # sequential HDD/NFS-class disk on edge boxes
DISK_READ_BPS = 200e6
RESTART_OVERHEAD_S = 90.0  # process restart + framework/cluster re-init
CHECKPOINT_PERIOD_ITERS = 50


@dataclass
class PolluxResult:
    delay_s: float
    idle_s: Dict[int, float]
    breakdown: Dict[str, float]


def pollux_scale_out(topo: Topology, state_bytes: int) -> PolluxResult:
    """Stop-resume: ckpt write + cluster re-init + ckpt read, all nodes blocked."""
    write = state_bytes / DISK_WRITE_BPS
    read = state_bytes / DISK_READ_BPS
    delay = write + RESTART_OVERHEAD_S + read
    idle = {n: delay for n in topo.active_nodes()}
    return PolluxResult(delay, idle, {
        "ckpt_write_s": write, "restart_s": RESTART_OVERHEAD_S, "ckpt_read_s": read,
    })


STRATEGIES = ("chaos", "chaos-even", "single-source", "multi-source", "pollux")


def make_cluster(topo: Topology, *, state_bytes: int,
                 tensor_sizes: Sequence[int], strategy: str,
                 codec: str = "none") -> SimCluster:
    if strategy == "pollux":
        # Pollux still trains synchronously; scale events handled separately.
        return SimCluster(topo, state_bytes=state_bytes,
                          tensor_sizes=tensor_sizes, strategy="single-source",
                          codec=codec)
    return SimCluster(topo, state_bytes=state_bytes,
                      tensor_sizes=tensor_sizes, strategy=strategy,
                      codec=codec)


def run_scale_out(cluster: SimCluster, strategy: str, new_node: int,
                  links: Dict[int, Link], state_bytes: int):
    """Uniform entry point returning (delay_s, idle_map, extra)."""
    if strategy == "pollux":
        res = pollux_scale_out(cluster.topo, state_bytes)
        # Node joins instantly after restart (it reads the checkpoint too).
        cluster.scheduler.monitor.register_join(new_node, links)
        cluster.scheduler.monitor.activate(new_node)
        return res.delay_s, res.idle_s, res
    res = cluster.scale_out(new_node, links)
    return res.delay_s, res.idle_s, res
