"""Production meshes, from ``repro/launch/mesh.py``.

Each launch target is a :class:`repro_torch.core.plans.ParallelismPlan`
template (plain data, device-free) and ``mesh_from_plan`` turns one into
the port's :class:`~repro_torch.models.sharding.Mesh`: axis names and sizes
and, if given, the devices at its positions. Importing this module, or
building a mesh, touches no device state and no process group; a torch
``DeviceMesh`` is made only by ``Mesh.device_mesh()``, over a process
group of exactly the plan's rank count.

Single pod: (data=16, model=16) = 256 devices; multi-pod:
(pod=2, data=16, model=16) = 512. The ``pod`` axis is DP-outer; ``data``
carries DP + ZeRO-3 param sharding; ``model`` carries TP/EP.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.core.plans import ParallelismPlan
from repro_torch.models.sharding import Mesh

PRODUCTION_PLAN = ParallelismPlan((16, 16), ("data", "model"))
PRODUCTION_MULTI_POD_PLAN = ParallelismPlan((2, 16, 16),
                                            ("pod", "data", "model"))
DEBUG_PLAN = ParallelismPlan((2, 2), ("data", "model"))
DEBUG_MULTI_POD_PLAN = ParallelismPlan((2, 2, 2), ("pod", "data", "model"))


def mesh_from_plan(plan: ParallelismPlan,
                   devices: Optional[Sequence] = None) -> Mesh:
    """The mesh a plan describes. ``devices`` (e.g. the elastic trainer's
    active logical devices, or ranks) sit at its positions in row-major
    order; their count must equal ``plan.n_devices``."""
    if devices is not None and len(devices) != plan.n_devices:
        raise ValueError(f"{len(devices)} devices for a {plan.shape} plan")
    return Mesh(plan.shape, plan.axes, devices)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    plan = PRODUCTION_MULTI_POD_PLAN if multi_pod else PRODUCTION_PLAN
    return mesh_from_plan(plan)


def make_debug_mesh(*, multi_pod: bool = False) -> Mesh:
    """Tiny mesh for CI-scale dry runs (8 devices)."""
    plan = DEBUG_MULTI_POD_PLAN if multi_pod else DEBUG_PLAN
    return mesh_from_plan(plan)
