"""Opt-in activation sharding constraints, from ``repro/models/shardctx.py``.

Model code is mesh-agnostic; a launcher installs a context so that hot
activations (q/k/v, attention output, MLP hidden) carry explicit layouts.
``constrain`` builds JAX's spec for an activation and, for a ``DTensor`` on
the context's ``DeviceMesh``, redistributes it to that layout. A plain
tensor, or no context, is returned as it is: one process holds the whole
activation and has nothing to constrain, the counterpart of JAX's no-op on
one device, so single-process forwards and steps are bit-identical with
and without a context.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

_CTX: Optional[Tuple[object, Tuple[str, ...], bool]] = None


@contextlib.contextmanager
def activation_sharding(mesh, tp: bool = True):
    """``mesh``: a :class:`~repro_torch.models.sharding.Mesh`. tp=False: the
    pure-DP mapping — the batch spans every mesh axis and "model"-dim
    constraints are dropped (small-model train cells)."""
    global _CTX
    ba = ("pod", "data") if "pod" in mesh.shape else ("data",)
    if not tp:
        ba = ba + ("model",)
    prev = _CTX
    _CTX = (mesh, ba, tp)
    try:
        yield
    finally:
        _CTX = prev


def _axis_size(mesh, axis) -> int:
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= mesh.shape[a]
        return n
    return mesh.shape[axis]


def get_ctx():
    """Returns (mesh, batch_axes, tp) when a launcher installed one."""
    return _CTX


def live_device_mesh(mesh):
    """The ``DeviceMesh`` of ``mesh`` when this process is one rank of an
    initialised process group, else None (one process: nothing to
    distribute). A group whose size is not the mesh's raises
    (``Mesh.device_mesh``)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return None
    return mesh.device_mesh()


def _spec_for(shape, dims):
    """JAX's spec for an activation of ``shape`` under the installed
    context: "batch" is the batch axes, "model" is dropped under tp=False,
    and a dim the axis size does not divide is None."""
    from repro_torch.models.sharding import P

    mesh, ba, tp = _CTX
    spec = []
    for size, d in zip(shape, dims):
        if d is None or (d == "model" and not tp):
            spec.append(None)
            continue
        axis = ba if d == "batch" else d
        spec.append(axis if size % _axis_size(mesh, axis) == 0 else None)
    return P(*spec)


def constrain(x, *dims):
    """dims: one entry per axis of x — "batch", "model", "data", or None.
    A ``DTensor`` on the context's ``DeviceMesh`` is redistributed to the
    spec's placements; anything else is returned as it is."""
    if _CTX is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    from repro_torch.models.sharding import placements

    mesh = _CTX[0]
    dm = mesh.device_mesh()
    if x.device_mesh != dm:
        raise ValueError("constrain: a DTensor on another mesh than the "
                         "installed context's")
    return x.redistribute(dm, placements(_spec_for(x.shape, dims),
                                         dm.mesh_dim_names))
