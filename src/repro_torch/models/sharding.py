"""Sharding rules for every architecture, from ``repro/models/sharding.py``.

Axes: ``pod`` (DP-outer across pods), ``data`` (DP + ZeRO-3/FSDP param
sharding), ``model`` (TP: heads / FFN hidden / vocab / experts).

The rules, their first-match order and thresholds are the JAX package's,
keyed on the same parameter paths; a dim is sharded only when the axis
size divides it (heterogeneous vocab sizes, MQA kv-heads etc. degrade to
replication rather than failing). Caches shard kv-heads over ``model``
when there are enough heads, else the sequence dim; long-context decode
additionally shards the cache sequence over ``data`` (SP).

The spec functions take a mesh as shapes only — a :class:`Mesh` or any
ordered ``{axis: size}`` mapping, the counterpart of JAX's
``AbstractMesh`` — and leaves as anything with a ``.shape`` (meta-device
tensors), so they run at any mesh size without a device or a process
group. A spec is a :class:`P`: one entry per tensor dim, each None, an
axis name or a tuple of axis names, equal as a tuple to JAX's
``PartitionSpec``. :func:`placements` turns it into DTensor placements
over a named ``DeviceMesh``, and :class:`NamedSharding` gives the block of
a tensor each mesh position holds, as JAX's ``devices_indices_map`` does.
"""
from __future__ import annotations

import math
import re
from typing import Dict, Mapping, Optional, Sequence

import numpy as np

from repro_torch import tree as T

# (pattern, kind) — first match wins.
RULES = [
    (re.compile(r"embed/tok$"), "embed"),
    (re.compile(r"embed/unembed$"), "expand"),
    (re.compile(r"(^|/)(pos|enc_pos)$"), "pos"),
    (re.compile(r"cm/wv$"), "contract"),
    (re.compile(r"cm/(wk|wr)$"), "expand"),
    (re.compile(r"tm/(wr|wk|wv|wg)$"), "expand"),
    (re.compile(r"tm/wo$"), "contract"),
    (re.compile(r"(attn|xattn)/wq$"), "expand"),
    (re.compile(r"(attn|xattn)/(wk|wv)$"), "kv_expand"),
    (re.compile(r"(attn|xattn)/wo$"), "contract"),
    (re.compile(r"moe/(w1|w3)$"), "experts_expand"),
    (re.compile(r"moe/w2$"), "experts_contract"),
    (re.compile(r"(shared|dense)/(w1|w3)$"), "expand"),
    (re.compile(r"(shared|dense)/w2$"), "contract"),
    (re.compile(r"mlp/(w1|w3)$"), "expand"),
    (re.compile(r"mlp/w2$"), "contract"),
    (re.compile(r"router$"), "expand"),
    (re.compile(r"in_proj$"), "expand"),
    (re.compile(r"out_proj$"), "contract"),
    (re.compile(r"conv_w$"), "conv"),
    (re.compile(r"conv_b$"), "conv_b"),
    # rwkv6 ddlerp/decay LoRA mats are tiny (d×160, d×64): replicated.
]

FSDP_MIN_PARAMS = 8e9  # below this, ZeRO-3 param sharding costs more in
# per-layer partial-reduce collectives than it saves in memory


class P(tuple):
    """A partition spec: one entry per leading tensor dim (None, an axis
    name or a tuple of axis names); missing trailing entries are None. A
    one-axis tuple is stored as the axis name, as JAX's ``PartitionSpec``
    stores it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1
                                     else e for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class Mesh:
    """A named mesh: ordered axis names and sizes and, optionally, the
    devices at its positions (row-major), e.g. the trainer's logical
    devices or ranks. ``shape`` is the ordered ``{axis: size}`` the spec
    functions read; :meth:`device_mesh` builds the torch ``DeviceMesh``
    over the process group of as many ranks."""

    def __init__(self, sizes: Sequence[int], axes: Sequence[str],
                 devices: Optional[Sequence] = None):
        sizes, axes = tuple(int(s) for s in sizes), tuple(axes)
        if len(sizes) != len(axes):
            raise ValueError(f"{len(sizes)} sizes for axes {axes}")
        self.axis_names = axes
        self.shape: Dict[str, int] = dict(zip(axes, sizes))
        self.devices = None
        if devices is not None:
            arr = np.empty(len(devices), dtype=object)
            arr[:] = list(devices)
            if arr.size != math.prod(sizes):
                raise ValueError(f"{arr.size} devices for a {sizes} plan")
            self.devices = arr.reshape(sizes)
        self._device_mesh = None

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"

    def device_mesh(self):
        """The torch ``DeviceMesh`` of this mesh, with its axis names as
        ``mesh_dim_names``, on the device type of the initialised process
        group (``cuda`` under NCCL, else ``cpu``); built once. Raises when
        no process group is initialised or when its size is not the
        mesh's: it never creates a group and never builds a smaller
        mesh. Ranks take the mesh's positions in row-major order."""
        if self._device_mesh is not None:
            return self._device_mesh
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(f"no process group is initialised for the "
                               f"{self.shape} mesh ({self.size} ranks)")
        world = dist.get_world_size()
        if world != self.size:
            raise RuntimeError(f"the process group has {world} ranks; the "
                               f"{self.shape} mesh needs {self.size}")
        from torch.distributed.device_mesh import init_device_mesh

        device_type = "cuda" if "nccl" in str(dist.get_backend()) else "cpu"
        self._device_mesh = init_device_mesh(device_type, tuple(self.shape.values()),
                                             mesh_dim_names=self.axis_names)
        return self._device_mesh


def _mesh_shape(mesh) -> Mapping[str, int]:
    return mesh if isinstance(mesh, Mapping) else mesh.shape


#: when set (``shard_report``), every dim ``_div`` declines to shard because
#: the axis size doesn't divide it is appended as (axis, dim, axis_size).
_DEGRADE_SINK: Optional[list] = None


def _axis_size(shape: Mapping[str, int], axis) -> int:
    if isinstance(axis, tuple):
        return int(np.prod([shape[a] for a in axis]))
    return shape[axis]


def _div(n: int, mesh, axis):
    if axis is None:
        return None
    size = _axis_size(_mesh_shape(mesh), axis)
    if n % size == 0 and size > 1:
        return axis
    if _DEGRADE_SINK is not None and size > 1:
        name = axis if not isinstance(axis, tuple) else "+".join(axis)
        _DEGRADE_SINK.append((name, int(n), int(size)))
    return None


def batch_axes(mesh):
    return ("pod", "data") if "pod" in _mesh_shape(mesh) else ("data",)


def _leaf_spec(kind: str, shape, mesh, fsdp: bool, cfg=None) -> P:
    nd = len(shape)
    fa = "data" if fsdp else None
    if kind == "kv_expand":
        # GQA K/V projections: heads over "model" only when every model
        # shard owns whole kv heads; else K/V replicate across "model".
        lead = [None] * (nd - 2)
        kv_ok = cfg is not None and cfg.n_kv_heads % _mesh_shape(mesh)["model"] == 0
        last = _div(shape[-1], mesh, "model") if kv_ok else None
        return P(*lead, _div(shape[-2], mesh, fa), last)
    if kind == "embed":  # (V, d)
        return P(_div(shape[0], mesh, "model"), _div(shape[1], mesh, fa))
    if kind == "pos":  # (n, d)
        return P(None, _div(shape[1], mesh, "model"))
    if kind == "expand":  # (..., d_in, d_out)
        lead = [None] * (nd - 2)
        return P(*lead, _div(shape[-2], mesh, fa), _div(shape[-1], mesh, "model"))
    if kind == "contract":  # (..., d_in, d_out) with d_in the sharded-out dim
        lead = [None] * (nd - 2)
        return P(*lead, _div(shape[-2], mesh, "model"), _div(shape[-1], mesh, fa))
    if kind == "experts_expand":  # (..., E, d, ff)
        lead = [None] * (nd - 3)
        return P(*lead, _div(shape[-3], mesh, "model"), _div(shape[-2], mesh, fa), None)
    if kind == "experts_contract":  # (..., E, ff, d)
        lead = [None] * (nd - 3)
        return P(*lead, _div(shape[-3], mesh, "model"), None, _div(shape[-1], mesh, fa))
    if kind in ("conv", "conv_b"):  # (..., K, C) / (..., C)
        lead = [None] * (nd - 1)
        return P(*lead, _div(shape[-1], mesh, "model"))
    return P()


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def _map_with_path(fn, tree):
    paths, leaves = zip(*T.flatten_with_paths(tree)) if tree else ((), ())
    return T.unflatten(paths, [fn(p, leaf) for p, leaf in zip(paths, leaves)])


def _fsdp_on(cfg) -> bool:
    return cfg.fsdp and cfg.param_count() >= FSDP_MIN_PARAMS


def dp_only_mapping(cfg, cell, mesh) -> bool:
    """Small models on a big mesh train fastest as pure DP over every axis
    (ZeRO-sharded states, no TP activation all-reduces)."""
    n_dev = math.prod(_mesh_shape(mesh).values())
    return (cfg.param_count() < 3e9 and cell is not None
            and cell.kind == "train" and cell.global_batch % n_dev == 0)


def _dp_flat_spec(shape, mesh):
    """ZeRO over the flattened device count: shard the largest divisible dim
    over ("data","model") (+"pod" handled by divisibility)."""
    axes = tuple(a for a in ("pod", "data", "model") if a in _mesh_shape(mesh))
    best = None
    for i, n in enumerate(shape):
        if _div(n, mesh, axes) and (best is None or n > shape[best]):
            best = i
    spec = [None] * len(shape)
    if best is not None:
        spec[best] = axes
    return P(*spec)


def _rule_spec(p: str, shape, cfg, mesh, fsdp: bool, default) -> P:
    for pat, kind in RULES:
        if pat.search(p):
            return _leaf_spec(kind, shape, mesh, fsdp, cfg)
    return default


def param_specs_tree(param_shapes, cfg, mesh, tp: bool = True):
    """Spec tree for a params (or params-shaped) tree."""
    fsdp = _fsdp_on(cfg)

    def one(path, leaf):
        if not tp:
            return _dp_flat_spec(tuple(leaf.shape), mesh)
        return _rule_spec(_path_str(path), tuple(leaf.shape), cfg, mesh, fsdp, P())

    return _map_with_path(one, param_shapes)


def opt_specs_tree(opt_shapes, param_spec_tree, cfg, mesh, tp: bool = True):
    """Optimizer state: fp32 moments mirror param specs; int8 codes/scales
    inherit their parameter's leading-dim specs, its last-dim axis moving
    to the block dim."""
    fsdp = _fsdp_on(cfg)

    def base_spec(sub, pshape):
        if not tp:
            return _dp_flat_spec(pshape, mesh)
        return _rule_spec(sub, pshape, cfg, mesh, fsdp, P(*([None] * len(pshape))))

    def one(path, leaf):
        p = _path_str(path)
        shape = tuple(leaf.shape)
        if p == "step":
            return P()
        sub = re.sub(r"^(m|v|mu)/", "", p)
        if p.endswith("/codes"):
            # codes: param.shape[:-1] + (nb, block).
            pshape = shape[:-2] + (shape[-2] * shape[-1],)
            bs = list(base_spec(sub[: -len("/codes")], pshape))
            last = bs[-1] if bs else None
            return P(*bs[:-1], _div(shape[-2], mesh, last), None)
        if p.endswith("/scale"):
            pshape = shape[:-1] + (shape[-1] * 256,)
            bs = list(base_spec(sub[: -len("/scale")], pshape))
            last = bs[-1] if bs else None
            return P(*bs[:-1], _div(shape[-1], mesh, last))
        return base_spec(sub, shape)

    return _map_with_path(one, opt_shapes)


def state_specs_tree(state_shapes, cfg, mesh, tp: bool = True):
    return {
        "params": param_specs_tree(state_shapes["params"], cfg, mesh, tp=tp),
        "opt": opt_specs_tree(state_shapes["opt"], None, cfg, mesh, tp=tp),
    }


# ---------------------------------------------------------------------------
# Batch / cache / output specs.
# ---------------------------------------------------------------------------


def batch_spec_tree(batch_shapes, cfg, mesh, *, cell=None, tp: bool = True):
    ba = batch_axes(mesh)
    if not tp:
        ba = ba + ("model",)

    def one(path, leaf):
        p = _path_str(path)
        shape = tuple(leaf.shape)
        if p.startswith("cache"):
            return _cache_leaf_spec(p, shape, cfg, mesh, cell)
        if shape == ():
            return P()
        b = _div(shape[0], mesh, ba)
        return P(b, *([None] * (len(shape) - 1)))

    return _map_with_path(one, batch_shapes)


def _cache_leaf_spec(p, shape, cfg, mesh, cell):
    ba = batch_axes(mesh)
    if shape == ():
        return P()
    long_ctx = cell is not None and cell.seq_len >= 262_144
    if p.endswith("/k") or p.endswith("/v") or p.endswith("attn_k") or p.endswith("attn_v") \
            or p.endswith("/xk") or p.endswith("/xv"):
        # (L, B, S, K, hd)
        Lr, B, S, K, hd = shape
        b = _div(B, mesh, ba)
        if K % _mesh_shape(mesh)["model"] == 0 and K >= cfg.shard_cache_heads_min:
            return P(None, b, _div(S, mesh, "data") if (long_ctx and b is None) else None,
                     "model", None)
        # flash-decoding style: shard the sequence over "model"
        return P(None, b, _div(S, mesh, "model"), None, None)
    if "wkv" in p:  # (L, B, H, hd, hd)
        return P(None, _div(shape[1], mesh, ba), _div(shape[2], mesh, "model"),
                 None, None)
    if p.endswith("tm_x") or p.endswith("cm_x"):  # (L, B, d)
        return P(None, _div(shape[1], mesh, ba), _div(shape[2], mesh, "model"))
    if "mamba/h" in p or p.endswith("/h"):  # (L, B, H, P, N)
        return P(None, _div(shape[1], mesh, ba), _div(shape[2], mesh, "model"),
                 None, None)
    if "conv" in p:  # (L, B, K-1, conv_dim)
        return P(None, _div(shape[1], mesh, ba), None,
                 _div(shape[-1], mesh, "model"))
    b = _div(shape[0], mesh, ba) if len(shape) else None
    return P(b, *([None] * (len(shape) - 1)))


def logits_spec(cfg, mesh, batch: int) -> P:
    ba = batch_axes(mesh)
    v = _div(cfg.vocab, mesh, "model")
    return P(_div(batch, mesh, ba), None, v)


def _nbytes(leaf) -> int:
    shape = tuple(leaf.shape)
    itemsize = leaf.element_size() if hasattr(leaf, "element_size") else 4
    return (int(np.prod(shape, dtype=np.int64)) if shape else 1) * itemsize


def shard_report(mesh, params, cfg=None) -> dict:
    """What a mesh shape *actually* shards: per-device bytes, and the params
    ``_div`` silently degraded to replication because an axis size didn't
    divide their dim — per (rule kind, axis), with tensor and byte counts.
    ``replication_blowup`` is per-device bytes × model-axis size over total
    bytes (1.0 = the model axis shards everything, model_size = it shards
    nothing). ``params``: any params-shaped tree of tensors (meta tensors
    suffice; nothing is materialised)."""
    global _DEGRADE_SINK
    shape = _mesh_shape(mesh)
    fsdp = cfg is not None and _fsdp_on(cfg)
    total = 0
    per_dev = 0
    degraded: Dict[str, dict] = {}
    for path, leaf in T.flatten_with_paths(params):
        p = _path_str(path)
        kind = "replicate"
        for pat, k in RULES:
            if pat.search(p):
                kind = k
                break
        sink: list = []
        _DEGRADE_SINK = sink
        try:
            spec = _leaf_spec(kind, tuple(leaf.shape), mesh, fsdp, cfg)
        finally:
            _DEGRADE_SINK = None
        nbytes = _nbytes(leaf)
        shard_factor = 1
        for axis in spec:
            for a in (axis if isinstance(axis, tuple) else (axis,)):
                if a is not None:
                    shard_factor *= int(shape[a])
        total += nbytes
        per_dev += nbytes // shard_factor
        for axis_name, _n, _size in sink:
            d = degraded.setdefault(f"{kind}/{axis_name}",
                                    {"tensors": 0, "bytes": 0})
            d["tensors"] += 1
            d["bytes"] += nbytes
    model_size = int(shape.get("model", 1))
    return {
        "mesh_shape": dict(shape),
        "total_bytes": int(total),
        "per_device_bytes": int(per_dev),
        "replication_blowup": (per_dev * model_size / total if total
                               else 1.0),
        "degraded": degraded,
    }


# ---------------------------------------------------------------------------
# Specs as placements and blocks.
# ---------------------------------------------------------------------------


def _entry_axes(entry):
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec: P, mesh_dim_names: Sequence[str]):
    """DTensor placements of ``spec`` over a mesh with these dim names: for
    each mesh dim, ``Shard(d)`` for the tensor dim it splits, else
    ``Replicate()``. A tensor dim split over a tuple of axes is
    ``Shard(d)`` on each of them, which gives JAX's block order (the
    first axis major) only when the tuple lists them in mesh order."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh_dim_names)
    dim_of = {}
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"{spec}: the axes {axes} of dim {d} are not "
                             f"in the mesh's order {names}")
        for a in axes:
            dim_of[a] = d
    return [Shard(dim_of[a]) if a in dim_of else Replicate() for a in names]


class NamedSharding:
    """A spec over a mesh: the port's counterpart of JAX's
    ``NamedSharding``."""

    def __init__(self, mesh: Mesh, spec: P):
        self.mesh = mesh
        self.spec = P(*spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"

    def indices(self, shape, position) -> tuple:
        """The block of a tensor of ``shape`` held at the mesh ``position``
        (one coordinate per mesh axis): a slice per tensor dim, ``slice(None)``
        where the dim is not split, as in JAX's ``devices_indices_map``."""
        coord = dict(zip(self.mesh.axis_names, position))
        out = []
        for d, n in enumerate(shape):
            axes = _entry_axes(self.spec[d]) if d < len(self.spec) else ()
            if not axes:
                out.append(slice(None))
                continue
            parts, idx = 1, 0
            for a in axes:
                parts *= self.mesh.shape[a]
                idx = idx * self.mesh.shape[a] + coord[a]
            if n % parts:
                raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                                 f"{parts} ways under {self.spec}")
            step = n // parts
            out.append(slice(idx * step, (idx + 1) * step))
        return tuple(out)

    def devices_indices_map(self, shape) -> dict:
        """``{device: block}`` for every mesh position, row-major; the
        device is the mesh's (``Mesh.devices``) or the position's row-major
        index when the mesh has none."""
        sizes = tuple(self.mesh.shape.values())
        out = {}
        for flat, pos in enumerate(np.ndindex(*sizes)):
            dev = flat if self.mesh.devices is None else self.mesh.devices[pos]
            out[dev] = self.indices(shape, pos)
        return out


def named(mesh: Mesh, spec_tree):
    return T.tree_map(lambda s: NamedSharding(mesh, s), spec_tree)
