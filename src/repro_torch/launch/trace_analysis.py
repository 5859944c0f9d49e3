"""Cost analysis of one traced step, the counterpart of
``repro/launch/hlo_analysis.py``.

The JAX package parses the compiled, partitioned HLO. The port has no
compiled program: it runs the step once on the meta device (shapes only,
no memory, no device) under a ``TorchDispatchMode`` and counts each aten
op as it is dispatched, forward and backward, with
``hlo_analysis.Totals``' fields:

  * FLOPs of the matmul family (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
    ``mv``, ``dot``; ``linear``, ``matmul`` and ``einsum`` reach the trace
    as these) by ``_dot_flops``' rule, 2 · result elements · contraction;
    a convolution counts none, as there;
  * bytes accessed per op, operands plus results; views and other
    metadata ops (``NO_TRAFFIC``'s counterpart) move nothing; a gather or
    an index reads and writes its result (2 × result bytes), a scatter
    its update, as XLA's dynamic-slice and scatter conventions do;
  * each kernel entry of ``kernels/ops.py`` (attention, WKV6, SSD) as one
    op with its analytic operations and bytes (``kernels.cost``), so the
    plain versions' loops are not traced;
  * no collectives: a one-process trace issues none, so
    ``collective_wire`` and ``collective_msgs`` stay empty. The program is
    the global one, not a partitioned one.

It also walks liveness: every storage an op creates is live until its
last tensor dies (a ``weakref`` on the storage), which gives the most
bytes alive at once beside the step's arguments.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_flatten

aten = torch.ops.aten

#: matmul-family ops: (first matrix operand's index, contraction dim of it).
MATMULS = {
    aten.mm.default: (0, -1),
    aten.bmm.default: (0, -1),
    aten.addmm.default: (1, -1),
    aten.baddbmm.default: (1, -1),
    aten.mv.default: (0, -1),
    aten.addmv.default: (1, -1),
    aten.dot.default: (0, -1),
}
NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided", "detach", "alias", "lift_fresh",
              "_local_scalar_dense", "sym_size", "sym_stride", "sym_numel",
              "sym_storage_offset", "set_"}
GATHERS = {"embedding", "index", "index_select", "gather"}
SCATTERS = {"index_put", "index_put_", "_index_put_impl_", "scatter",
            "scatter_", "scatter_add", "scatter_add_", "index_add", "index_add_"}


@dataclass
class Totals:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_wire: Dict[str, float] = field(default_factory=dict)
    collective_msgs: Dict[str, int] = field(default_factory=dict)
    n_while: int = 0
    unknown_trip: int = 0
    #: per kernel entry: calls, flops, bytes.
    kernels: Dict[str, dict] = field(default_factory=dict)
    n_ops: int = 0
    #: most bytes alive at once in storages the step created.
    peak_live_bytes: int = 0

    @property
    def total_wire(self) -> float:
        return sum(self.collective_wire.values())


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _aliases(func, write=None) -> bool:
    """Whether a result of ``func`` aliases an input: any alias
    (``write`` None), a view (False) or an in-place write (True)."""
    return any(r.alias_info is not None
               and (write is None or r.alias_info.is_write == write)
               for r in func._schema.returns)


def dot_flops(func, args) -> float:
    """2 · result elements · contraction of a matmul-family op (0 for any
    other op)."""
    spec = MATMULS.get(func)
    if spec is None:
        return 0.0
    idx, dim = spec
    a, b = args[idx], args[idx + 1]
    out_elems = (a.shape[:-1].numel() if func in (aten.mv.default, aten.addmv.default,
                                                   aten.dot.default)
                 else a.shape[:-1].numel() * b.shape[-1])
    return 2.0 * out_elems * a.shape[dim]


class _Counter(TorchDispatchMode):
    def __init__(self, totals: Totals):
        super().__init__()
        self.t = totals
        self.live: Dict[int, int] = {}
        self.cur = 0

    def _alive(self, key):
        self.cur -= self.live.pop(key)

    def _track(self, out):
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self.live:
                continue
            self.live[key] = st.nbytes()
            self.cur += st.nbytes()
            weakref.finalize(st, self._alive, key)
        self.t.peak_live_bytes = max(self.t.peak_live_bytes, self.cur)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        t = self.t
        t.n_ops += 1
        name = func.overloadpacket.__name__
        t.flops += dot_flops(func, args)
        if name in GATHERS:
            t.bytes_accessed += 2 * sum(_nbytes(x) for x in _tensors(out))
        elif name in SCATTERS:
            upd = args[2] if name.startswith(("index_put", "_index_put", "index_add")) \
                else args[-1]
            upd = upd if isinstance(upd, torch.Tensor) else _tensors(out)[0]
            t.bytes_accessed += 2 * _nbytes(upd)
        elif name not in NO_TRAFFIC and not _aliases(func, write=False):
            t.bytes_accessed += (sum(_nbytes(x) for x in _tensors(out))
                                 + sum(_nbytes(x) for x in _tensors((args, kwargs))))
        if not _aliases(func):  # views and in-place results hold no new storage
            self._track(out)
        return out


class _Sink:
    """``kernels.ops.trace_sink`` while a trace runs: counts each kernel
    entry as one op, and records each plain backward (``vjp``) the first
    time its key comes, replaying the record for the same key afterwards:
    its ops' counts, bytes and live-bytes high-water mark, and new gradient
    storages of the recorded gradients' shapes, strides and dtypes. A layer
    stack's identical backwards are then traced once."""

    def __init__(self, counter: "_Counter"):
        self.counter = counter
        self.records: Dict[tuple, tuple] = {}

    def kernel(self, name, flops, nbytes):
        t = self.counter.t
        k = t.kernels.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        t.flops += flops
        t.bytes_accessed += nbytes
        t.n_ops += 1

    def vjp(self, key, run):
        c, t = self.counter, self.counter.t
        rec = self.records.get(key)
        if rec is None:
            before = (t.flops, t.bytes_accessed, t.n_ops,
                      {k: dict(v) for k, v in t.kernels.items()})
            cur0, peak0 = c.cur, t.peak_live_bytes
            t.peak_live_bytes = c.cur
            grads = run()
            rise = t.peak_live_bytes - cur0
            t.peak_live_bytes = max(peak0, t.peak_live_bytes)
            kernels = {k: {f: v[f] - before[3].get(k, {}).get(f, 0) for f in v}
                       for k, v in t.kernels.items()}
            self.records[key] = (t.flops - before[0], t.bytes_accessed - before[1],
                                 t.n_ops - before[2], kernels, rise,
                                 [None if g is None else (g.shape, g.stride(), g.dtype)
                                  for g in grads])
            return grads
        flops, nbytes, n_ops, kernels, rise, layouts = rec
        t.flops += flops
        t.bytes_accessed += nbytes
        t.n_ops += n_ops
        for k, v in kernels.items():
            mine = t.kernels.setdefault(k, {"calls": 0, "flops": 0, "bytes": 0})
            for f in v:
                mine[f] += v[f]
        t.peak_live_bytes = max(t.peak_live_bytes, c.cur + rise)
        with _disable_current_modes():
            grads = [None if g is None else torch.empty_strided(g[0], g[1], dtype=g[2],
                                                                device="meta")
                     for g in layouts]
        c._track(grads)
        return grads


def analyze(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` (on meta tensors) under the counter;
    returns (its result, :class:`Totals`). Kernel entries and their plain
    backwards come through ``kernels.ops.trace_sink``."""
    from repro_torch.kernels import ops

    totals = Totals()
    counter = _Counter(totals)
    prev, ops.trace_sink = ops.trace_sink, _Sink(counter)
    try:
        with counter:
            out = fn(*args, **kwargs)
    finally:
        ops.trace_sink = prev
    return out, totals
