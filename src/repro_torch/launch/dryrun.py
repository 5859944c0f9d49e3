"""Multi-pod dry run of the port, from ``repro/launch/dryrun.py``.

For every (architecture × shape cell × mesh) this builds the cell's step
(the train step, a prefill or a decode step) at full size on the meta
device, lays its arguments out under the production shardings
(``models/sharding.py``), traces it once (``launch/trace_analysis.py``)
and derives the roofline's three terms:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Where JAX lowers and compiles a partitioned program, the port has none, so
a record differs from JAX's in these ways:

  * ``memory_analysis``: ``argument_bytes``, ``output_bytes`` and
    ``alias_bytes`` are per device and exact, from the specs over the
    meta-device state, batch, cache and logits; aliases follow JAX's
    ``donate_argnums`` (a train cell donates its state, a decode cell its
    batch, whose cache the step returns). ``temp_bytes`` and
    ``peak_bytes`` come from the trace's liveness walk and exist only on a
    one-device mesh; elsewhere they are None, with the reason.
  * ``trace_analysis`` (JAX's ``hlo_analysis``): the traced program is the
    global, unpartitioned one. Its FLOPs and bytes are divided by the
    device count, and it issues no collectives (``"partitioned":
    false``).
  * the roofline uses the H100 SXM5's datasheet figures.

Nothing runs on a device; the records go to ``--out`` (default
``build/dryrun/dryrun.json``, gitignored).
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Optional, Union

import torch

from repro_torch import tree as T
from repro_torch.configs import ASSIGNED, SHAPES, get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.core.plans import ParallelismPlan
from repro_torch.launch import trace_analysis
from repro_torch.launch.mesh import (
    DEBUG_MULTI_POD_PLAN,
    DEBUG_PLAN,
    PRODUCTION_MULTI_POD_PLAN,
    PRODUCTION_PLAN,
    mesh_from_plan,
)
from repro_torch.models import build_model
from repro_torch.models import sharding as SH
from repro_torch.models.shardctx import activation_sharding

# NVIDIA H100 SXM5 datasheet figures (the card ``chip_smoke.py`` runs on).
PEAK_FLOPS = 989.4e12  # dense bf16 FLOP/s
HBM_BW = 3.35e12  # HBM3 B/s
LINK_BW = 450e9  # NVLink 4, B/s per direction
LOGITS_DTYPE = torch.bfloat16

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"


def _plan(mesh_kind, debug):
    if isinstance(mesh_kind, ParallelismPlan):
        return mesh_kind
    multi = mesh_kind == "multi"
    if debug:
        return DEBUG_MULTI_POD_PLAN if multi else DEBUG_PLAN
    return PRODUCTION_MULTI_POD_PLAN if multi else PRODUCTION_PLAN


def _shard_bytes(shapes, specs, mesh) -> int:
    """Bytes one device holds of the tensors ``shapes`` laid out by
    ``specs`` (a dim split over axes holds 1/Π of it)."""
    total = 0
    for (_, t), (_, spec) in zip(T.flatten_with_paths(shapes),
                                 T.flatten_with_paths(specs)):
        parts = 1
        for entry in spec:
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None:
                    parts *= mesh.shape[a]
        total += t.numel() * t.element_size() // parts
    return total


def cell_layout(model, cfg, cell, mesh):
    """The cell's step on meta tensors and its layout: (fn, args, per-device
    argument, output and alias bytes, tp). ``fn(*args)`` runs the step."""
    tp = not SH.dp_only_mapping(cfg, cell, mesh)
    batch = model.input_specs(cell)
    batch_spec = SH.batch_spec_tree(batch, cfg, mesh, cell=cell, tp=tp)
    batch_bytes = _shard_bytes(batch, batch_spec, mesh)
    if cell.kind == "train":
        state = model.train_state_specs()
        state_bytes = _shard_bytes(state, SH.state_specs_tree(state, cfg, mesh, tp=tp),
                                   mesh)
        step = model.make_train_step()
        return (step, (state, batch), state_bytes + batch_bytes, state_bytes,
                state_bytes, tp)
    params = model.param_specs()
    param_bytes = _shard_bytes(params, SH.param_specs_tree(params, cfg, mesh), mesh)
    B = cell.global_batch
    logits = torch.empty((B, 1, cfg.vocab), dtype=LOGITS_DTYPE, device="meta")
    logit_bytes = _shard_bytes(logits, SH.logits_spec(cfg, mesh, B), mesh)
    if cell.kind == "prefill":
        cache = {"cache": model.cache_specs(B, cell.seq_len)}
        cache_bytes = _shard_bytes(
            cache, SH.batch_spec_tree(cache, cfg, mesh, cell=cell), mesh)
        return (model.prefill, (params, batch), param_bytes + batch_bytes,
                logit_bytes + cache_bytes, 0, True)
    cache_bytes = _shard_bytes({"cache": batch["cache"]},
                               {"cache": batch_spec["cache"]}, mesh)
    batch = dict(batch, pos=max(0, cell.seq_len - 1))  # an int, as make_batch's
    return (model.decode_step, (params, batch), param_bytes + batch_bytes,
            logit_bytes + cache_bytes, cache_bytes, True)


def run_cell(arch: str, shape: Union[str, ShapeCell], mesh_kind="single", *,
             debug: bool = False, skip_trace: bool = False) -> dict:
    """One dry-run record. ``shape``: a name of ``SHAPES`` or a cell;
    ``mesh_kind``: "single", "multi" or a ``ParallelismPlan``;
    ``skip_trace`` leaves out the trace (layout and memory only)."""
    cfg = get_config(arch)
    cell = SHAPES[shape] if isinstance(shape, str) else shape
    rec = {"arch": arch, "shape": cell.name,
           "mesh": mesh_kind if isinstance(mesh_kind, str) else list(mesh_kind.shape)}
    ok, reason = cfg.supports_cell(cell)
    if not ok:
        rec.update(skipped=True, reason=reason)
        return rec

    mesh = mesh_from_plan(_plan(mesh_kind, debug))
    n_dev = mesh.size
    rec["n_devices"] = n_dev
    model = build_model(cfg, device="meta")
    fn, args, arg_b, out_b, alias_b, tp = cell_layout(model, cfg, cell, mesh)
    rec["mapping"] = "tp" if tp else "dp-only"
    mem = {"argument_bytes": arg_b, "output_bytes": out_b, "alias_bytes": alias_b,
           "temp_bytes": None, "peak_bytes": None}
    rec["memory_analysis"] = mem
    if skip_trace:
        return rec

    t0 = time.perf_counter()
    with activation_sharding(mesh, tp=tp):
        _, totals = trace_analysis.analyze(fn, *args)
    rec["trace_s"] = round(time.perf_counter() - t0, 2)
    if n_dev == 1:
        mem["peak_bytes"] = arg_b + totals.peak_live_bytes
        mem["temp_bytes"] = mem["peak_bytes"] - arg_b - out_b + alias_b
    else:
        mem["reason"] = ("temp and peak bytes come from the liveness walk of "
                         "the global program, which is one device's only on "
                         "a one-device mesh")
    rec["trace_analysis"] = {
        "partitioned": False,
        "flops_per_device": totals.flops / n_dev,
        "bytes_per_device": totals.bytes_accessed / n_dev,
        "collective_wire_per_device": totals.collective_wire,
        "collective_msgs": totals.collective_msgs,
        "n_while": totals.n_while,
        "unknown_trip_counts": totals.unknown_trip,
        "kernels": totals.kernels,
        "n_ops": totals.n_ops,
    }
    print(f"  memory_analysis: {mem}")
    rec.update(_roofline(rec, cfg, cell, n_dev))
    return rec


def _roofline(rec, cfg, cell, n_dev) -> dict:
    ta = rec["trace_analysis"]
    flops_dev = ta["flops_per_device"]
    bytes_dev = ta["bytes_per_device"]
    wire_dev = sum(ta["collective_wire_per_device"].values())
    compute_s = flops_dev / PEAK_FLOPS
    memory_s = bytes_dev / HBM_BW
    collective_s = wire_dev / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    train = cell.kind == "train"
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    model_flops = cfg.model_flops_per_token(train=train) * tokens
    global_flops = flops_dev * n_dev
    return {"roofline": {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "model_flops": model_flops,
        "traced_flops_global": global_flops,
        "useful_flops_ratio": (model_flops / global_flops) if global_flops else None,
        "step_time_lower_bound_s": max(terms.values()),
    }}


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--debug-mesh", action="store_true",
                    help="tiny mesh (8 devices) for smoke tests")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = list(ASSIGNED) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    out_path = Path(args.out) if args.out else RESULTS_DIR / (
        "dryrun_debug.json" if args.debug_mesh else "dryrun.json")
    out_path.parent.mkdir(parents=True, exist_ok=True)
    results = {}
    if out_path.exists():
        results = json.loads(out_path.read_text())

    failures = 0
    t0 = time.perf_counter()
    for arch in archs:
        for shape in shapes:
            for mk in meshes:
                key = f"{arch}|{shape}|{mk}"
                print(f"[dryrun] {key}", flush=True)
                try:
                    rec = run_cell(arch, shape, mk, debug=args.debug_mesh)
                except Exception as e:
                    rec = {"arch": arch, "shape": shape, "mesh": mk,
                           "error": f"{type(e).__name__}: {e}"}
                    failures += 1
                    print(f"  FAILED: {rec['error']}")
                if rec.get("skipped"):
                    print(f"  skipped: {rec['reason']}")
                elif "roofline" in rec:
                    r = rec["roofline"]
                    print(f"  roofline: compute {r['compute_s']:.4f}s | "
                          f"memory {r['memory_s']:.4f}s | collective "
                          f"{r['collective_s']:.4f}s -> {r['dominant']}-bound "
                          f"(traced in {rec['trace_s']} s)")
                results[key] = rec
                out_path.write_text(json.dumps(results, indent=1))
    print(f"[dryrun] wrote {out_path} ({len(results)} cells, {failures} failures) "
          f"in {time.perf_counter() - t0:.1f} s")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
