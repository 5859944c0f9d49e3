"""The port's dry run (``launch/dryrun.py``, ``launch/trace_analysis.py``)
against the JAX package's ``launch/dryrun.py`` and ``hlo_analysis.py``.

Every ``ASSIGNED`` arch at every shape cell on the single- and multi-pod
meshes, with the trace off: the skipped cells are ``supports_cell``'s, the
mapping is JAX's ``dp_only_mapping``, and the per-device argument bytes
equal the sum of each argument's shard under JAX's specs (``AbstractMesh``,
``jax.eval_shape`` shapes). The flop rule on ``mm``, ``bmm``, ``einsum``
and ``linear`` equals ``hlo_analysis.analyze`` of the same op compiled by
JAX, exactly. Traced cells, the liveness walk, the CLI and the launcher's
``--lower-only`` run as well.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
ASSIGNED = ("paligemma-3b", "whisper-small", "gemma2-27b", "tinyllama-1.1b",
            "granite-34b", "llama3-405b", "kimi-k2-1t-a32b", "arctic-480b",
            "rwkv6-1.6b", "zamba2-1.2b")
MESH_KINDS = {"single": ((16, 16), ("data", "model")),
              "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _jax_shard_bytes(tree, spec_tree, sizes_by_axis):
    import jax
    from jax.sharding import PartitionSpec

    leaves = jax.tree_util.tree_leaves(tree)
    specs = jax.tree_util.tree_leaves(spec_tree,
                                      is_leaf=lambda x: isinstance(x, PartitionSpec))
    assert len(leaves) == len(specs)
    total = 0
    for leaf, spec in zip(leaves, specs):
        parts = 1
        for entry in spec:
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None:
                    parts *= sizes_by_axis[a]
        total += int(np.prod(leaf.shape, dtype=np.int64)) * np.dtype(leaf.dtype).itemsize \
            // parts
    return total


def test_assigned_equals_jax():
    from repro.configs import ASSIGNED as JASSIGNED
    from repro_torch.configs import ASSIGNED as TASSIGNED

    assert ASSIGNED == tuple(JASSIGNED) == tuple(TASSIGNED)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_cells_match_jax_layout(arch):
    from jax.sharding import AbstractMesh

    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jget
    from repro.models import build_model as jbuild
    from repro.models import sharding as JSH
    from repro_torch.configs import SHAPES
    from repro_torch.launch import dryrun

    jcfg = jget(arch)
    jm = jbuild(jcfg)
    for shape, jcell in JSHAPES.items():
        for kind, (sizes, names) in MESH_KINDS.items():
            rec = dryrun.run_cell(arch, shape, kind, skip_trace=True)
            ok, reason = jcfg.supports_cell(jcell)
            assert rec.get("skipped", False) == (not ok)
            if not ok:
                assert rec["reason"] == reason
                continue
            jmesh = AbstractMesh(sizes, names)
            axes = dict(zip(names, sizes))
            tp = not JSH.dp_only_mapping(jcfg, jcell,
                                         types.SimpleNamespace(devices=np.empty(sizes)))
            assert rec["mapping"] == ("tp" if tp else "dp-only")
            assert rec["n_devices"] == int(np.prod(sizes))
            batch = jm.input_specs(jcell)
            want = _jax_shard_bytes(batch, JSH.batch_spec_tree(
                batch, jcfg, jmesh, cell=jcell, tp=tp), axes)
            if jcell.kind == "train":
                state = jm.train_state_specs()
                want += _jax_shard_bytes(state, JSH.state_specs_tree(
                    state, jcfg, jmesh, tp=tp), axes)
            else:
                params = jm.param_specs()
                want += _jax_shard_bytes(params, JSH.param_specs_tree(
                    params, jcfg, jmesh), axes)
            mem = rec["memory_analysis"]
            assert mem["argument_bytes"] == want, (shape, kind)
            assert mem["temp_bytes"] is None and mem["peak_bytes"] is None
            assert dataclasses.astuple(SHAPES[shape]) == dataclasses.astuple(jcell)


def _jax_flops(fn, *shapes):
    import jax
    import jax.numpy as jnp

    from repro.launch.hlo_analysis import analyze

    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return analyze(jax.jit(fn).lower(*args).compile().as_text()).flops


def _port_flops(fn, *shapes):
    from repro_torch.launch import trace_analysis

    args = [torch.empty(s, device="meta") for s in shapes]
    return trace_analysis.analyze(fn, *args)[1].flops


FLOP_CASES = {
    "mm": (lambda a, b: a @ b, lambda a, b: torch.mm(a, b), [(64, 128), (128, 32)]),
    "bmm": (lambda a, b: a @ b, lambda a, b: torch.bmm(a, b), [(3, 4, 5), (3, 5, 6)]),
    "einsum": (lambda a, b: __import__("jax").numpy.einsum("bhqd,bhkd->bhqk", a, b),
               lambda a, b: torch.einsum("bhqd,bhkd->bhqk", a, b),
               [(2, 3, 4, 8), (2, 3, 5, 8)]),
    "linear": (lambda x, w, b: x @ w.T + b,
               lambda x, w, b: torch.nn.functional.linear(x, w, b),
               [(7, 5), (9, 5), (9,)]),
}


@pytest.mark.parametrize("op", list(FLOP_CASES))
def test_flop_rule_equals_hlo_analysis(op):
    jfn, tfn, shapes = FLOP_CASES[op]
    theirs = _jax_flops(jfn, *shapes)
    assert theirs > 0
    assert _port_flops(tfn, *shapes) == theirs


def test_liveness_walk_frees_dead_storages():
    from repro_torch.launch import trace_analysis

    x = torch.empty((1000, 1000), device="meta")
    out, t = trace_analysis.analyze(lambda: torch.relu(x @ x).sum())
    # x @ x and its relu alive together, then the 4-byte sum.
    assert t.peak_live_bytes == 8_000_000
    assert out.shape == () and t.n_ops == 3
    assert t.bytes_accessed == 3 * 4_000_000 + 2 * 4_000_000 + 4_000_000 + 4


def test_traced_cell_record():
    """A traced decode cell: the kernel entries counted once a layer, the
    program unpartitioned and without collectives, the roofline from the
    per-device counts."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun

    rec = dryrun.run_cell("tinyllama-1.1b", "decode_32k", "single")
    ta = rec["trace_analysis"]
    assert ta["partitioned"] is False and ta["collective_wire_per_device"] == {}
    assert ta["kernels"]["flash_attention"]["calls"] == get_config("tinyllama-1.1b").n_layers
    r = rec["roofline"]
    assert r["traced_flops_global"] == pytest.approx(ta["flops_per_device"] * 256)
    assert r["compute_s"] == ta["flops_per_device"] / dryrun.PEAK_FLOPS
    assert r["memory_s"] == ta["bytes_per_device"] / dryrun.HBM_BW
    assert rec["memory_analysis"]["peak_bytes"] is None
    assert "reason" in rec["memory_analysis"]


def test_one_device_plan_has_temp_and_peak():
    from repro_torch.configs import ShapeCell
    from repro_torch.core.plans import ParallelismPlan
    from repro_torch.launch import dryrun

    rec = dryrun.run_cell("tinyllama-1.1b", ShapeCell("small", 128, 2, "train"),
                          ParallelismPlan((1, 1), ("data", "model")))
    mem = rec["memory_analysis"]
    assert rec["n_devices"] == 1 and rec["mesh"] == [1, 1]
    assert mem["alias_bytes"] == mem["output_bytes"]  # the state, donated
    assert mem["peak_bytes"] > mem["argument_bytes"] > 0
    assert mem["temp_bytes"] == mem["peak_bytes"] - mem["argument_bytes"]


def test_cli_writes_records(tmp_path, capsys):
    from repro_torch.launch import dryrun

    out = tmp_path / "dry.json"
    assert dryrun.main(["--arch", "whisper-small", "--shape", "decode_32k", "--mesh",
                        "both", "--debug-mesh", "--out", str(out)]) == 0
    recs = json.loads(out.read_text())
    assert sorted(recs) == ["whisper-small|decode_32k|multi",
                            "whisper-small|decode_32k|single"]
    assert recs["whisper-small|decode_32k|multi"]["n_devices"] == 8
    assert "(2 cells, 0 failures)" in capsys.readouterr().out


def test_lower_only_subprocess_without_jax():
    code = ("import runpy, sys; sys.modules.update(jax=None, repro=None, networkx=None); "
            "sys.argv = ['train', '--arch', 'tinyllama-1.1b', '--lower-only', "
            "'--device', 'cpu']; runpy.run_module('repro_torch.launch.train', "
            "run_name='__main__')")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.rstrip().splitlines()[-1].startswith(
        "{'arch': 'tinyllama-1.1b', 'shape': 'train_4k'")


MASK_CASES = [("causal", 0, 0, 100, 100, 0), ("causal", 16, 0, 37, 300, 200),
              ("prefix", 0, 32, 64, 64, 0), ("prefix", 8, 16, 40, 90, 10),
              ("full", 0, 0, 5, 7, 0), ("causal", 0, 0, 1, 1152, 600)]


@pytest.mark.parametrize("case", MASK_CASES, ids=lambda c: "-".join(map(str, c)))
def test_attention_cost_counts_the_pairs_the_mask_admits(case):
    """``cost.admitted_pairs`` equals the mask's count, and the meta kernel
    entry reports ``cost.attention`` of those pairs and returns q's shape."""
    from repro_torch.kernels import cost, ops
    from repro_torch.launch import trace_analysis
    from repro_torch.models.layers import MaskSpec, _mask_block

    kind, window, prefix, Sq, Skv, q_offset = case
    spec = MaskSpec(kind, window, prefix)
    mask = _mask_block(spec, q_offset + torch.arange(Sq), torch.arange(Skv))
    pairs = cost.admitted_pairs(kind, window, prefix, Sq, Skv, q_offset)
    assert pairs == int(mask.sum())
    q = torch.empty((2, Sq, 4, 16), dtype=torch.bfloat16, device="meta")
    kv = torch.empty((2, Skv, 2, 16), dtype=torch.bfloat16, device="meta")
    before = dict(ops.launches)
    out, t = trace_analysis.analyze(lambda: ops.flash_attention(
        q, kv, kv, spec, scale=0.25, q_offset=q_offset))
    assert out.shape == q.shape and out.dtype == q.dtype
    flops, nbytes = cost.attention(2, Sq, Skv, 4, 2, 16, pairs)
    assert t.kernels == {"flash_attention": {"calls": 1, "flops": flops, "bytes": nbytes}}
    assert ops.launches == before  # the meta entry launches nothing


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "rwkv6-1.6b", "zamba2-1.2b"])
def test_replayed_backwards_equal_a_full_trace(arch, monkeypatch):
    """A plain backward traced once and replayed for the other layers gives
    the counts, bytes, peak and kernel records of tracing every layer."""
    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.launch import dryrun, trace_analysis
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=3)
    cell = ShapeCell("t", 128, 2, "train")

    def totals():
        model = build_model(cfg, device="meta")
        fn, args, *_ = dryrun.cell_layout(model, cfg, cell, {"data": 1, "model": 1})
        t = trace_analysis.analyze(fn, *args)[1]
        return (t.flops, t.bytes_accessed, t.n_ops, t.peak_live_bytes, t.kernels)

    replayed = totals()
    monkeypatch.setattr(trace_analysis._Sink, "vjp", lambda self, key, run: run())
    assert totals() == replayed
