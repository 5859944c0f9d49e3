"""The port's sharding layer against the JAX package's: the spec functions of
``models/sharding.py``, the plans of ``launch/mesh.py``, the DTensor blocks
the port's placements give on gloo meshes of 4 and 8 processes,
``plan_for_sharded_state``, ``constrain`` without a process group, the
elastic trainer's layouts and the re-exports of ``core``.

The JAX side runs on ``AbstractMesh(sizes, names)`` and ``jax.eval_shape``
shapes (the test that builds ``AbstractMesh`` from (name, size) pairs, and
``jax.make_mesh``'s Explicit axes, fail under jax 0.9; neither is used
here), and ``devices_indices_map`` on 8 host devices with ``AxisType.Auto``
axes in a subprocess. The port's runs on meta tensors. Specs compare as
tuples, with ``==``. ``test_spec_records_match_jax_and_digest`` pins the
digest ``chip_smoke.py`` checks on the card.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import socket
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SPEC_ARCHS = ("gpt2", "paligemma-3b", "whisper-small", "gemma2-27b", "tinyllama-1.1b",
              "granite-34b", "llama3-405b", "kimi-k2-1t-a32b", "arctic-480b",
              "rwkv6-1.6b", "zamba2-1.2b")
MESHES = [((2, 2), ("data", "model")), ((2, 2, 2), ("pod", "data", "model")),
          ((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((4, 4), ("data", "model"))]
#: (plan sizes, names, reduced config, optimizer) of the gloo runs.
GLOO_RUNS = {4: ((2, 2), ("data", "model"), "arctic-480b", "adamw"),
             8: ((2, 2, 2), ("pod", "data", "model"), "kimi-k2-1t-a32b", "adamw8bit")}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jmesh(sizes, names):
    from jax.sharding import AbstractMesh

    return AbstractMesh(tuple(sizes), tuple(names))


def _jflat(tree):
    """``{path: leaf}`` of a JAX tree, specs as leaves, tuples as tuples."""
    import jax
    from jax.sharding import PartitionSpec

    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            (tuple(leaf) if isinstance(leaf, PartitionSpec) else leaf)
            for path, leaf in leaves}


def _tflat(tree):
    from repro_torch import tree as T

    return {"/".join(path): (tuple(leaf) if isinstance(leaf, tuple) else leaf)
            for path, leaf in T.flatten_with_paths(tree)}


def _models(arch, optimizer=None):
    from repro.configs import get_config as jget
    from repro.models import build_model as jbuild
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    jcfg, cfg = jget(arch), get_config(arch)
    if optimizer is not None:
        jcfg = dataclasses.replace(jcfg, optimizer=optimizer)
        cfg = dataclasses.replace(cfg, optimizer=optimizer)
    return jcfg, jbuild(jcfg), cfg, build_model(cfg, device="meta")


# ---------------------------------------------------------------------------
# The spec functions at full width.
# ---------------------------------------------------------------------------


def test_spec_records_match_jax_and_digest():
    """``chip_smoke.sharding_records`` (the port) equals the same records
    from the JAX package for every config and plan, and their digest is
    ``chip_smoke.SHARDING_DIGEST``."""
    from repro.configs import SHAPES as JSHAPES
    from repro.launch import mesh as JM
    from repro.models import sharding as JSH

    CS = _chip_smoke()
    ours = CS.sharding_records()
    theirs = []
    plans = (JM.PRODUCTION_PLAN, JM.PRODUCTION_MULTI_POD_PLAN, JM.DEBUG_PLAN,
             JM.DEBUG_MULTI_POD_PLAN)
    train, decode = JSHAPES["train_4k"], JSHAPES["decode_32k"]
    for arch in CS.SHARDING_ARCHS:
        jcfg, jm, _, _ = _models(arch)
        state = jm.train_state_specs()
        batches = {"train": jm.input_specs(train), "decode": jm.input_specs(decode)}
        for plan in plans:
            mesh = _jmesh(plan.shape, plan.axes)
            key = [arch, list(plan.shape)]

            def entries(tree):
                return {p: CS.spec_entry(s) for p, s in _jflat(tree).items()}

            theirs.append(key + ["state", entries(JSH.state_specs_tree(state, jcfg, mesh))])
            for name, cell in (("train", train), ("decode", decode)):
                theirs.append(key + [f"batch/{name}", entries(JSH.batch_spec_tree(
                    batches[name], jcfg, mesh, cell=cell))])
            theirs.append(key + ["logits", CS.spec_entry(
                JSH.logits_spec(jcfg, mesh, decode.global_batch))])
            theirs.append(key + ["shard_report",
                                 JSH.shard_report(mesh, state["params"], jcfg)])
    assert len(ours) == len(theirs) == 5 * 4 * len(CS.SHARDING_ARCHS)
    for a, b in zip(ours, theirs):
        assert a == b, a[:3]
    digest = CS.records_digest(theirs)
    assert digest == CS.SHARDING_DIGEST, f"pin chip_smoke.SHARDING_DIGEST = {digest!r}"


@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_param_and_opt_specs_match_jax(arch):
    """``param_specs_tree`` (tp and dp-only) and ``opt_specs_tree`` of the
    adamw moments and the adamw8bit codes and scales, on the five meshes."""
    from repro.models import sharding as JSH
    from repro_torch.models import sharding as SH

    for optimizer in ("adamw", "adamw8bit"):
        jcfg, jm, cfg, tm = _models(arch, optimizer)
        jstate, tstate = jm.train_state_specs(), tm.train_state_specs()
        if optimizer == "adamw8bit":
            assert any(p.endswith("/codes") for p in _tflat(tstate["opt"]))
        for sizes, names in MESHES:
            jmesh, mesh = _jmesh(sizes, names), dict(zip(names, sizes))
            for tp in (True, False):
                ps = SH.param_specs_tree(tstate["params"], cfg, mesh, tp=tp)
                assert _tflat(ps) == _jflat(JSH.param_specs_tree(
                    jstate["params"], jcfg, jmesh, tp=tp)), (optimizer, sizes, tp)
                assert _tflat(SH.opt_specs_tree(tstate["opt"], ps, cfg, mesh, tp=tp)) \
                    == _jflat(JSH.opt_specs_tree(jstate["opt"], None, jcfg, jmesh, tp=tp)), \
                    (optimizer, sizes, tp)


@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_state_specs_match_jax(arch):
    from repro.models import sharding as JSH
    from repro_torch.models import sharding as SH

    jcfg, jm, cfg, tm = _models(arch)
    jstate, tstate = jm.train_state_specs(), tm.train_state_specs()
    assert _tflat(tstate).keys() == _jflat(jstate).keys()
    for sizes, names in MESHES:
        for tp in (True, False):
            assert _tflat(SH.state_specs_tree(tstate, cfg, dict(zip(names, sizes)), tp=tp)) \
                == _jflat(JSH.state_specs_tree(jstate, jcfg, _jmesh(sizes, names), tp=tp))


@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_batch_cache_and_logits_specs_match_jax(arch):
    """``batch_spec_tree`` of every cell's inputs (the decode cells' caches
    included) and of the prefill cells' caches, tp and dp-only;
    ``logits_spec`` at every cell's batch; ``dp_only_mapping``."""
    from repro.configs import SHAPES as JSHAPES
    from repro.models import sharding as JSH
    from repro_torch.configs import SHAPES
    from repro_torch.models import sharding as SH

    jcfg, jm, cfg, tm = _models(arch)
    for sizes, names in MESHES:
        jmesh, mesh = _jmesh(sizes, names), dict(zip(names, sizes))
        for name, cell in SHAPES.items():
            jcell = JSHAPES[name]
            trees = [(tm.input_specs(cell), jm.input_specs(jcell))]
            if cell.kind == "prefill":
                B, S = cell.global_batch, cell.seq_len
                trees.append(({"cache": tm.cache_specs(B, S)},
                              {"cache": jm.cache_specs(B, S)}))
            for tp in (True, False):
                for ttree, jtree in trees:
                    assert _tflat(SH.batch_spec_tree(ttree, cfg, mesh, cell=cell, tp=tp)) \
                        == _jflat(JSH.batch_spec_tree(jtree, jcfg, jmesh, cell=jcell,
                                                      tp=tp)), (sizes, name, tp)
            assert tuple(SH.logits_spec(cfg, mesh, cell.global_batch)) \
                == tuple(JSH.logits_spec(jcfg, jmesh, cell.global_batch))
            # JAX's reads the device count off ``mesh.devices``.
            assert SH.dp_only_mapping(cfg, cell, mesh) == JSH.dp_only_mapping(
                jcfg, jcell, types.SimpleNamespace(devices=np.empty(sizes)))


@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_shard_report_matches_jax(arch):
    from repro.models import sharding as JSH
    from repro_torch.models import sharding as SH

    jcfg, jm, cfg, tm = _models(arch)
    jparams, tparams = jm.param_specs(), tm.param_specs()
    for sizes, names in MESHES:
        ours = SH.shard_report(dict(zip(names, sizes)), tparams, cfg)
        assert ours == JSH.shard_report(_jmesh(sizes, names), jparams, jcfg), sizes
        assert ours == SH.shard_report(dict(zip(names, sizes)), tparams, cfg)


def test_spec_is_jax_partition_spec_as_a_tuple():
    from jax.sharding import PartitionSpec
    from repro_torch.models.sharding import P

    for entries in [(), ("data", None), (("data",), None), (("pod", "data"), "model"),
                    (None, ("data", "model"))]:
        assert tuple(P(*entries)) == tuple(PartitionSpec(*entries))


# ---------------------------------------------------------------------------
# Meshes and plans.
# ---------------------------------------------------------------------------


def test_plans_and_meshes_match_jax():
    from repro.launch import mesh as JM
    from repro_torch.launch import mesh as M

    for name in ("PRODUCTION_PLAN", "PRODUCTION_MULTI_POD_PLAN", "DEBUG_PLAN",
                 "DEBUG_MULTI_POD_PLAN"):
        ours, theirs = getattr(M, name), getattr(JM, name)
        assert (ours.shape, ours.axes, ours.devices) == (theirs.shape, theirs.axes,
                                                         theirs.devices)
        mesh = M.mesh_from_plan(ours)
        assert list(mesh.shape.items()) == list(zip(theirs.axes, theirs.shape))
        assert mesh.devices is None and mesh.size == theirs.n_devices
    assert M.make_production_mesh(multi_pod=True).shape == {"pod": 2, "data": 16,
                                                            "model": 16}
    assert M.make_debug_mesh().shape == {"data": 2, "model": 2}
    mesh = M.mesh_from_plan(M.DEBUG_PLAN, devices=["a", "b", "c", "d"])
    assert mesh.devices.tolist() == [["a", "b"], ["c", "d"]]
    with pytest.raises(ValueError, match="3 devices for a \\(2, 2\\) plan"):
        M.mesh_from_plan(M.DEBUG_PLAN, devices=[0, 1, 2])


def test_device_mesh_needs_a_process_group_of_the_plan_size():
    """No process group: ``device_mesh()`` raises and builds nothing; the
    module and the mesh touch no process group."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as M
    from repro_torch.models.shardctx import live_device_mesh

    assert not dist.is_initialized()
    mesh = M.mesh_from_plan(M.DEBUG_PLAN)
    with pytest.raises(RuntimeError, match="no process group"):
        mesh.device_mesh()
    assert live_device_mesh(mesh) is None
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# Blocks on gloo meshes.
# ---------------------------------------------------------------------------


JAX_INDICES = """
import dataclasses, json, sys
import jax, numpy as np
from jax.sharding import AxisType, Mesh, NamedSharding
from repro.configs import get_config
from repro.models import build_model
from repro.models import sharding as SH

out = {}
for world, (sizes, names, arch, opt) in json.loads(sys.argv[1]).items():
    cfg = dataclasses.replace(get_config(arch).reduced(), optimizer=opt)
    mesh = Mesh(np.array(jax.devices()[:int(world)]).reshape(sizes), tuple(names),
                axis_types=(AxisType.Auto,) * len(names))
    state = build_model(cfg).train_state_specs()
    leaves = jax.tree_util.tree_flatten_with_path(state)[0]
    blocks = {}
    for tp in (True, False):
        specs = SH.state_specs_tree(state, cfg, mesh, tp=tp)
        spec_leaves = jax.tree_util.tree_flatten(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
        for (path, leaf), spec in zip(leaves, spec_leaves):
            m = NamedSharding(mesh, spec).devices_indices_map(leaf.shape)
            blocks[f"{tp}|" + "/".join(k.key for k in path)] = {
                str(d.id): [None if s == slice(None) else [s.start, s.stop] for s in idx]
                for d, idx in m.items()}
    out[world] = blocks
print(json.dumps(out))
"""


def _block_json(idx):
    return [None if s == slice(None) else [s.start, s.stop] for s in idx]


@pytest.fixture(scope="module")
def jax_blocks():
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_INDICES),
                          json.dumps({str(w): v for w, v in GLOO_RUNS.items()})],
                         capture_output=True, text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-4000:]
    return {int(k): v for k, v in json.loads(res.stdout.strip().splitlines()[-1]).items()}


def _gloo_state(world):
    """The reduced config, its port state specs over the plan's mesh (tp and
    dp-only, keyed ``"{tp}|path"``) and seeded values for every leaf."""
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models import sharding as SH

    sizes, names, arch, opt = GLOO_RUNS[world]
    cfg = dataclasses.replace(get_config(arch).reduced(), optimizer=opt)
    shapes = build_model(cfg, device="meta").train_state_specs()
    specs = {f"{tp}|" + "/".join(p): s for tp in (True, False)
             for p, s in T.flatten_with_paths(SH.state_specs_tree(
                 shapes, cfg, dict(zip(names, sizes)), tp=tp))}
    rng = np.random.default_rng(world)
    values = {}
    for path, leaf in T.flatten_with_paths(shapes):
        if leaf.dtype.is_floating_point:
            v = torch.from_numpy(rng.standard_normal(tuple(leaf.shape)).astype(np.float32))
        else:
            v = torch.from_numpy(rng.integers(-100, 100, tuple(leaf.shape))).to(leaf.dtype)
        values["/".join(path)] = v
    return cfg, specs, values


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _gloo_worker(rank, world, port, blocks_path):
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    from repro_torch.launch import mesh as M
    from repro_torch.models import sharding as SH
    from repro_torch.models.shardctx import activation_sharding, constrain, live_device_mesh

    torch.set_num_threads(1)  # one core a rank: the ranks share the host
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        sizes, names = GLOO_RUNS[world][:2]
        plan = M.DEBUG_PLAN if world == 4 else M.DEBUG_MULTI_POD_PLAN
        mesh = M.mesh_from_plan(plan)
        dm = mesh.device_mesh()
        assert dm.mesh_dim_names == tuple(names) and dm.device_type == "cpu"
        assert live_device_mesh(mesh) is dm
        other = M.DEBUG_MULTI_POD_PLAN if world == 4 else M.DEBUG_PLAN
        try:
            M.mesh_from_plan(other).device_mesh()
            raise AssertionError("a mesh of another size was built")
        except RuntimeError as e:
            assert "ranks" in str(e)
        blocks = json.loads(Path(blocks_path).read_text())
        _, specs, values = _gloo_state(world)
        for key, spec in specs.items():
            full = values[key.split("|", 1)[1]]
            dt = distribute_tensor(full, dm, SH.placements(spec, dm.mesh_dim_names))
            want = full[tuple(slice(None) if b is None else slice(*b)
                              for b in blocks[key][str(rank)])]
            assert torch.equal(dt.to_local(), want), (rank, key, spec)
            assert torch.equal(dt.full_tensor(), full), (rank, key)
        # constrain: a DTensor is laid out by the spec, a plain tensor kept.
        x = torch.arange(4 * 6 * 4 * 2, dtype=torch.float32).reshape(4, 6, 4, 2)
        xd = distribute_tensor(x, dm, [Replicate()] * dm.ndim)
        with activation_sharding(mesh):
            y = constrain(xd, "batch", None, "model", None)
            assert constrain(x, "batch", None, "model", None) is x
        want = [Shard(0) if a in ("pod", "data") else Shard(2) for a in names]
        assert isinstance(y, DTensor) and list(y.placements) == want, y.placements
        assert torch.equal(y.full_tensor(), x)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("world", sorted(GLOO_RUNS))
def test_dtensor_blocks_equal_jax_devices_indices_map(world, jax_blocks, tmp_path):
    """The port's ``NamedSharding.devices_indices_map`` equals JAX's on the
    reduced config's whole train state under its tp and its dp-only specs;
    then on ``world`` gloo processes
    ``distribute_tensor`` with the port's placements gives every rank
    JAX's block of every leaf (rank r is JAX device r: both lay devices
    out row-major), and ``full_tensor()`` the leaf bit for bit."""
    from repro_torch.models import sharding as SH

    sizes, names = GLOO_RUNS[world][:2]
    mesh = SH.Mesh(sizes, names)
    _, specs, values = _gloo_state(world)
    ours = {key: {str(d): _block_json(idx) for d, idx in
                  SH.NamedSharding(mesh, s).devices_indices_map(
                      values[key.split("|", 1)[1]].shape).items()}
            for key, s in specs.items()}
    assert ours == jax_blocks[world]
    assert any(len({json.dumps(b) for b in m.values()}) == world
               for m in ours.values())  # some leaf splits over every axis
    path = tmp_path / "blocks.json"
    path.write_text(json.dumps(jax_blocks[world]))
    torch.multiprocessing.spawn(_gloo_worker, args=(world, _free_port(), str(path)),
                                nprocs=world)


def test_placements_need_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.models.sharding import P, placements

    names = ("pod", "data", "model")
    assert placements(P(("pod", "data"), None, "model"), names) == [
        Shard(0), Shard(0), Shard(2)]
    assert placements(P(), names) == [Replicate()] * 3
    with pytest.raises(ValueError, match="mesh's order"):
        placements(P(("model", "data")), names)


# ---------------------------------------------------------------------------
# plan_for_sharded_state.
# ---------------------------------------------------------------------------


def test_plan_for_sharded_state_matches_jax():
    from repro.core import replication as jrep
    from repro.core.sharding_alg import NeighborLink as JLink
    from repro_torch.core import replication as trep
    from repro_torch.core.sharding_alg import NeighborLink

    rng = np.random.default_rng(5)
    host = {"a": rng.standard_normal((64, 33)).astype(np.float32),
            "b": {"c": rng.standard_normal((1000,)).astype(np.float32)}}
    tree = {"a": torch.from_numpy(host["a"]), "b": {"c": torch.from_numpy(host["b"]["c"])}}
    rank_of = {0: 0, 1: 1, 2: 0, 3: 1}
    links = {0: (0.001, 2e-9, 0.0), 2: (0.002, 1e-9, 0.001)}
    ours = trep.plan_for_sharded_state(rank_of, {u: NeighborLink(*l) for u, l in links.items()},
                                       tree)
    theirs = jrep.plan_for_sharded_state(rank_of, {u: JLink(*l) for u, l in links.items()},
                                         host)
    assert ours.bytes_per_source == theirs.bytes_per_source
    assert ours.assignment.shards_per_neighbor == theirs.assignment.shards_per_neighbor
    assert [(r.start, r.nbytes) for r in ours.ranges] == [(r.start, r.nbytes)
                                                          for r in theirs.ranges]
    assert ours.manifest.total_bytes == theirs.manifest.total_bytes
    for module, arg in ((trep, tree), (jrep, host)):
        with pytest.raises(AssertionError, match="no same-rank neighbors"):
            module.plan_for_sharded_state(rank_of, {}, arg)


# ---------------------------------------------------------------------------
# constrain without a process group.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["gpt2", "arctic-480b", "zamba2-1.2b"])
def test_context_leaves_forward_and_step_bit_identical(arch):
    """One process: a forward and a train step under ``activation_sharding``
    on the debug mesh (tp and dp-only) are ``torch.equal`` to the same
    without a context."""
    from repro_torch import tree as T
    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import build_model
    from repro_torch.models.shardctx import activation_sharding, get_ctx

    model = build_model(get_config(arch).reduced(), device="cpu")
    batch = model.make_batch(ShapeCell("t", 16, 4, "train"),
                             torch.Generator().manual_seed(1))

    def run(ctx):
        state = model.init_train_state(torch.Generator().manual_seed(0))
        with ctx:
            loss, _ = model.loss_fn(state["params"], batch)
            state, metrics = model.make_train_step()(state, batch)
        return [loss, *metrics.values(), *T.leaves(state)]

    import contextlib

    base = run(contextlib.nullcontext())
    for tp in (True, False):
        got = run(activation_sharding(make_debug_mesh(), tp=tp))
        assert get_ctx() is None
        assert len(got) == len(base)
        assert all(torch.equal(a, b) for a, b in zip(got, base))


# ---------------------------------------------------------------------------
# The elastic trainer's layouts.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_trainer_layout_matches_jax_trainer(tp):
    """``mesh()``, ``_state_shardings()`` and ``_batch_sharding()`` at tp 1, 2
    and 4 over 4 devices against the JAX trainer's methods (run on a stand-in
    whose mesh is an ``AbstractMesh``); ``local_state`` gives views that
    reassemble every leaf bit for bit."""
    from jax.sharding import NamedSharding as JNamed

    from repro.elastic import trainer as JT
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.elastic import ElasticTrainer
    from repro_torch.models import build_model

    model = build_model(get_config("arctic-480b").reduced(), device="cpu")
    trainer = ElasticTrainer(model, initial=4)
    trainer.init()
    trainer.apply_reshard(tp)
    n = len(trainer.active)
    mesh = trainer.mesh()
    if tp > 1:
        assert mesh.shape == {"data": n // tp, "model": tp}
        jmesh = _jmesh((n // tp, tp), ("data", "model"))
    else:
        assert mesh.shape == {"data": n}
        jmesh = _jmesh((n,), ("data",))
    assert mesh.devices.reshape(-1).tolist() == trainer.active
    stub = types.SimpleNamespace(_tp=tp, mesh=lambda: jmesh)
    stub._state_sharding = types.MethodType(JT.ElasticTrainer._state_sharding, stub)
    host = T.tree_map(lambda t: t.numpy(), trainer.state)
    theirs = JT.ElasticTrainer._state_shardings(stub, host)
    ours = trainer._state_shardings()
    for path, sh in T.flatten_with_paths(ours):
        j = theirs if isinstance(theirs, JNamed) else _jflat(theirs)["/".join(path)]
        assert tuple(sh.spec) == tuple(j.spec), path
    assert trainer.layout is not None and all(
        a.spec == b.spec for a, b in zip(T.leaves(trainer.layout), T.leaves(ours)))
    assert tuple(trainer._batch_sharding().spec) == tuple(
        JT.ElasticTrainer._batch_sharding(stub).spec)
    rebuilt = T.tree_map(torch.empty_like, trainer.state)
    for device in trainer.active:
        blocks = trainer.local_state(device)
        for (path, block), leaf, out, sh in zip(
                T.flatten_with_paths(blocks), T.leaves(trainer.state), T.leaves(rebuilt),
                T.leaves(trainer.layout)):
            assert block.untyped_storage().data_ptr() == leaf.untyped_storage().data_ptr()
            pos = next(p for p in np.ndindex(*mesh.devices.shape)
                       if mesh.devices[p] == device)
            out[sh.indices(leaf.shape, pos)] = block
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(rebuilt), T.leaves(trainer.state)))
    sharded = [sh for sh in T.leaves(trainer.layout) if sh.spec != ()]
    assert bool(sharded) == (tp > 1)


def test_membership_change_and_restore_set_the_layout(tmp_path):
    from repro_torch import tree as T
    from repro_torch.checkpoint import AsyncCheckpointer
    from repro_torch.configs import get_config
    from repro_torch.elastic import ElasticTrainer
    from repro_torch.models import build_model

    model = build_model(get_config("gpt2").reduced(), device="cpu")
    trainer = ElasticTrainer(model, initial=4)
    trainer.init()
    ckpt = AsyncCheckpointer(str(tmp_path), keep=1)
    trainer.attach_recovery(checkpointer=ckpt)
    trainer.apply_reshard(2)
    assert T.leaves(trainer.layout)[0].mesh.shape == {"data": 2, "model": 2}
    trainer.checkpoint()
    trainer.scale_out()
    assert trainer.tp == 1 and T.leaves(trainer.layout)[0].mesh.shape == {"data": 5}
    trainer.scale_in()
    trainer.apply_reshard(4)
    trainer.restore_from("checkpoint")
    assert T.leaves(trainer.layout)[0].mesh.shape == {"data": 1, "model": 4}
    with pytest.raises(ValueError, match="not an active device"):
        trainer.local_state(trainer.pool[-1])
    ckpt.close()


# ---------------------------------------------------------------------------
# The re-exports of core.
# ---------------------------------------------------------------------------


def test_core_reexports_equal_jax_and_touch_no_device():
    import repro.core as J
    import repro_torch.core as C

    assert C.__all__ == J.__all__
    assert all(hasattr(C, name) for name in C.__all__)
    code = ("import sys, torch; sys.modules.update(jax=None, repro=None, networkx=None); "
            "import repro_torch.core as C; assert not torch.cuda.is_initialized(); "
            "print(len(C.__all__))")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == str(len(J.__all__))
