"""The port's expert-parallel MoE path (``models/moe.py:_moe_expert_parallel``)
on a (data 2, model 2) mesh of 4 gloo processes on the CPU.

Reduced Arctic (dense residual) and reduced Kimi-K2 (shared expert) run
``moe_sublayer`` with 2 token groups under ``activation_sharding``, in fp32
and bf16, with the expert weights replicated over ``data`` and, with
``FSDP_MIN_PARAMS`` patched to 0 in both packages, all-gathered over it (the
ZeRO branch). Every rank's results (the output, and the gradients of
``sum(y · ct) + aux`` for the input and every parameter) are equal, and are
held to the port's single-device path and to JAX's ``shard_map`` path run
on 4 host devices with ``AxisType.Auto`` axes (which takes its
expert-parallel branch under jax 0.9):

* fp32: output and input gradient at ``_tol``, parameter gradients at
  ``_rec_tol``, against both.
* bf16: the output at 2e-2 against both, the input gradient at 2e-2
  against the single-device path. The parameter gradients are checked for
  shape and finiteness only. As in JAX, the expert weights enter the
  expert-parallel region in bf16 and each rank's bf16 gradient is summed
  across ranks, where the single-device path rounds one sum: where the two
  groups' shares cancel, a few elements differ by a bf16 step of the shares
  (up to 0.25 at magnitudes near 30; the router's, whose gate shares are
  summed over ``model``, on 3 to 14 of 256 elements). JAX's jitted bf16
  gradients differ from the port's eager ones by as much on either path.
"""
from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
GROUPS = 2
SHAPE = (4, 16)  # (B, S): 32 tokens a group
CASES = [(arch, dtype, zero)
         for arch in ("arctic-480b", "kimi-k2-1t-a32b")
         for dtype in ("float32", "bfloat16")
         for zero in (False, True)]
TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
REC_TOL = {"float32": dict(rtol=1e-3, atol=1e-4), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _case_name(case):
    arch, dtype, zero = case
    return f"{arch}-{dtype}-{'zero' if zero else 'replicated'}"


def _cfg(package_get_config, case):
    arch, _, zero = case
    return dataclasses.replace(package_get_config(arch).reduced(), fsdp=zero)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _torch_inputs(npz, dtype):
    params = {}
    for key in npz.files:
        if key.startswith("p/"):
            node = params
            *parents, leaf = key[2:].split("/")
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = torch.from_numpy(npz[key])
    x = torch.from_numpy(npz["x"]).to(getattr(torch, dtype))
    return params, x, torch.from_numpy(npz["ct"])


def _port_step(params, x, ct, cfg):
    """Output and gradients of ``sum(y · ct) + aux`` (params' in path order)."""
    from repro_torch import tree as T
    from repro_torch.models import moe

    paths, leaves = zip(*T.flatten_with_paths(params))
    live = [p.detach().requires_grad_(True) for p in leaves]
    xl = x.detach().requires_grad_(True)
    y, aux = moe.moe_sublayer(T.unflatten(paths, live), xl, cfg, n_groups=GROUPS)
    loss = (y.float() * ct).sum() + aux
    grads = torch.autograd.grad(loss, [xl, *live])
    return {"y": y.detach().float(), "dx": grads[0].float(),
            **{"d/" + "/".join(p): g for p, g in zip(paths, grads[1:])}}


def _worker(rank, port, tmp):
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import DEBUG_PLAN, mesh_from_plan
    from repro_torch.models import moe
    from repro_torch.models import sharding as SH
    from repro_torch.models.shardctx import activation_sharding

    torch.set_num_threads(1)  # one core a rank: the ranks share the host
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    try:
        mesh = mesh_from_plan(DEBUG_PLAN)
        taken = []
        inner = moe._moe_expert_parallel
        moe._moe_expert_parallel = lambda *a, **k: taken.append(1) or inner(*a, **k)
        for case in CASES:
            name = _case_name(case)
            npz = np.load(Path(tmp, name + ".npz"))
            params, x, ct = _torch_inputs(npz, case[1])
            SH.FSDP_MIN_PARAMS = 0 if case[2] else 8e9
            n = len(taken)
            with activation_sharding(mesh):
                out = _port_step(params, x, ct, _cfg(get_config, case))
            assert len(taken) == n + 1, f"{name}: the expert-parallel path did not run"
            torch.save(out, Path(tmp, f"{name}.rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


JAX_EP = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, Mesh
from repro.configs import get_config
from repro.models import moe
from repro.models.shardctx import activation_sharding

tmp, cases = sys.argv[1], eval(sys.argv[2])
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"),
            axis_types=(AxisType.Auto, AxisType.Auto))
taken = []
inner = moe._moe_expert_parallel_shardmap
moe._moe_expert_parallel_shardmap = lambda *a, **k: taken.append(1) or inner(*a, **k)
for name, arch, dtype, zero in cases:
    npz = np.load(f"{tmp}/{name}.npz")
    cfg = dataclasses.replace(get_config(arch).reduced(), fsdp=zero)
    moe.FSDP_MIN_PARAMS = 0 if zero else 8e9
    params = {}
    for key in npz.files:
        if key.startswith("p/"):
            node = params
            *parents, leaf = key[2:].split("/")
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = jnp.asarray(npz[key])
    x = jnp.asarray(npz["x"]).astype(dtype)
    ct = jnp.asarray(npz["ct"])

    def loss(p, x):
        with activation_sharding(mesh):
            y, aux = moe.moe_sublayer(p, x, cfg, n_groups=2)
        return jnp.sum(y.astype(jnp.float32) * ct) + aux, y

    n = len(taken)
    with mesh:
        (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(params, x)
    assert len(taken) == n + 1, name
    flat = jax.tree_util.tree_flatten_with_path(gp)[0]
    out = {"y": np.asarray(y.astype(jnp.float32)),
           "dx": np.asarray(gx.astype(jnp.float32))}
    for path, g in flat:
        out["d/" + "/".join(p.key for p in path)] = np.asarray(g)
    np.savez(f"{tmp}/{name}.jax.npz", **out)
print("JAX_EP_OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Writes each case's inputs, runs the 4 gloo ranks and JAX's 4 host
    devices on them, and returns the directory."""
    import jax

    from repro.configs import get_config as jax_get_config
    from repro.models import moe as jax_moe

    tmp = tmp_path_factory.mktemp("moe_ep")
    for i, case in enumerate(CASES):
        jcfg = _cfg(jax_get_config, case)
        host = jax.tree_util.tree_flatten_with_path(
            jax_moe.init_moe(jax.random.PRNGKey(i), jcfg))[0]
        rng = np.random.default_rng(i)
        x = rng.standard_normal((*SHAPE, jcfg.d_model)).astype(np.float32)
        ct = rng.standard_normal((*SHAPE, jcfg.d_model)).astype(np.float32)
        np.savez(tmp / (_case_name(case) + ".npz"), x=x, ct=ct,
                 **{"p/" + "/".join(p.key for p in path): np.asarray(v)
                    for path, v in host})
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    jax_run = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_EP), str(tmp),
         repr([(_case_name(c), *c) for c in CASES])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    torch.multiprocessing.spawn(_worker, args=(_free_port(), str(tmp)),
                                nprocs=WORLD)
    out, err = jax_run.communicate(timeout=600)
    assert jax_run.returncode == 0 and "JAX_EP_OK" in out, err[-4000:]
    return tmp


@pytest.mark.parametrize("case", CASES, ids=_case_name)
def test_expert_parallel_matches_single_device_and_jax(runs, case):
    from repro_torch.configs import get_config

    name, dtype = _case_name(case), case[1]
    npz = np.load(runs / (name + ".npz"))
    params, x, ct = _torch_inputs(npz, dtype)
    single = _port_step(params, x, ct, _cfg(get_config, case))
    jax_out = np.load(runs / (name + ".jax.npz"))
    ranks = [torch.load(runs / f"{name}.rank{r}.pt") for r in range(WORLD)]
    assert sorted(ranks[0]) == sorted(single) == sorted(jax_out.files)
    for other in ranks[1:]:  # every rank holds the whole result
        for key in single:
            assert torch.equal(other[key], ranks[0][key]), key
    ep = ranks[0]
    held = [k for k in single if dtype == "float32" or k in ("y", "dx")]
    for key in held:
        tol = TOL[dtype] if key in ("y", "dx") else REC_TOL[dtype]
        torch.testing.assert_close(ep[key], single[key], **tol,
                                   msg=lambda m, key=key: f"{key}: {m}")
        if dtype == "float32" or key == "y":
            torch.testing.assert_close(ep[key], torch.from_numpy(jax_out[key]), **tol,
                                       msg=lambda m, key=key: f"JAX's {key}: {m}")
    for key in set(single) - set(held):
        assert ep[key].shape == single[key].shape and bool(ep[key].isfinite().all())
