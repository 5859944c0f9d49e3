"""The port's recovery tiers against the JAX package's: the checkpoint
container (the stdlib MessagePack header against ``msgpack.packb``, the
packed bytes, checkpoints read across the packages), the
``AsyncCheckpointer`` (latest, gc, the restore/gc race, a snapshot that
in-place steps cannot reach) and the ``MemoryReplicaStore`` (the same
placement as the JAX store, holder loss, restores after in-place steps).

The state is a reduced GPT-2 train state after one JAX step (the Adam
moments are not zero), converted to torch on the CPU.
"""
from pathlib import Path

import jax
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import async_ckpt as jax_ckpt
from repro.checkpoint import memory_ckpt as jax_mem
from repro.configs import get_config as jax_get_config
from repro.core.sharding_alg import NeighborLink as JaxLink
from repro.models import build_model as jax_build_model
from repro_torch import tree as T
from repro_torch.checkpoint import (
    AsyncCheckpointer,
    MemoryReplicaStore,
    load_checkpoint,
    save_checkpoint,
)
from repro_torch.checkpoint import _msgpack
from repro_torch.checkpoint import async_ckpt
from repro_torch.configs import get_config
from repro_torch.convert import state_from_numpy
from repro_torch.core.replication import build_manifest, flatten_state
from repro_torch.core.sharding_alg import NeighborLink
from repro_torch.models import build_model

LINKS = {10: (0.001, 1e-8, 0.0), 11: (0.001, 2e-8, 0.0),
         12: (0.002, 1e-8, 0.0)}


@pytest.fixture(scope="module")
def states():
    cfg = jax_get_config("gpt2").reduced()
    model = jax_build_model(cfg)
    state = model.init_train_state(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, size=(2, 17))
    state, _ = jax.jit(model.make_train_step())(state, {"tokens": tokens})
    host = jax.tree.map(np.asarray, state)
    return host, state_from_numpy(host, device="cpu")


def _flat(tree) -> bytes:
    return flatten_state(tree)[0].numpy().tobytes()


def _jax_flat(host) -> bytes:
    return b"".join(np.ascontiguousarray(x).tobytes() for x in jax.tree.leaves(host))


def _clone(tree):
    return T.tree_map(lambda t: t.clone(), tree)


# ---------------------------------------------------------------------------
# The stdlib MessagePack encoder and decoder.
# ---------------------------------------------------------------------------

BOUNDARIES = ([0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
               2 ** 64 - 1]
              + ["s" * n for n in (0, 31, 32, 255, 256, 65535, 65536)]
              + ["é" * 16]  # 32 bytes of UTF-8 in 16 characters
              + [list(range(n)) for n in (0, 15, 16, 65536)]
              + [{f"k{i}": i for i in range(n)} for n in (0, 15, 16, 65536)]
              + [{"entries": [{"path": "a/b", "shape": [3, 0, 7]}],
                  "total": 19_198_427_140}])


@pytest.mark.parametrize("value", BOUNDARIES,
                         ids=lambda v: f"{type(v).__name__}-"
                                       f"{v if isinstance(v, int) else len(v)}")
def test_msgpack_matches_msgpack_packb(value):
    packed = msgpack.packb(value)
    assert _msgpack.packb(value) == packed
    assert _msgpack.unpackb(packed) == value


@pytest.mark.parametrize("value", [-1, True, 1.5, None, b"raw", (1, 2),
                                   2 ** 64, [1, -2], {"a": 0.5}])
def test_msgpack_rejects_other_types(value):
    with pytest.raises(TypeError):
        _msgpack.packb(value)


@pytest.mark.parametrize("data", [b"\xc0", b"\xcd\x01", b"\x01\x02",
                                  b"\x92\x01"])
def test_msgpack_unpack_rejects_malformed(data):
    with pytest.raises(ValueError):
        _msgpack.unpackb(data)


@pytest.mark.parametrize("name,total", [("gpt2", 1_784_835_076),
                                        ("rwkv6-1.6b", 19_198_427_140),
                                        ("zamba2-1.2b", 13_158_590_980)])
def test_msgpack_full_state_headers(name, total):
    """The container headers of the three full-size states, from inits on
    the meta device: the encoder's bytes are msgpack's and its decoder
    inverts them (RWKV-6's total needs a uint64)."""
    state = build_model(get_config(name), device="meta").init_train_state(
        torch.Generator())
    header = async_ckpt._header(build_manifest(state), "zlib")
    assert header["total"] == total
    packed = msgpack.packb(header)
    assert _msgpack.packb(header) == packed
    assert _msgpack.unpackb(packed) == header


# ---------------------------------------------------------------------------
# The container: packed bytes and checkpoints across the packages.
# ---------------------------------------------------------------------------


@pytest.fixture(params=["zstd", "zlib"])
def codec(request, monkeypatch):
    """Both packages compress with ``request.param``: zlib by setting their
    ``zstd`` module attribute to None."""
    if request.param == "zstd" and async_ckpt.zstd is None:
        pytest.skip("zstandard is not installed")
    if request.param == "zlib":
        monkeypatch.setattr(jax_ckpt, "zstd", None)
        monkeypatch.setattr(async_ckpt, "zstd", None)
    return request.param


def test_pack_bytes_equal_jax(states, codec):
    host, tstate = states
    packed = async_ckpt._pack(tstate)
    assert packed == jax_ckpt._pack(host)
    head = packed.partition(async_ckpt.SPLIT)[0]
    assert msgpack.unpackb(head)["codec"] == codec


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_loads_in_the_other_package(states, codec, writer, tmp_path):
    host, tstate = states
    path = tmp_path / "x.ckpt"
    if writer == "jax":
        jax_ckpt.save_checkpoint(path, host)
        back = load_checkpoint(path, tstate)
        assert _flat(back) == _flat(tstate)
        for a, b in zip(T.leaves(back), T.leaves(tstate)):
            assert a.dtype == b.dtype and a.shape == b.shape
    else:
        save_checkpoint(path, tstate)
        back = jax_ckpt.load_checkpoint(path, host)
        assert _jax_flat(back) == _jax_flat(host)


def test_loaded_leaves_are_owned_and_writable(states, tmp_path):
    _, tstate = states
    back = load_checkpoint(save_checkpoint(tmp_path / "x.ckpt", tstate), tstate)
    leaves = [x for x in T.leaves(back) if x.numel()]
    assert len({x.untyped_storage().data_ptr() for x in leaves}) == len(leaves)
    for x in leaves:
        x.add_(1)  # the optimizer writes in place


def test_zstd_checkpoint_without_zstandard_raises(states, tmp_path, monkeypatch):
    pytest.importorskip("zstandard")
    _, tstate = states
    path = save_checkpoint(tmp_path / "x.ckpt", tstate)
    monkeypatch.setattr(async_ckpt, "zstd", None)
    with pytest.raises(RuntimeError, match="zstandard"):
        load_checkpoint(path, tstate)


def test_unpack_rejects_another_state(states, tmp_path):
    _, tstate = states
    path = save_checkpoint(tmp_path / "x.ckpt", tstate)
    with pytest.raises(ValueError):
        load_checkpoint(path, {"w": torch.zeros(4)})


# ---------------------------------------------------------------------------
# AsyncCheckpointer (tests/test_checkpoint_churn.py and test_substrate.py).
# ---------------------------------------------------------------------------


def test_async_checkpointer_latest_and_gc(states, tmp_path):
    _, tstate = states
    st = _clone(tstate)
    ck = AsyncCheckpointer(tmp_path, keep=2)
    for step in (1, 2, 3):
        st["opt"]["step"].fill_(step)
        ck.save(step, st)
    ck.wait()
    restored, step = ck.restore_latest(st)
    assert step == 3
    assert int(restored["opt"]["step"]) == 3
    assert len(list(tmp_path.glob("step_*.ckpt"))) <= 2
    assert [s for s, _ in ck.writes] == [1, 2, 3]
    ck.close()


def test_restore_latest_survives_gc_race(tmp_path, monkeypatch):
    ck = AsyncCheckpointer(tmp_path, keep=3)
    for s in (1, 2):
        ck.save(s, {"w": torch.full((4,), float(s))})
    ck.wait()
    real = Path.read_bytes
    raised = []

    def flaky(self):
        # The newest checkpoint vanishes between the scan and the open,
        # exactly as a concurrent _gc would make it.
        if self.name == "step_00000002.ckpt" and not raised:
            raised.append(self)
            raise FileNotFoundError(self)
        return real(self)

    monkeypatch.setattr(Path, "read_bytes", flaky)
    tree, step = ck.restore_latest({"w": torch.zeros(4)})
    assert raised  # the race actually happened
    assert step == 1  # fell back to the surviving next-newest
    assert torch.equal(tree["w"], torch.full((4,), 1.0))
    ck.close()


def test_restore_latest_all_candidates_vanish_returns_none(tmp_path, monkeypatch):
    ck = AsyncCheckpointer(tmp_path, keep=3)
    ck.save(1, {"w": torch.zeros(2)})
    ck.wait()

    def always_gone(self):
        raise FileNotFoundError(self)

    monkeypatch.setattr(Path, "read_bytes", always_gone)
    tree, step = ck.restore_latest({"w": torch.zeros(2)})
    assert tree is None and step == -1
    monkeypatch.undo()
    ck.close()


def test_restore_latest_empty_dir(tmp_path):
    ck = AsyncCheckpointer(tmp_path)
    tree, step = ck.restore_latest({"w": torch.zeros(2)})
    assert tree is None and step == -1
    ck.close()


def test_save_then_in_place_step_restores_the_pre_step_state(states, tmp_path):
    """``save`` copies to the host: the port's step updates the state in
    place right after, and the checkpoint still holds the state before."""
    _, tstate = states
    model = build_model(get_config("gpt2").reduced(), device="cpu")
    state = _clone(tstate)
    before = _flat(state)
    ck = AsyncCheckpointer(tmp_path)
    ck.save(5, state)
    tokens = np.random.default_rng(1).integers(0, 256, size=(2, 17))
    state, _ = model.make_train_step()(state, {"tokens": tokens})
    assert _flat(state) != before  # the step really wrote in place
    ck.wait()
    tree, step = ck.restore_latest(state)
    assert step == 5 and _flat(tree) == before
    ck.close()


# ---------------------------------------------------------------------------
# MemoryReplicaStore.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("redundancy", [1, 2])
def test_replica_placement_matches_jax(states, redundancy):
    host, tstate = states
    jstore = jax_mem.MemoryReplicaStore(redundancy=redundancy)
    tstore = MemoryReplicaStore(redundancy=redundancy)
    jmeta = jstore.push(0, 4, host, {u: JaxLink(*l) for u, l in LINKS.items()})
    tmeta = tstore.push(0, 4, tstate, {u: NeighborLink(*l) for u, l in LINKS.items()})
    assert [(r.index, r.start, r.end) for r in tmeta.ranges] == \
        [(r.index, r.start, r.end) for r in jmeta.ranges]
    assert tmeta.holders == jmeta.holders
    assert set(tstore._shards) == set(jstore._shards)
    for key, shards in jstore._shards.items():
        assert sorted(tstore._shards[key]) == sorted(shards)
        for k, data in shards.items():
            assert tstore._shards[key][k].numpy().tobytes() == data
    for h in LINKS:
        assert tstore.bytes_held(h) == jstore.bytes_held(h)


def test_memory_replicas_survive_single_holder_loss(states):
    _, tstate = states
    store = MemoryReplicaStore(redundancy=2)
    store.push(owner=0, step=42, tree=tstate,
               neighbors={u: NeighborLink(*l) for u, l in LINKS.items()})
    store.drop_holder(10)  # a holder dies with the owner's shards
    back, step = store.restore(0, available=[11, 12])
    assert step == 42 and _flat(back) == _flat(tstate)


def test_memory_replicas_detect_unrecoverable(states):
    _, tstate = states
    store = MemoryReplicaStore(redundancy=1)
    store.push(owner=0, step=1, tree=tstate,
               neighbors={u: NeighborLink(*LINKS[u]) for u in (10, 11)})
    store.drop_holder(10)
    with pytest.raises(RuntimeError):
        store.restore(0, available=[11])
    with pytest.raises(KeyError):
        store.restore(7)


def test_restores_after_in_place_steps_return_the_pushed_bytes(states):
    """The store holds copies: in-place steps on the pushed state and on a
    restored state leave it untouched, so a second restore equals the first."""
    _, tstate = states
    model = build_model(get_config("gpt2").reduced(), device="cpu")
    step_fn = model.make_train_step()
    tokens = np.random.default_rng(2).integers(0, 256, size=(2, 17))
    state = _clone(tstate)
    pushed = _flat(state)
    store = MemoryReplicaStore()
    store.push(0, 1, state, {u: NeighborLink(*l) for u, l in LINKS.items()})
    state, _ = step_fn(state, {"tokens": tokens})
    assert _flat(state) != pushed
    first, _ = store.restore(0)
    assert _flat(first) == pushed
    first, _ = step_fn(first, {"tokens": tokens})
    second, step = store.restore(0)
    assert step == 1 and _flat(second) == pushed


def _stale_push_pair(store, tree_a, tree_b, link):
    """Push ``tree_a`` over holders 11 and 12, then ``tree_b`` over holders
    10 and 11 with the same links, so both pushes cut the same shards."""
    store.push(0, 1, tree_a, {11: link, 12: link})
    store.push(0, 2, tree_b, {10: link, 11: link})
    return store.restore(0)


def test_second_push_replaces_the_first(states):
    """A restore after a second push with other holders returns the second
    state: the port's push drops the owner's earlier shards."""
    _, tstate = states
    other = T.tree_map(lambda t: t + 1 if t.is_floating_point() else t, tstate)
    store = MemoryReplicaStore()
    back, step = _stale_push_pair(store, tstate, other,
                                  NeighborLink(0.001, 1e-8, 0.0))
    assert step == 2 and _flat(back) == _flat(other)
    assert store.bytes_held(12) == 0


def test_jax_store_restores_stale_shards_after_a_second_push(states):
    """Reference fault (ROADMAP Queue 3): the JAX store merges a second push
    into the first one's shard sets, and holder 12's stale shards outlive
    it, so the restore returns bytes of the first state."""
    host, _ = states
    other = jax.tree.map(lambda a: a + 1 if a.dtype.kind == "f" else a, host)
    back, step = _stale_push_pair(jax_mem.MemoryReplicaStore(), host, other,
                                  JaxLink(0.001, 1e-8, 0.0))
    assert step == 2
    got = np.frombuffer(_jax_flat(back), np.uint8)
    first = np.frombuffer(_jax_flat(host), np.uint8)
    second = np.frombuffer(_jax_flat(other), np.uint8)
    assert ((got == first) | (got == second)).all()
    assert (got != second).any()
