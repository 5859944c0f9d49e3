"""replica_push_ms (recovery tier, ``checkpoint/memory_ckpt.py``): the
mean time of ``MemoryReplicaStore.push`` of the whole state in the
window's checkpoints, in a span opened and closed by a synchronize."""

SPANS = {"replica_push": "repro_torch.checkpoint.memory_ckpt:MemoryReplicaStore.push"}


def read(run):
    xs = run.spans.get("replica_push", [])
    return 1e3 * sum(xs) / len(xs) if xs else None
