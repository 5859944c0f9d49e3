from repro_torch.checkpoint.async_ckpt import AsyncCheckpointer, load_checkpoint, save_checkpoint
from repro_torch.checkpoint.memory_ckpt import MemoryReplicaStore

__all__ = [
    "AsyncCheckpointer",
    "save_checkpoint",
    "load_checkpoint",
    "MemoryReplicaStore",
]
