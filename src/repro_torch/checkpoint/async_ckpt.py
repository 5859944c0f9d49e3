"""Disk checkpointing: synchronous and asynchronous (background thread),
atomic-rename durable, compressed MessagePack container, from
``repro/checkpoint/async_ckpt.py``. This is the cold tier of the
self-healing stack; ``MemoryReplicaStore`` is the fast one.

The container is the JAX package's, byte for byte: the MessagePack header
(written and read by the stdlib ``_msgpack``, as ``msgpack`` need not be
installed), ``b"\\x00SPLIT\\x00"``, then the state's flat byte stream
compressed with zstd when ``zstandard`` is installed and with zlib
otherwise (level 3; the header records which). A checkpoint written by
either package loads in the other. A zstd checkpoint read without
``zstandard`` raises.

Three differences from the JAX module, all from torch tensors being
mutable where JAX arrays are not:

* ``AsyncCheckpointer.save`` copies every leaf to the host
  (``detach().to("cpu", copy=True)``) before it queues the write. The
  port's train step updates parameters and moments in place, and on the
  CPU ``.cpu()`` and ``.numpy()`` alias the tensor, so without the copy the
  next step would rewrite a queued checkpoint.
* ``_unpack`` reads the skeleton's manifest only (``build_manifest``): it
  needs the paths, and flattening a state on the card would copy all of it.
* Loaded leaves are tensors of their own, copied out of the decompressed
  bytes, so the optimizer may write into them.
"""
from __future__ import annotations

import os
import queue
import tempfile
import threading
import time
import zlib
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

try:
    import zstandard as zstd
except ImportError:  # optional: fall back to stdlib zlib
    zstd = None

from repro_torch import tree as T
from repro_torch.checkpoint import _msgpack
from repro_torch.core.replication import build_manifest, flatten_state

FORMAT_VERSION = 1
SPLIT = b"\x00SPLIT\x00"


def _compress(raw, level: int):
    if zstd is not None:
        return "zstd", zstd.ZstdCompressor(level=level).compress(raw)
    return "zlib", zlib.compress(raw, level)


def _decompress(codec: str, comp: bytes) -> bytes:
    if codec == "zstd":
        if zstd is None:
            raise RuntimeError(
                "checkpoint was written with zstd but zstandard is not "
                "installed; install it or rewrite the checkpoint")
        return zstd.ZstdDecompressor().decompress(comp)
    if codec == "zlib":
        return zlib.decompress(comp)
    raise ValueError(f"unknown checkpoint codec {codec!r}")


def _header(manifest, codec: str) -> dict:
    """The container header of a state with ``manifest``."""
    return {
        "version": FORMAT_VERSION,
        "codec": codec,
        "entries": [
            {"path": e.path, "shape": list(e.shape), "dtype": e.dtype,
             "offset": e.offset, "nbytes": e.nbytes}
            for e in manifest.entries
        ],
        "total": manifest.total_bytes,
    }


def _pack(tree, level: int = 3) -> bytes:
    buf, manifest = flatten_state(tree)
    codec, comp = _compress(buf.cpu().numpy(), level)
    return _msgpack.packb(_header(manifest, codec)) + SPLIT + comp


def _unpack(data: bytes, skeleton):
    """The tree in ``data``, with ``skeleton``'s structure (its manifest
    paths must match the header's), as CPU tensors the caller owns."""
    head, _, comp = data.partition(SPLIT)
    header = _msgpack.unpackb(head)
    if header["version"] != FORMAT_VERSION:
        raise ValueError(f"checkpoint format {header['version']}, "
                         f"expected {FORMAT_VERSION}")
    # Pre-codec checkpoints were always zstd.
    codec = header.get("codec", "zstd")
    raw = np.frombuffer(_decompress(codec, comp), np.uint8)
    if raw.nbytes != header["total"]:
        raise ValueError(f"checkpoint holds {raw.nbytes} bytes, header says "
                         f"{header['total']}")
    manifest = build_manifest(skeleton)
    if len(manifest.entries) != len(header["entries"]):
        raise ValueError(f"checkpoint has {len(header['entries'])} leaves, "
                         f"the skeleton {len(manifest.entries)}")
    leaves = []
    for e, he in zip(manifest.entries, header["entries"]):
        if e.path != he["path"]:
            raise ValueError(f"checkpoint leaf {he['path']!r} where the "
                             f"skeleton has {e.path!r}")
        chunk = raw[he["offset"]: he["offset"] + he["nbytes"]].copy()
        leaves.append(torch.from_numpy(chunk).view(getattr(torch, he["dtype"]))
                      .reshape(he["shape"]))
    return T.unflatten(manifest.treedef, leaves)


def save_checkpoint(path, tree, step: Optional[int] = None) -> str:
    """Atomic checkpoint write (tmpfile + rename)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    data = _pack(tree)
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, str(path))
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return str(path)


def load_checkpoint(path, skeleton):
    """``skeleton``: a tree with the same structure (paths) as the saved
    one, e.g. a fresh init or the live state; only its manifest is read."""
    with open(path, "rb") as f:
        return _unpack(f.read(), skeleton)


class AsyncCheckpointer:
    """Background-thread checkpointer (DataStates-LLM / CheckFreq style):
    ``save`` snapshots to host RAM synchronously and writes to disk
    asynchronously, never blocking the training loop on disk I/O.
    ``writes`` lists ``(step, seconds)`` of each finished background write
    (pack, compress, write and fsync)."""

    def __init__(self, directory, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.writes: List[Tuple[int, float]] = []
        self._q: queue.Queue = queue.Queue()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            step, tree_host = item
            try:
                t0 = time.perf_counter()
                save_checkpoint(self.dir / f"step_{step:08d}.ckpt", tree_host, step)
                self.writes.append((step, time.perf_counter() - t0))
                self._gc()
            except Exception as e:  # surfaced on the next save/wait
                self._err = e
            finally:
                item = tree_host = None  # free the host copy while idle
                self._q.task_done()

    def _gc(self):
        ckpts = sorted(self.dir.glob("step_*.ckpt"))
        for old in ckpts[: -self.keep]:
            old.unlink(missing_ok=True)

    def save(self, step: int, tree):
        if self._err:
            raise self._err
        # Device→host snapshot happens here, synchronously: a copy of every
        # leaf, so in-place steps cannot reach the queued tree.
        host_tree = T.tree_map(lambda x: x.detach().to("cpu", copy=True), tree)
        self._q.put((step, host_tree))

    def wait(self):
        self._q.join()
        if self._err:
            raise self._err

    def close(self):
        self.wait()
        self._q.put(None)
        self._thread.join(timeout=10)

    def latest(self) -> Optional[Path]:
        ckpts = sorted(self.dir.glob("step_*.ckpt"))
        return ckpts[-1] if ckpts else None

    def restore_latest(self, skeleton):
        """Restore the newest checkpoint, robust against the background
        ``_gc``: a path returned by a directory scan can be unlinked by the
        worker thread before the read opens it. Scan newest-first, fall back
        to the next-newest on ``FileNotFoundError``, and re-scan once if
        every candidate vanished mid-pass."""
        for _ in range(2):
            ckpts = sorted(self.dir.glob("step_*.ckpt"), reverse=True)
            if not ckpts:
                return None, -1
            for p in ckpts:
                try:
                    data = p.read_bytes()
                except FileNotFoundError:
                    continue  # GC'd between the scan and the open
                return _unpack(data, skeleton), int(p.stem.split("_")[1])
        return None, -1
