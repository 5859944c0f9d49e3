"""Spans and call records that the harness wraps around the program's
calls, from its own files.

A target is ``"module:attribute"``, the attribute possibly a dotted path
through a class (``"repro_torch.checkpoint.memory_ckpt:MemoryReplicaStore.push"``).
The wrapper replaces the attribute where the program looks it up, and
``Patches.restore`` puts the original back.
"""
from __future__ import annotations

import contextlib
import functools
import importlib
import time

from chaosbench.trace import PREFIX


def resolve(target: str):
    """(owner, attribute name) of a ``"module:attr.path"`` target."""
    module, _, path = target.partition(":")
    owner = importlib.import_module(module)
    *parents, last = path.split(".")
    for p in parents:
        owner = getattr(owner, p)
    return owner, last


class Patches:
    """Attributes replaced for the length of a run, restored in reverse."""

    def __init__(self):
        self._undo = []

    def wrap(self, target: str, make):
        """Replace ``target`` by ``make(original)``."""
        owner, name = resolve(target)
        orig = getattr(owner, name)
        setattr(owner, name, functools.wraps(orig)(make(orig)))
        self._undo.append((owner, name, orig))

    def restore(self):
        while self._undo:
            owner, name, orig = self._undo.pop()
            setattr(owner, name, orig)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.restore()


def label(name: str, traced: bool):
    """A profiler range ``chaosbench.<name>`` in a traced run."""
    if not traced:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(PREFIX + name)


def span(name: str, out: dict, sync, traced: bool):
    """A wrapper maker: the call's host-clock seconds, opened and closed by
    ``sync``, appended to ``out[name]``."""
    def make(fn):
        def timed(*args, **kwargs):
            sync()
            with label("span." + name, traced):
                t0 = time.perf_counter()
                result = fn(*args, **kwargs)
                sync()
                out.setdefault(name, []).append(time.perf_counter() - t0)
            return result
        return timed
    return make


def record(name: str, out: dict, extract):
    """A wrapper maker: ``extract(*args, **kwargs)`` of each call appended
    to ``out[name]``; no sync."""
    def make(fn):
        def recorded(*args, **kwargs):
            out.setdefault(name, []).append(extract(*args, **kwargs))
            return fn(*args, **kwargs)
        return recorded
    return make
