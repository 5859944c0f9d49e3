"""Spans and counters at the boundaries of the training step, the
scale-out and the replica push, on the profiler's clock.

``span(name, **attrs)`` is a context manager and ``count(key, n)`` adds to
a counter of the innermost span open on the calling thread. Both are off
by default: a span then costs a check of two flags and returns a shared
no-op, opens no range, reads no clock and keeps nothing. They are on while
a ``torch.profiler`` records, and after ``enable()`` until ``disable()``.

When on, a span opens a ``torch.profiler.record_function`` range of its
name, so that a trace places the device's kernels, and the gaps between
them, inside the program's ranges. On close it hands a :class:`Record` to
the module's ``emit``, looked up at every close, so that a function set as
``spans.emit`` sees every record. The default ``emit`` keeps the newest
:data:`BUFFER` records (``dropped`` counts the older ones it let go), and
``drain()`` takes them. ``core.telemetry.collect_spans`` exposes drained
records to Prometheus.

A record's times are ``time.time_ns()``, Unix-epoch nanoseconds: the clock
the profiler stamps its events with, so a record lies inside its range
within microseconds. Its ``step`` is the trainer's step count when it
opened (``set_step``), which every span of one step shares, the plain
backwards that autograd runs on its own thread included. No span
synchronizes the device: a span around asynchronous work times its launch.
"""
from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import torch.autograd.profiler as _profiler
from torch.profiler import record_function

#: every range the program opens, in the order a step, a scale-out and a
#: push open them; then the plain backwards of ``kernels.ops``.
NAMES = (
    "repro_torch.step",
    "repro_torch.step.forward",
    "repro_torch.step.backward",
    "repro_torch.step.update",
    "repro_torch.step.read",
    "repro_torch.scale_out",
    "repro_torch.scale_out.plan",
    "repro_torch.scale_out.encode",
    "repro_torch.scale_out.decode",
    "repro_torch.scale_out.check",
    "repro_torch.scale_out.layout",
    "repro_torch.push",
    "repro_torch.push.flatten",
    "repro_torch.push.assign",
    "repro_torch.push.cut",
    "flash_attention_plain_backward",
    "wkv6_plain_backward",
    "ssd_plain_backward",
)

#: records the default ``emit`` keeps before it drops the oldest.
BUFFER = 65_536

_enabled = False
_step = 0
_local = threading.local()
_buffer: collections.deque = collections.deque(maxlen=BUFFER)
#: the default ``emit`` runs on the autograd thread too
_lock = threading.Lock()
#: records the default ``emit`` dropped since the module loaded.
dropped = 0


@dataclass(frozen=True)
class Record:
    """One closed span."""
    name: str
    #: the span open on the same thread when this one opened
    parent: Optional[str]
    #: the trainer's step count when it opened
    step: int
    start_ns: int
    end_ns: int
    counters: dict = field(default_factory=dict)
    attrs: dict = field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def on() -> bool:
    """Whether spans are recorded now."""
    return _enabled or _profiler._is_profiler_enabled


def enable() -> None:
    """Record spans whether or not a profiler records."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Record spans only while a profiler records (the default)."""
    global _enabled
    _enabled = False


def set_step(step: int) -> None:
    """The step count that spans opened from now on carry."""
    global _step
    _step = step


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "attrs", "counters", "_parent", "_step", "_start", "_range")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs, self.counters = name, attrs, {}

    def count(self, key: str, n: int = 1) -> None:
        self.counters[key] = self.counters.get(key, 0) + n

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self):
        stack = _stack()
        self._parent = stack[-1].name if stack else None
        self._step = _step
        self._range = record_function(self.name)
        self._range.__enter__()
        stack.append(self)
        self._start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _stack().pop()
        self._range.__exit__(*exc)
        emit(Record(self.name, self._parent, self._step, self._start, end,
                    self.counters, self.attrs))
        return False


class _Off:
    """The span handed out while spans are off: it does nothing."""
    __slots__ = ()

    def count(self, key: str, n: int = 1) -> None:
        pass

    def set(self, **attrs) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, **attrs):
    """A span named ``name`` (one of :data:`NAMES`) with attributes
    ``attrs``; as a context manager it gives an object whose ``count(key,
    n)`` and ``set(**attrs)`` add to its record."""
    if not _enabled and not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, attrs)


def count(key: str, n: int = 1) -> None:
    """Add ``n`` to counter ``key`` of the innermost span open on this
    thread; nothing when spans are off or none is open."""
    if not _enabled and not _profiler._is_profiler_enabled:
        return
    stack = getattr(_local, "stack", None)
    if stack:
        stack[-1].count(key, n)


def emit(record: Record) -> None:
    """Keep ``record`` for ``drain``; at :data:`BUFFER` records the oldest
    goes."""
    global dropped
    with _lock:
        if len(_buffer) == BUFFER:
            dropped += 1
        _buffer.append(record)


def drain() -> list:
    """The records kept so far, oldest first; the buffer is left empty."""
    out = []
    while True:
        try:
            out.append(_buffer.popleft())
        except IndexError:
            return out
