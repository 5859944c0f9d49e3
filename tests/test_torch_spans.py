"""The port's spans and counters (``repro_torch.spans``) on the CPU, on
reduced GPT-2: a step, an int8 scale-out and a replica push.

Off, nothing is recorded, no range opens and ``emit`` is never called.
On, under ``torch.profiler`` or after ``enable()``, every span records its
name, parent, step and times on the profiler's clock, and its counters
equal what the code did. Losses and state are the same bit for bit with
spans on and off.
"""
import ast
import collections
import pathlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch import tree as T
from repro_torch.checkpoint import MemoryReplicaStore
from repro_torch.configs import get_config
from repro_torch.core import telemetry
from repro_torch.core.sharding_alg import NeighborLink
from repro_torch.elastic import ElasticTrainer
from repro_torch.kernels import ops
from repro_torch.models import build_model

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEQ = 16
#: a record lies inside its profiler range, up to this many nanoseconds
#: at either end: both read the same clock, microseconds apart.
CLOCK_TOLERANCE_NS = 2_000_000

#: the spans of a step, an int8 scale-out and a push, with their parents
#: (on the CPU autograd runs the plain backward on the calling thread).
PARENTS = {
    "repro_torch.step": None,
    "repro_torch.step.forward": "repro_torch.step",
    "repro_torch.step.backward": "repro_torch.step",
    "repro_torch.step.update": "repro_torch.step",
    "repro_torch.step.read": "repro_torch.step",
    "flash_attention_plain_backward": "repro_torch.step.backward",
    "repro_torch.scale_out": None,
    "repro_torch.scale_out.plan": "repro_torch.scale_out",
    "repro_torch.scale_out.encode": "repro_torch.scale_out",
    "repro_torch.scale_out.decode": "repro_torch.scale_out",
    "repro_torch.scale_out.check": "repro_torch.scale_out",
    "repro_torch.scale_out.layout": "repro_torch.scale_out",
    "repro_torch.push": None,
    "repro_torch.push.flatten": "repro_torch.push",
    "repro_torch.push.assign": "repro_torch.push",
    "repro_torch.push.cut": "repro_torch.push",
}


def _link(device_id):
    fast = device_id % 2 == 0
    return NeighborLink(0.002 if fast else 0.01,
                        1 / (500e6 / 8) if fast else 1 / (120e6 / 8), 0.0)


def make_trainer():
    cfg = get_config("gpt2").reduced()
    trainer = ElasticTrainer(build_model(cfg, device="cpu"), initial=2, per_device_batch=2,
                             link_model=_link, codec="int8")
    trainer.attach_recovery(replica_store=MemoryReplicaStore())
    trainer.init(generator=torch.Generator().manual_seed(5))
    return trainer


def drive(trainer):
    """Two steps, an int8 scale-out, a step and a push; the losses and the
    scale-out's event."""
    rng = np.random.default_rng(11)
    losses = []

    def step():
        rows = trainer.global_batch
        tokens = rng.integers(0, trainer.model.cfg.vocab, (rows, SEQ + 1))
        losses.append(trainer.step({"tokens": tokens})["loss"])

    step()
    step()
    event = trainer.scale_out()
    step()
    trainer.checkpoint()
    return losses, event


@pytest.fixture(autouse=True)
def clean():
    spans.disable()
    spans.drain()
    yield
    spans.disable()
    spans.drain()


@pytest.fixture(scope="module")
def profiled():
    """One drive under the profiler: the trainer, the records, the scale-out
    event and the profiler's CPU events."""
    spans.drain()
    trainer = make_trainer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, event = drive(trainer)
    records = spans.drain()
    return trainer, records, event, list(prof.profiler.kineto_results.events())


def by_name(records):
    out = collections.defaultdict(list)
    for r in records:
        out[r.name].append(r)
    return out


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    emitted, ranges = [], []
    monkeypatch.setattr(spans, "emit", emitted.append)
    monkeypatch.setattr(spans, "record_function", lambda name: ranges.append(name))
    assert not spans.on()
    assert spans.span("repro_torch.step") is spans.span("repro_torch.push")
    drive(make_trainer())
    assert emitted == [] and ranges == [] and spans.drain() == []


@pytest.mark.parametrize("how", ["profiler", "enable"])
def test_on_records_every_span_with_parent_and_step(how):
    trainer = make_trainer()
    if how == "profiler":
        with profile(activities=[ProfilerActivity.CPU]):
            assert spans.on()
            drive(trainer)
    else:
        spans.enable()
        drive(trainer)
        spans.disable()
    assert not spans.on()
    records = spans.drain()
    assert {r.name for r in records} == set(PARENTS)
    for r in records:
        assert r.parent == PARENTS[r.name], r
        assert r.start_ns <= r.end_ns
    steps = [r for r in records if r.name == "repro_torch.step"]
    assert [r.step for r in steps] == [0, 1, 2]
    assert [(r.attrs["members"], r.attrs["rows"], r.attrs["after_change"]) for r in steps] \
        == [(2, 4, False), (2, 4, False), (3, 6, True)]
    # every span of a step carries that step's count; the scale-out and the
    # push the trainer's count when they ran, as their events do
    for r in records:
        if r.name.startswith("repro_torch.scale_out"):
            assert r.step == 2
        elif r.name.startswith("repro_torch.push"):
            assert r.step == 3
    for s in steps:
        inside = [r for r in records if s.start_ns <= r.start_ns and r.end_ns <= s.end_ns
                  and r is not s]
        assert {r.step for r in inside} == {s.step}
        assert len(inside) >= 5
    out = by_name(records)["repro_torch.scale_out"][0]
    assert out.attrs == {"members": 3,
                         "state_bytes": sum(t.numel() * t.element_size()
                                            for t in T.leaves(trainer.state))}


def test_counters_equal_what_the_code_does(profiled):
    trainer, records, event, _ = profiled
    named = by_name(records)
    n_state = len(T.leaves(trainer.state))
    n_params = len(T.leaves(trainer.state["params"]))
    state_bytes = sum(t.numel() * t.element_size() for t in T.leaves(trainer.state))
    # the round trip's check waits for the device once per leaf of the state
    (check,) = named["repro_torch.scale_out.check"]
    assert check.counters == {"syncs": n_state}
    (plan,) = named["repro_torch.scale_out.plan"]
    assert plan.counters == {"shards": event.plan_summary["n_shards"]}
    codec = event.plan_summary["codec"]
    for name in ("repro_torch.scale_out.encode", "repro_torch.scale_out.decode"):
        (rec,) = named[name]
        assert rec.counters == {"leaves": n_state, "payload_bytes": codec["payload_bytes"],
                                "wire_bytes": codec["wire_bytes"]}
    assert [r.counters for r in named["repro_torch.step.update"]] == [{"leaves": n_params}] * 3
    assert [r.counters for r in named["repro_torch.step.read"]] == [{"reads": 4}] * 3
    # a push copies the state once (the flatten), then each shard once
    (push,) = named["repro_torch.push"]
    held = trainer.replica_store._shards
    assert push.attrs == {"holders": 3, "shards": sum(len(s) for s in held.values()),
                          "bytes": state_bytes}
    (flatten,), (cut,) = named["repro_torch.push.flatten"], named["repro_torch.push.cut"]
    assert flatten.counters == {"copies": 1}
    assert cut.counters == {"copies": push.attrs["shards"]}
    assert named["repro_torch.push.assign"][0].counters == {}


def test_every_range_the_program_opens_is_named(profiled):
    """Every program range in a profile, and every span name in the
    program's source, is one of ``spans.NAMES``."""
    _, records, _, events = profiled
    seen = {e.name() for e in events
            if e.name().startswith("repro_torch.") or e.name().endswith("_plain_backward")}
    assert seen == set(PARENTS) == {r.name for r in records}
    assert set(ops.BACKWARD_RANGES) <= set(spans.NAMES)
    assert len(set(spans.NAMES)) == len(spans.NAMES)
    in_source = set()
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "span" and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "spans"):
                arg = node.args[0]
                if isinstance(arg, ast.Constant):
                    in_source.add(arg.value)
                else:  # kernels.ops passes the backward's name through
                    assert path.name == "ops.py", ast.dump(arg)
    assert in_source | set(ops.BACKWARD_RANGES) == set(spans.NAMES)


@pytest.mark.parametrize("kernel", ["wkv6", "ssd"])
def test_recurrences_plain_backwards_are_spans(kernel):
    g = torch.Generator().manual_seed(0)
    if kernel == "wkv6":
        r = torch.randn((1, 8, 2, 16), generator=g, requires_grad=True)
        lw = -torch.rand((1, 8, 2, 16), generator=g)
        args = (r, r, r, lw, torch.zeros((2, 16)))
        fn = ops.wkv6
    else:
        x = torch.randn((1, 8, 2, 16), generator=g, requires_grad=True)
        bc = torch.randn((1, 8, 8), generator=g)
        dt = torch.rand((1, 8, 2), generator=g) + 0.01
        args = (x, dt, torch.zeros(2), bc, bc)
        fn = ops.ssd
    fn(*args)[0].sum().backward()
    assert spans.drain() == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(*args)[0].sum().backward()
    name = f"{kernel}_plain_backward"
    assert [r.name for r in spans.drain()] == [name]
    assert name in {e.name() for e in prof.profiler.kineto_results.events()}


def test_records_are_on_the_profilers_clock(profiled):
    """Each record lies inside its ``record_function`` range: both carry
    Unix-epoch nanoseconds."""
    _, records, _, events = profiled
    ranges = collections.defaultdict(list)
    for e in events:
        if e.name() in PARENTS:
            ranges[e.name()].append((e.start_ns(), e.start_ns() + e.duration_ns()))
    for name, recs in by_name(records).items():
        got = sorted((r.start_ns, r.end_ns) for r in recs)
        want = sorted(ranges[name])
        assert len(got) == len(want), name
        for (s, e), (rs, re_) in zip(got, want):
            assert rs - CLOCK_TOLERANCE_NS <= s <= e <= re_ + CLOCK_TOLERANCE_NS, name
            assert abs(s - rs) < CLOCK_TOLERANCE_NS and abs(e - re_) < CLOCK_TOLERANCE_NS


def test_on_and_off_bit_identical():
    results = []
    for on in (False, True):
        trainer = make_trainer()
        if on:
            spans.enable()
        losses, _ = drive(trainer)
        spans.disable()
        restored, _ = trainer.replica_store.restore(0)
        results.append((losses, trainer.state, restored))
    assert spans.drain()
    (l0, s0, r0), (l1, s1, r1) = results
    assert l0 == l1
    for a, b in zip(T.leaves(s0) + T.leaves(r0), T.leaves(s1) + T.leaves(r1)):
        assert a.dtype == b.dtype and torch.equal(a.reshape(-1).view(torch.uint8),
                                                  b.reshape(-1).view(torch.uint8))


def test_emit_is_looked_up_at_every_close(monkeypatch):
    seen = []
    monkeypatch.setattr(spans, "emit", seen.append)
    spans.enable()
    with spans.span("repro_torch.push", holders=2) as sp:
        spans.count("copies", 3)
        with spans.span("repro_torch.push.cut"):
            spans.count("copies")
            spans.count("copies", 2)
        sp.count("copies")
    assert [(r.name, r.parent, r.counters, r.attrs) for r in seen] == [
        ("repro_torch.push.cut", "repro_torch.push", {"copies": 3}, {}),
        ("repro_torch.push", None, {"copies": 4}, {"holders": 2})]
    assert spans.drain() == []


def test_buffer_keeps_the_newest(monkeypatch):
    monkeypatch.setattr(spans, "BUFFER", 3)
    monkeypatch.setattr(spans, "_buffer", collections.deque(maxlen=3))
    monkeypatch.setattr(spans, "dropped", 0)
    spans.enable()
    for i in range(5):
        spans.set_step(i)
        with spans.span("repro_torch.step"):
            pass
    assert [r.step for r in spans.drain()] == [2, 3, 4]
    assert spans.dropped == 2 and spans.drain() == []


def test_count_outside_any_span_is_dropped():
    spans.enable()
    spans.count("copies")
    with spans.span("repro_torch.step.read") as sp:
        pass
    spans.count("reads")
    assert sp.counters == {} and [r.counters for r in spans.drain()] == [{}]


def test_collect_spans_exposes_histograms_and_counters(profiled):
    _, records, _, _ = profiled
    reg = telemetry.collect_spans(telemetry.MetricsRegistry(), records)
    text = reg.exposition()
    assert 'chaos_span_seconds_count{span="repro_torch.step"} 3' in text
    assert 'chaos_span_seconds_count{span="repro_torch.push.cut"} 1' in text
    named = by_name(records)
    syncs = named["repro_torch.scale_out.check"][0].counters["syncs"]
    assert f'chaos_span_syncs_total{{span="repro_torch.scale_out.check"}} {syncs}' in text
    copies = named["repro_torch.push.cut"][0].counters["copies"]
    assert f'chaos_span_copies_total{{span="repro_torch.push.cut"}} {copies}' in text
    assert 'chaos_span_reads_total{span="repro_torch.step.read"} 12' in text
    total = sum(r.seconds for r in named["repro_torch.step"])
    line = next(x for x in text.splitlines()
                if x.startswith('chaos_span_seconds_sum{span="repro_torch.step"}'))
    assert float(line.split()[-1]) == pytest.approx(total)
    # a second scrape of more records adds to the same families
    telemetry.collect_spans(reg, records)
    assert 'chaos_span_reads_total{span="repro_torch.step.read"} 24' in reg.exposition()
