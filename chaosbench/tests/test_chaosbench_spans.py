"""The metrics that read the program's own spans (``repro_torch.spans``):
on tiny cells on the CPU, a traced run reads a value for each and holds one
``repro_torch.step`` record for each step of the window; an untraced run
records no span and reports none of them; against a program without the
spans they read nothing and hook nothing."""
import json
import subprocess
import sys
import textwrap
import time

import pytest

from chaosbench import program_spans
from chaosbench.catalog import HERE, Catalog
from chaosbench.drivers.elastic_train import Run
from chaosbench.trace import Trace
from tiny import make_checkout

ROOT = HERE.parent
SEED = 2**31 + 303
STEP = ["step_forward_ms", "step_backward_ms", "step_update_ms", "step_wait_ms",
        "step_update_device_ms"]
CHURN = ["plan_shards", "roundtrip_syncs", "push_copies"]
NEW = STEP + CHURN
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture(scope="module", autouse=True)
def threads():
    """Two host threads, as ``run.py`` gives a run: more, on a loaded host,
    slow a tiny step twentyfold."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def cat(tmp_path_factory):
    return Catalog.load(make_checkout(tmp_path_factory.mktemp("checkout"),
                                      cells=(("gpt2", "churn_stress"), ("gpt2", "steady"))))


def drive(cat, cell, traced, seconds=4.0):
    """One run of ``cell`` on the CPU with every per-layer metric's hooks;
    the ``Run`` and the readers."""
    spec = cat.workload(cell)
    driver = cat.driver(cat.traffic(spec["traffic"])["driver"])
    readers = {m["name"]: cat.metric(m["name"]) for m in BENCH["per_layer"]}
    run = driver.run(cat, spec, SEED, seconds, traced, time.perf_counter(), readers, "cpu")[0]
    return run, readers


def test_entries():
    cells = [w["name"] for w in BENCH["workloads"]]
    by_name = {m["name"]: m for m in BENCH["per_layer"]}
    assert [m["name"] for m in BENCH["per_layer"][-len(NEW):]] == NEW
    for name in STEP:
        assert by_name[name]["workloads"] == cells
        assert (by_name[name]["layer"], by_name[name]["moves"]) == ("model step",
                                                                    "train_tokens_per_s")
    churn = [c for c in cells if c.endswith(".churn_stress")]
    assert all(by_name[name]["workloads"] == churn for name in CHURN)


@pytest.mark.parametrize("name", NEW)
def test_every_new_metric_names_every_program_range(name):
    from repro_torch import spans

    mod = Catalog.load(HERE).metric(name)
    assert mod.RANGES == spans.NAMES
    if name != "step_update_device_ms":
        assert mod.CALLS == program_spans.CALLS


def test_traced_cell_reads_every_metric(cat):
    run, readers = drive(cat, "tiny-gpt2.tiny-churn_stress", True)
    records = run.calls[program_spans.CALL]
    assert len(program_spans.records(run, "repro_torch.step")) == len(run.steps) > 0
    assert any(e["kind"] == "join" for e in run.events)
    assert any(e["kind"] == "checkpoint" for e in run.events)
    values = {name: readers[name].read(run) for name in NEW}
    assert all(v is not None for v in values.values()), values
    # the counters are the program's: a join checks every leaf of the state
    # once, and a push copies the state once, then each of its shards
    assert values["roundtrip_syncs"] == len(run.state_numels) + 1  # the int32 step
    pushes = program_spans.records(run, "repro_torch.push")
    assert values["push_copies"] == 1 + sum(r.attrs["shards"] for r in pushes) / len(pushes)
    assert values["plan_shards"] > 0
    steps = len(run.steps)
    total = sum(s["s"] for s in run.steps) * 1e3 / steps
    assert 0 < sum(values[n] for n in STEP[:4]) <= total
    assert run.trace.ranges["repro_torch.step.update"][1] == steps
    # the program's ranges are the trace's ranges, none of them device work
    assert all(name not in run.trace.device for name in program_spans.spans.NAMES)
    assert {r.name for r in records} >= {"repro_torch.step", "repro_torch.scale_out.check",
                                         "repro_torch.push.cut"}


def test_steady_cell_reads_the_step_metrics(cat):
    run, readers = drive(cat, "tiny-gpt2.tiny-steady", True, seconds=2.0)
    assert len(program_spans.records(run, "repro_torch.step")) == len(run.steps) > 0
    assert all(readers[name].read(run) is not None for name in STEP)
    assert all(readers[name].read(run) is None for name in CHURN)


def test_untraced_run_records_and_reports_nothing(cat, monkeypatch):
    from repro_torch import spans

    emitted = []
    monkeypatch.setattr(spans, "emit", emitted.append)
    run, readers = drive(cat, "tiny-gpt2.tiny-churn_stress", False, seconds=2.0)
    assert run.steps and not emitted and program_spans.CALL not in run.calls
    assert all(readers[name].read(run) is None for name in NEW)


def test_by_hand():
    from repro_torch.spans import Record

    run = Run(cfg={"seq": 8}, mix={}, flops=lambda rows: 0.0)
    ms = 1_000_000

    def rec(name, parent, dur_ms, **counters):
        return Record(name, parent, 0, 0, dur_ms * ms, counters, {})

    run.calls[program_spans.CALL] = [
        rec("repro_torch.step.forward", "repro_torch.step", 30),
        rec("repro_torch.step.read", "repro_torch.step", 5, reads=4),
        rec("repro_torch.step", None, 100), rec("repro_torch.step", None, 100),
        rec("repro_torch.step.forward", "repro_torch.step", 50),
        rec("repro_torch.scale_out.plan", "repro_torch.scale_out", 9, shards=30),
        rec("repro_torch.scale_out.plan", "repro_torch.scale_out", 9, shards=40),
        rec("repro_torch.scale_out.check", "repro_torch.scale_out", 9, syncs=43),
        rec("repro_torch.push.flatten", "repro_torch.push", 1, copies=1),
        rec("repro_torch.push.cut", "repro_torch.push", 1, copies=9),
        rec("repro_torch.push", None, 3),
        rec("repro_torch.push.flatten", "repro_torch.push", 1, copies=1),
        rec("repro_torch.push.cut", "repro_torch.push", 1, copies=99),
        rec("repro_torch.push", None, 3)]
    run.trace = Trace(window_s=1.0, busy_s=0.5, ranges={"repro_torch.step.update": (0.03, 2)})
    cat = Catalog.load(HERE)
    got = {name: cat.metric(name).read(run) for name in NEW}
    assert got == pytest.approx({"step_forward_ms": 40.0, "step_backward_ms": 0.0,
                                 "step_update_ms": 0.0, "step_wait_ms": 2.5,
                                 "step_update_device_ms": 15.0, "plan_shards": 35.0,
                                 "roundtrip_syncs": 43.0, "push_copies": 55.0})


def test_without_the_programs_spans_nothing_is_hooked(tmp_path):
    """Against a program that has no ``repro_torch.spans``, the new metrics
    load, declare no range and no call, and read nothing."""
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
        sys.modules["repro_torch.spans"] = None
        from chaosbench.catalog import HERE, Catalog
        from chaosbench.drivers.elastic_train import Run
        from chaosbench.trace import Trace
        cat = Catalog.load(HERE)
        for name in {NEW!r}:
            mod = cat.metric(name)
            assert mod.RANGES == () and getattr(mod, "CALLS", {{}}) == {{}}, name
            run = Run(cfg={{"seq": 8}}, mix={{}}, flops=lambda rows: 0.0)
            run.trace = Trace(window_s=1.0, busy_s=0.5)
            assert mod.read(run) is None, name
        print("NOTHING_HOOKED")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("NOTHING_HOOKED")
