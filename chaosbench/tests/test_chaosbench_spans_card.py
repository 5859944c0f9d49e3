"""On the card: the device-side markers of the program's ranges (a
``record_function`` range leaves one on the device's track) stay out of
the trace's device work, so that the idle share, the device ops and the
plain backward's share count only kernels, copies and sets. Skips without
a CUDA device (``-m cuda`` selects it)."""
import time

import pytest

from chaosbench import program_spans
from chaosbench import trace as T
from chaosbench.catalog import Catalog
from tiny import make_checkout


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_program_ranges_are_no_device_work(card, tmp_path, monkeypatch):
    import torch

    seen = {}
    read = T.read

    def keep(events, range_names=()):
        seen["events"] = list(events)
        seen["ranges"] = tuple(range_names)
        return read(seen["events"], range_names)

    monkeypatch.setattr(T, "read", keep)
    cat = Catalog.load(make_checkout(tmp_path, cells=(("gpt2", "churn_stress"),)))
    cell = cat.workload("tiny-gpt2.tiny-churn_stress")
    driver = cat.driver(cat.traffic(cell["traffic"])["driver"])
    readers = {m["name"]: cat.metric(m["name"]) for m in cat.bench["per_layer"]}
    run = driver.run(cat, cell, 2**31 + 404, 4.0, True, time.perf_counter(), readers, "cuda")[0]
    names = set(program_spans.spans.NAMES)
    assert names <= set(seen["ranges"])
    cuda = torch.autograd.DeviceType.CUDA
    markers = {e.name() for e in seen["events"] if e.device_type() == cuda and e.name() in names}
    assert "repro_torch.step.update" in markers  # the trap is there to fall into
    program = [k for k in run.trace.device if k.startswith("repro_torch.")
               or k.endswith("_plain_backward")]
    assert program == []
    ops = [name for name, _ in T.breakdown(run.trace, top=10_000)["device_ops"]]
    assert not [k for k in ops if k.startswith("repro_torch.") or k.endswith("_plain_backward")]
    steps = len(program_spans.records(run, "repro_torch.step"))
    assert steps == len(run.steps) > 0
    assert run.trace.ranges["repro_torch.step.update"][0] > 0
