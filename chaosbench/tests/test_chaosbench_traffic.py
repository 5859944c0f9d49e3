"""The generator and the inputs: the same seed gives the same trace and
inputs, another seed other ones; every seed does the same work (the same
membership at every step); the link model is ``chip_smoke.link_model``'s."""
import importlib.util
import itertools
import json

import pytest
import torch

from chaosbench import traffic
from chaosbench.catalog import HERE, Catalog
from chaosbench.reference import common as C

ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
MIXES = sorted({w["traffic"] for w in BENCH["workloads"]})
SEEDS = (0, 7, 2**31 + 11, 2**33 + 5)


def mix(name):
    return Catalog.load(HERE).traffic(name)


def window(m, seed, n=200):
    return list(itertools.islice(traffic.slots(m, seed), n))


def cycle_slots(m):
    """Slots in one cycle of the mix: its letters and its pushes."""
    letters = traffic.cycle_letters(m)
    every = m.get("checkpoint_every_steps", 0)
    steps = len(letters) * m["steps_per_slot"]
    assert not every or steps % every == 0
    return len(letters) + (steps // every if every else 0)


def memberships(m, slots):
    """The membership at each step, and at the end."""
    n, out = m["initial"], []
    for s in slots:
        out += [n] * s.steps
        kind = s.event and s.event["kind"]
        n += 1 if kind == "join" else -1 if kind in traffic.DEPARTURES else 0
        assert m["min_active"] <= n <= m["max_active"]
    return out, n


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_trace(name):
    m = mix(name)
    for seed in SEEDS:
        assert window(m, seed) == window(m, seed)


def test_other_seed_other_trace():
    m = mix("churn_stress")
    traces = [window(m, seed) for seed in SEEDS]
    assert all(a != b for a, b in itertools.combinations(traces, 2))


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_the_same_work(name):
    m = mix(name)
    runs = [window(m, seed, 20 * cycle_slots(m)) for seed in SEEDS]
    assert len({tuple(memberships(m, r)[0]) for r in runs}) == 1
    kinds = [sorted(s.event["kind"] if s.event else "-" for s in r) for r in runs]
    assert all(k == kinds[0] for k in kinds)


def test_churn_cycle_counts_and_pushes():
    m = mix("churn_stress")
    cycle = window(m, 3, cycle_slots(m))  # one cycle's 8 slots and its 4 pushes
    assert len(cycle) == 12
    kinds = [s.event["kind"] for s in cycle if s.event]
    assert kinds.count("join") == 4 and kinds.count("leave") == 3
    assert kinds.count("node-failure") == 1 and kinds.count("checkpoint") == 4
    assert len(kinds) == 12
    steps = 0
    for s in cycle:
        steps += s.steps
        if s.event and s.event["kind"] == "checkpoint":
            assert s.steps == 0 and steps % m["checkpoint_every_steps"] == 0


def test_link_events_taken_in_order():
    links = [{"kind": "link-degrade", "u": 1, "v": 2, "bandwidth_mbps": 60},
             {"kind": "link-join", "u": 1, "v": 2}]
    m = dict(mix("churn_stress"), cycle="JXDX", departures={"leave": 1}, link_events=links,
             checkpoint_every_steps=0)
    cycle = window(m, 5, 4)
    assert [s.event for s in cycle if s.event["kind"].startswith("link")] == links
    with pytest.raises(ValueError):
        traffic.check_mix(dict(m, link_events=links[:1]))


@pytest.mark.parametrize("name,rows", [("churn_stress", [8, 12, 16]), ("steady", [12, 12, 12])])
def test_setup_visits_every_membership(name, rows):
    m = mix(name)
    assert traffic.setup_rows(m) == rows
    steps, end = memberships(m, traffic.setup_slots(m))
    assert [n * m["per_device_batch"] for n in steps] == rows and end == m["initial"]


def test_bad_cycle_refused():
    m = dict(mix("churn_stress"), cycle="JJJ")
    with pytest.raises(ValueError):
        traffic.check_mix(m)


def test_link_model_is_chip_smokes():
    spec = importlib.util.spec_from_file_location("chip_smoke_copy", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    m = mix("churn_stress")
    for i in range(m["pool_size"]):
        link = smoke.link_model(i)
        assert traffic.link_seconds(m, i) == (link.prop_s, link.trans_s_per_byte, link.sync_s)


@pytest.mark.parametrize("config", ["gpt2", "whisper-small"])
def test_inputs_from_the_seed(config):
    from tiny import tiny_config

    cfg = tiny_config(config)
    ref = Catalog.load(HERE).reference(cfg["family"])

    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return C.make_params(ref.specs(cfg), gen, "cpu"), ref.make_inputs(cfg, gen, 6, "cpu")

    (p1, d1), (p2, d2), (p3, d3) = draw(2**31 + 3), draw(2**31 + 3), draw(5)
    assert all(torch.equal(p1[k], p2[k]) and torch.equal(d1[j], d2[j]) for k in p1 for j in d1)
    assert not torch.equal(p1[("embed", "tok")], p3[("embed", "tok")])
    assert all(not torch.equal(d1[j], d3[j]) for j in d1)
    tokens = d1["tokens"]
    assert len({tuple(r) for r in tokens.tolist()}) == tokens.shape[0]


@pytest.mark.parametrize("name", MIXES)
def test_events_are_the_programs_churn_events(name):
    """Every event the generator makes is one the program's trace format
    takes (``ChurnEvent`` checks its kind)."""
    from repro_torch.core.engine import ChurnEvent

    m = mix(name)
    for s in window(m, 9) + traffic.setup_slots(m):
        if s.event:
            ChurnEvent(t=0.0, **s.event)
