"""``BENCHMARK.json`` and the files it names: every cell's configuration,
mix, limits, driver, reference and metrics are found by name, and the
entries keep the contract's names, units and keys."""
import json
import re

import pytest

from chaosbench import traffic
from chaosbench.catalog import HERE, Catalog, valid_name, valid_unit

ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
#: the numbers the judge reads, any of which a configuration's limits hold
READINGS = {"loss_gap", "grad_gap", "change_gap", "grad_diff", "grad_diff_median",
            "loss_gap_first", "codec_mismatch",
            "push_mismatch", "join_state_mismatch"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "chaosbench/run.py"]
    assert BENCH["paths"] == ["chaosbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    cat = Catalog.load(HERE)
    w = cat.workload(cell)
    cfg, mix = cat.config(w["config"]), cat.traffic(w["traffic"])
    assert cfg["name"] == w["config"]
    traffic.check_mix(mix)
    limits = cat.limits(w["config"])
    assert "change_gap" in limits and set(limits) <= READINGS
    assert hasattr(cat.driver(mix["driver"]), "run")
    ref = cat.reference(cfg["family"])
    assert callable(ref.loss_sum) and callable(ref.train_flops)
    for m in cat.end_to_end(cell) + cat.per_layer(cell):
        assert callable(cat.metric(m["name"]).read)


def test_names_and_units():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS + [m["name"] for m in METRICS]
             + [w["config"] for w in BENCH["workloads"]]
             + [w["traffic"] for w in BENCH["workloads"]]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    assert all(valid_name(n) for n in names), [n for n in names if not valid_name(n)]
    assert all(valid_unit(m["unit"]) for m in METRICS)
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        assert len({x["name"] for x in group}) == len(group)
    texts = ([c["why"] for c in BENCH["configs"] + BENCH["workloads"]]
             + [c["source"] for c in BENCH["configs"]]
             + [m["layer"] for m in BENCH["per_layer"]])
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("chaosbench/") and (ROOT / c["file"]).is_file()
        widths = re.compile(r"(hidden|intermediate|latent|state|projection|head|expan|_dim$|_rank$)")
        assert not [k for k in c["reduced"] if widths.search(k)]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert all(m["better"] in ("lower", "higher") for m in METRICS)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_what_its_layer_metrics_move(cell):
    cat = Catalog.load(HERE)
    e2e = {m["name"] for m in cat.end_to_end(cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = cat.per_layer(cell)
    assert layer
    assert all(m["moves"] in e2e for m in layer)


def test_one_layer_name_per_layer():
    by_metric = {m["name"]: m["layer"] for m in BENCH["per_layer"]}
    assert len(set(by_metric.values())) == len({v.lower() for v in by_metric.values()})
