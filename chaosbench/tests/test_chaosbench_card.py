"""On the card: every cell of ``BENCHMARK.json`` runs a short window
through ``run.py`` and prints a correct result with its end-to-end
metrics. Skips without a CUDA device (``-m cuda`` selects it)."""
import json
import subprocess
import sys

import pytest

from chaosbench.catalog import HERE, Catalog

ROOT = HERE.parent
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(card, cell):
    out = subprocess.run([sys.executable, "chaosbench/run.py", "--workload", cell, "--seed",
                          str(2**31 + 99), "--seconds", "5", "--trace", "0"],
                         capture_output=True, text=True, timeout=1200, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    want = {m["name"] for m in Catalog.load(HERE).end_to_end(cell)} - {"scaleout_ms"}
    assert want <= set(result["metrics"])
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
