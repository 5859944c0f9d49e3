"""A configuration, a mix, limits and a metric added as new files, with
new entries in ``BENCHMARK.json``, run with no edit to any file that was
there."""
import hashlib
import json
import time

from chaosbench import bench
from chaosbench.catalog import HERE, Catalog
from tiny import make_checkout

METRIC = '''"""rows_per_step: the mean global batch of the window's steps."""


def read(run):
    return sum(s["rows"] for s in run.steps) / len(run.steps) if run.steps else None
'''


def digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_run_with_no_edit(tmp_path):
    before = digests(HERE)
    bench_dir = make_checkout(tmp_path, cells=(("gpt2", "churn_stress"),))
    (bench_dir / "metrics" / "rows_per_step.py").write_text(METRIC)
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["end_to_end"].append({"name": "rows_per_step", "unit": "rows", "better": "higher",
                               "bound": 0.25, "source": "host_clock",
                               "workloads": ["tiny-gpt2.tiny-churn_stress"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    result = bench.execute(Catalog.load(bench_dir), "tiny-gpt2.tiny-churn_stress", 3, 1.0, False,
                           time.perf_counter(), device="cpu")
    assert result["correct"]
    assert 4 <= result["metrics"]["rows_per_step"]["value"] <= 8  # 2 to 4 members of 2 rows
    after = digests(bench_dir)
    assert all(after[path] == digest for path, digest in before.items()
               if not str(path).startswith("tests"))
