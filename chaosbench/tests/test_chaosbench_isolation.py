"""Nothing the harness runs loads JAX, the JAX package ``repro``,
``benchmarks/`` or ``chip_smoke.py``; the reference and the yardstick load
nothing of the program; a run without a card or without the program
prints no result."""
import ast
import json
import subprocess
import sys
import textwrap

import pytest

from chaosbench.catalog import HERE

ROOT = HERE.parent
BANNED = {"jax", "jaxlib", "flax", "repro", "benchmarks", "chip_smoke"}
HARNESS = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.relative_to(HERE).parts)


def imported(path):
    """Top-level names of every module ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", HARNESS, ids=lambda p: str(p.relative_to(HERE)))
def test_no_banned_import(path):
    assert not imported(path) & BANNED


@pytest.mark.parametrize("path", sorted(HERE.glob("reference/*.py"))
                         + [HERE / "judge.py", HERE / "yardstick.py", HERE / "trace.py",
                            HERE / "traffic.py"], ids=lambda p: p.name)
def test_yardstick_loads_nothing_of_the_program(path):
    assert "repro_torch" not in imported(path)


def test_a_run_loads_no_jax(tmp_path):
    """A subprocess runs a tiny cell on the CPU, nothing blocked, and lists
    the top-level names of every module it loaded."""
    code = textwrap.dedent(f"""
        import sys, time, json
        from pathlib import Path
        sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}, {str(HERE / 'tests')!r}]
        import tiny
        from chaosbench import bench
        from chaosbench.catalog import Catalog
        cat = Catalog.load(tiny.make_checkout(Path({str(tmp_path)!r})))
        result = bench.execute(cat, "tiny-gpt2.tiny-churn_stress", 5, 0.5, False,
                               time.perf_counter(), device="cpu")
        assert result["correct"], result["checks"]
        print(json.dumps(sorted({{n.split(".")[0] for n, m in sys.modules.items() if m}})))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and "chaosbench" in loaded
    assert not loaded & BANNED


def run_cli(root, timeout=300):
    return subprocess.run([sys.executable, "chaosbench/run.py", "--workload", "gpt2.churn_stress",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=timeout, cwd=root)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = run_cli(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_without_the_program_no_result(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "chaosbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_cli(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
