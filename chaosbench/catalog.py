"""Finds what a cell is made of, by the names in ``BENCHMARK.json``.

A configuration is ``configs/<name>.json``, a traffic mix
``traffic/<name>.json``, a metric ``metrics/<name>.py``, the limits of the
comparison that decides ``correct`` ``limits/<config>.json``, a model
family's plain reference ``reference/<family>.py`` and a traffic mix's
driver ``drivers/<driver>.py``. A later cell adds files and entries; no
file here needs an edit for it.
"""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


def valid_name(name) -> bool:
    return isinstance(name, str) and NAME.fullmatch(name) is not None


def valid_unit(unit) -> bool:
    return isinstance(unit, str) and UNIT.fullmatch(unit) is not None


def _need_name(name, what):
    if not valid_name(name):
        raise ValueError(f"{what} {name!r} is not a valid name")
    return name


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


class Catalog:
    """The benchmark's entries and the files they name, under ``root``."""

    def __init__(self, bench: dict, root: Path):
        self.bench = bench
        self.root = Path(root)

    @classmethod
    def load(cls, root: Path = HERE) -> "Catalog":
        """The catalog of the checkout whose benchmark folder is ``root``."""
        root = Path(root)
        return cls(load_json(root.parent / "BENCHMARK.json"), root)

    # -- entries ------------------------------------------------------------

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config_entry(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    @staticmethod
    def _applies(metric: dict, cell: str) -> bool:
        return "workloads" not in metric or cell in metric["workloads"]

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.bench["end_to_end"] if self._applies(m, cell)]

    def per_layer(self, cell: str) -> list:
        return [m for m in self.bench["per_layer"] if self._applies(m, cell)]

    # -- files ---------------------------------------------------------------

    def config(self, name: str) -> dict:
        entry = self.config_entry(_need_name(name, "config"))
        return load_json(self.root.parent / entry["file"])

    def traffic(self, name: str) -> dict:
        return load_json(self.root / "traffic" / f"{_need_name(name, 'traffic')}.json")

    def limits(self, config: str) -> dict:
        return load_json(self.root / "limits" / f"{_need_name(config, 'config')}.json")

    def metric(self, name: str):
        return _module(self.root / "metrics" / f"{_need_name(name, 'metric')}.py",
                       f"chaosbench_metric_{name}")

    def reference(self, family: str):
        return _module(self.root / "reference" / f"{_need_name(family, 'family')}.py",
                       f"chaosbench_reference_{family}")

    def driver(self, name: str):
        return _module(self.root / "drivers" / f"{_need_name(name, 'driver')}.py",
                       f"chaosbench_driver_{name}")


def _module(path: Path, key: str):
    """Import the file at ``path`` as the module ``key`` (registered in
    ``sys.modules``, as dataclasses need)."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"{path} does not exist")
    key = key.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod
