"""Scenario traces: ordered churn-event lists with a JSONL on-disk format,
from ``repro/scenarios/trace.py``.

A trace is the unit of reproducibility: the same file replays through the
discrete-event simulator (``repro_torch.core.engine.SimBackend``) and
through the real trainer (``repro_torch.elastic.TrainerBackend``). The
file format is the JAX package's, so a trace saved by either package
replays in the other:

    {"scenario": "poisson-churn", "seed": 7, "meta": {...}}
    {"t": 3.1, "kind": "join", "node": 1000, "links": {"2": [512.0, 0.01]}}
    {"t": 4.7, "kind": "leave", "node": 5}
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator, List

from repro_torch.core.engine import ChurnEvent


@dataclass
class ScenarioTrace:
    name: str
    seed: int
    events: List[ChurnEvent] = field(default_factory=list)
    meta: dict = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self) -> Iterator[ChurnEvent]:
        return iter(self.events)

    def sorted(self) -> "ScenarioTrace":
        ev = sorted(self.events, key=lambda e: e.t)
        return ScenarioTrace(self.name, self.seed, ev, dict(self.meta))

    def kinds(self) -> dict:
        out: dict = {}
        for e in self.events:
            out[e.kind] = out.get(e.kind, 0) + 1
        return out

    # -- persistence ---------------------------------------------------------

    def save(self, path) -> str:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        lines = [json.dumps({"scenario": self.name, "seed": self.seed,
                             "meta": self.meta}, sort_keys=True)]
        lines += [json.dumps(e.to_json(), sort_keys=True) for e in self.events]
        path.write_text("\n".join(lines) + "\n")
        return str(path)

    @classmethod
    def load(cls, path) -> "ScenarioTrace":
        lines = [l for l in Path(path).read_text().splitlines() if l.strip()]
        head = json.loads(lines[0])
        events = [ChurnEvent.from_json(json.loads(l)) for l in lines[1:]]
        return cls(head.get("scenario", "unnamed"), int(head.get("seed", 0)),
                   events, head.get("meta", {}))
