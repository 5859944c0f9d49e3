"""Churn scenario traces (the JSONL format only; the generators are not
ported)."""
from repro_torch.scenarios.trace import ScenarioTrace

__all__ = ["ScenarioTrace"]
