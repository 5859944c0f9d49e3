"""Trace-driven churn scenarios for the ChurnEngine: the JSONL trace format
and the seeded generators, from ``repro/scenarios/``."""
from repro_torch.scenarios.trace import ScenarioTrace
from repro_torch.scenarios.generators import (
    GENERATORS,
    adversarial_churn,
    bandwidth_degradation,
    checkpointed_training,
    detector_stress,
    diurnal_waves,
    flash_crowd,
    link_flaps,
    mixed_faults,
    poisson_churn,
    regional_partition,
    reshard_churn,
    scheduler_churn,
    silent_failures,
)

__all__ = [
    "ScenarioTrace",
    "GENERATORS",
    "poisson_churn",
    "diurnal_waves",
    "regional_partition",
    "flash_crowd",
    "link_flaps",
    "adversarial_churn",
    "bandwidth_degradation",
    "checkpointed_training",
    "mixed_faults",
    "silent_failures",
    "detector_stress",
    "scheduler_churn",
    "reshard_churn",
]
