"""roundtrip_syncs (replication, ``core/replication.py``): the mean count
of host syncs in a window join's round-trip check, the program's counter
``syncs`` of ``repro_torch.scale_out.check`` (one per leaf it checks)."""
from chaosbench.program_spans import CALLS, mean_counter, spans  # noqa: F401

RANGES = spans.NAMES if spans else ()


def read(run):
    return mean_counter(run, "repro_torch.scale_out.check", "syncs")
