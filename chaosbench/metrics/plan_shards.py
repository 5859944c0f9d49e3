"""plan_shards (replication, ``core/replication.py``, ``core/plans.py``):
the mean count of shards in a window join's replication plan, the
program's counter ``shards`` of ``repro_torch.scale_out.plan``."""
from chaosbench.program_spans import CALLS, mean_counter, spans  # noqa: F401

RANGES = spans.NAMES if spans else ()


def read(run):
    return mean_counter(run, "repro_torch.scale_out.plan", "shards")
