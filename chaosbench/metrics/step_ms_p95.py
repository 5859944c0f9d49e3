"""step_ms_p95 (end to end, host clock): the nearest-rank 95th percentile
of the window's step times, each closed by a synchronize."""
from chaosbench.yardstick import percentile


def read(run):
    return 1e3 * percentile([s["s"] for s in run.steps], 95) if run.steps else None
