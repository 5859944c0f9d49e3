"""plan_ms (replication: ``core/replication.py``, ``core/plans.py``,
``core/sharding_alg.py``): the mean time of ``plan_replication`` as the
trainer calls it in a join, in a span opened and closed by a
synchronize."""

SPANS = {"plan_replication": "repro_torch.elastic.trainer:plan_replication"}


def read(run):
    xs = run.spans.get("plan_replication", [])
    return 1e3 * sum(xs) / len(xs) if xs else None
