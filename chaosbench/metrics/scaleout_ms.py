"""scaleout_ms (end to end, host clock): the mean wall time of the
window's joins, each the engine's handling of the event, opened and
closed by a synchronize."""


def read(run):
    joins = [e["s"] for e in run.events if e["kind"] == "join"]
    return 1e3 * sum(joins) / len(joins) if joins else None
