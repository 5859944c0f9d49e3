"""roundtrip_check_ms (replication): the mean time of
``roundtrip_max_error_ok`` (every decoded element within half its block's
scale) as the trainer calls it in a join, in a span opened and closed by a
synchronize."""

SPANS = {"roundtrip_check": "repro_torch.elastic.trainer:roundtrip_max_error_ok"}


def read(run):
    xs = run.spans.get("roundtrip_check", [])
    return 1e3 * sum(xs) / len(xs) if xs else None
