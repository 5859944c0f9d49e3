"""push_copies (recovery tier, ``checkpoint/memory_ckpt.py``): the mean
count of tensor copies a window's replica push makes, the program's
counters ``copies`` of the phases of ``repro_torch.push`` (the flatten's
concatenation, then each shard cut out)."""
from chaosbench.program_spans import CALL, CALLS, records, spans  # noqa: F401

RANGES = spans.NAMES if spans else ()
PUSH = "repro_torch.push"


def read(run):
    pushes = len(records(run, PUSH))
    if not pushes:
        return None
    copies = sum(r.counters.get("copies", 0) for r in run.calls.get(CALL, ())
                 if r.parent == PUSH)
    return copies / pushes
