"""step_wait_ms (model step, ``elastic/trainer.py``): host ms per window
step inside the program's ``repro_torch.step.read`` span, the reads of the
step's metrics: the time the host waits for the device at a step's end. A
step's time less this is the host's time to issue it."""
from chaosbench.program_spans import CALLS, per_step_ms, spans  # noqa: F401

RANGES = spans.NAMES if spans else ()


def read(run):
    return per_step_ms(run, "repro_torch.step.read")
