"""step_update_device_ms (model step, ``optim/adamw.py``): device ms per
window step of the kernels launched inside the program's
``repro_torch.step.update`` range (the trace). Beside ``step_update_ms``
it says whether the leaf-by-leaf update is bound by its launches."""
from chaosbench.program_spans import spans

RANGES = spans.NAMES if spans else ()
UPDATE = "repro_torch.step.update"


def read(run):
    if run.trace is None:
        return None
    seconds, n = run.trace.ranges.get(UPDATE, (0.0, 0))
    return 1e3 * seconds / n if n else None
