"""step_forward_ms (model step, ``models/model_api.py``): host ms per
window step inside the program's ``repro_torch.step.forward`` span, the
loss's forward as the host issues it."""
from chaosbench.program_spans import CALLS, per_step_ms, spans  # noqa: F401

RANGES = spans.NAMES if spans else ()


def read(run):
    return per_step_ms(run, "repro_torch.step.forward")
