"""step_update_ms (model step, ``models/model_api.py``, ``optim/adamw.py``):
host ms per window step inside the program's ``repro_torch.step.update``
span: the global norm, the clip and the leaf-by-leaf AdamW update as the
host issues them."""
from chaosbench.program_spans import CALLS, per_step_ms, spans  # noqa: F401

RANGES = spans.NAMES if spans else ()


def read(run):
    return per_step_ms(run, "repro_torch.step.update")
