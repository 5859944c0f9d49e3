"""step_mfu (model step: ``models/model_api.py``, ``transformer.py``,
``whisper.py``, ``layers.py``, ``optim/adamw.py``): the model FLOPs of the
window's steps (counted by the reference from the configuration, no
remat) over those steps' wall time, as a share of the card's bf16 peak
(989 TFLOP/s, dense, NVIDIA's H100 SXM data sheet)."""
from chaosbench.yardstick import PEAK_BF16_FLOPS


def read(run):
    seconds = sum(s["s"] for s in run.steps)
    if seconds <= 0:
        return None
    flops = sum(run.flops(s["rows"]) for s in run.steps)
    return 100.0 * flops / seconds / PEAK_BF16_FLOPS
