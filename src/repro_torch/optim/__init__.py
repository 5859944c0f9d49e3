from repro_torch.optim.adamw import (
    adamw,
    clip_by_global_norm,
    global_norm,
    make_optimizer,
)

__all__ = ["adamw", "clip_by_global_norm", "global_norm", "make_optimizer"]
