"""Move training states between the JAX package and the port.

``jax.random`` draws cannot be replayed in torch, so parity tests
initialise with JAX, take ``jax.tree.map(np.asarray, state)`` and hand the
numpy tree to :func:`state_from_numpy`. Paths, shapes, dtypes and bytes are
kept, so replication manifests stay equal on both sides.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.device import resolve_device


def state_from_numpy(tree, device=None):
    """Nested dict of numpy arrays → the same nested dict of tensors on
    ``device`` (CUDA unless given). 0-d arrays stay 0-d."""
    dev = resolve_device(device)
    return T.tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev),
                      tree)


def state_to_numpy(tree):
    """Nested dict of tensors → nested dict of numpy arrays on the host."""
    return T.tree_map(lambda t: t.detach().cpu().numpy(), tree)
