"""Move training states, KV caches and recurrent states between the JAX
package and the port.

``jax.random`` draws cannot be replayed in torch, so parity tests
initialise with JAX, take ``jax.tree.map(np.asarray, state)`` and hand the
numpy tree to :func:`state_from_numpy`. Paths, shapes, dtypes and bytes are
kept, so replication manifests stay equal on both sides.

int8 leaves (adamw8bit's moment codes) and fp32 ones cross as they are;
bf16 leaves (a KV cache, RWKV-6's ``tm_x``/``cm_x``) cross bit for bit
through a 16-bit integer view: ``torch.from_numpy`` rejects numpy's
``ml_dtypes.bfloat16`` and ``Tensor.numpy`` rejects ``torch.bfloat16``.
``ml_dtypes`` (a JAX dependency) is imported only to hand a bf16 leaf back
to numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.device import resolve_device


def _from_numpy(a) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def state_from_numpy(tree, device=None):
    """Nested dict of numpy arrays → the same nested dict of tensors on
    ``device`` (CUDA unless given). 0-d arrays stay 0-d; bf16 stays bf16."""
    dev = resolve_device(device)
    return T.tree_map(lambda a: _from_numpy(a).to(dev), tree)


def state_to_numpy(tree):
    """Nested dict of tensors → nested dict of numpy arrays on the host
    (bf16 leaves as ``ml_dtypes.bfloat16``)."""
    return T.tree_map(_to_numpy, tree)
