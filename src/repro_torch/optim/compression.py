"""Gradient and payload compression, from ``repro/optim/compression.py``:
top-k sparsification with error feedback (``topk_compress_ef``,
``ef_init``) and the per-block int8 quantization of replication payloads
(``Q_BLOCK``, ``int8_quantize``, ``int8_dequantize``, ``compressed_bytes``).

``int8_quantize`` is the plain reference that the shard codec kernel
(``repro_torch/kernels/shard_codec.py``) must match bit for bit: the same
per-block scale formula (max-abs times the fp32 constant 1/127, with a 1e-12
floor) and the same round-half-to-even, so codes and scales are identical
to the JAX package's on the same input.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import tree as T

Q_BLOCK = 256


def topk_compress_ef(grads, residual, k_frac: float = 0.01):
    """Top-|k| sparsification with error feedback. Returns (sparse_grads,
    new_residual): of each leaf's ``g + r`` (fp32), the entries whose
    magnitude reaches the k-th largest (``k = max(1, int(numel *
    k_frac))``; ties all pass) are kept, the rest carried in the residual."""

    def one(g, r):
        g = g.to(torch.float32) + r
        flat = g.reshape(-1)
        k = max(1, int(flat.numel() * k_frac))
        thresh = torch.topk(torch.abs(flat), k).values[-1]
        sparse = torch.where(torch.abs(g) >= thresh, g, torch.zeros_like(g))
        return sparse, g - sparse

    paths, pairs = zip(*((path, one(g, r)) for (path, g), r in zip(
        T.flatten_with_paths(grads), T.leaves(residual))))
    return (T.unflatten(paths, [s for s, _ in pairs]),
            T.unflatten(paths, [r for _, r in pairs]))


def ef_init(params):
    return T.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params)


def int8_quantize(x: torch.Tensor, block: int = Q_BLOCK):
    """x: any-shape float tensor → (codes int8 (nb, block), scales fp32 (nb,), meta)."""
    n = x.numel()
    pad = (-n) % block
    xf = F.pad(x.to(torch.float32).reshape(-1), (0, pad)).reshape(-1, block)
    scale = torch.clamp(xf.abs().amax(dim=1), min=1e-12) * (1.0 / 127.0)
    codes = torch.clamp(torch.round(xf / scale[:, None]), -127, 127).to(torch.int8)
    return codes, scale, (tuple(x.shape), x.dtype)


def int8_dequantize(codes: torch.Tensor, scale: torch.Tensor, meta,
                    block: int = Q_BLOCK) -> torch.Tensor:
    """Inverse of :func:`int8_quantize`. Every fp32 element comes back within
    ``scale_of_its_block / 2`` of the original (up to fp32 rounding of the
    ratio and of ``code * scale``); see the JAX function for the contract."""
    shape, dtype = meta
    n = 1
    for s in shape:
        n *= int(s)
    xf = codes.to(torch.float32) * scale[:, None]
    xf = xf.reshape(-1)[:n].reshape(shape)
    if not dtype.is_floating_point:
        # Round-to-nearest before the integer cast (a raw cast truncates).
        xf = torch.round(xf)
    return xf.to(dtype)


def compressed_bytes(codes: torch.Tensor, scale: torch.Tensor) -> int:
    return codes.numel() + scale.numel() * 4
