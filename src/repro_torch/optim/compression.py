"""Per-block int8 quantization of replication payloads, from
``repro/optim/compression.py`` (``Q_BLOCK``, ``int8_quantize``,
``int8_dequantize``, ``compressed_bytes``).

``int8_quantize`` is the plain reference that the shard codec kernel
(``repro_torch/kernels/shard_codec.py``) must match bit for bit: the same
per-block scale formula (max-abs times the fp32 constant 1/127, with a 1e-12
floor) and the same round-half-to-even, so codes and scales are identical
to the JAX package's on the same input.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

Q_BLOCK = 256


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
