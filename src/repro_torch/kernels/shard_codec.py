"""Shard codec: int8 block quantization of replication payloads (paper §III
— state shards shipped to a joining node).

Port of ``repro/kernels/shard_codec.py``. The CUDA kernels are in
``csrc/shard_codec.cu``; the plain versions mirror ``repro/kernels/ref.py``
(``shard_codec_ref``/``shard_decode_ref``) and must agree with the kernels
bit for bit.

Encode: a flat fp32 leaf of ``n`` elements → int8 codes ``(nb, 256)`` + fp32
per-block scales ``(nb,)``, ``nb = ceil(n / 256)``; the ragged tail is
encoded as zeros. Decode: the inverse, ``codes * scales[:, None]``, as
``(nb, 256)`` or as the first ``numel`` values.

Callers go through ``kernels.ops.shard_encode``/``shard_decode``, which
count launches and pick the plain version only for CPU tensors.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

Q_BLOCK = 256


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the oracle on the card).
# ---------------------------------------------------------------------------


def shard_encode_plain(x: torch.Tensor):
    """Zero-pad to whole blocks, then ``ref.shard_codec_ref``: the scale is a
    reciprocal multiply, not ``/ 127``, as in the reference."""
    xf = x.reshape(-1)
    xb = F.pad(xf, (0, (-xf.numel()) % Q_BLOCK)).reshape(-1, Q_BLOCK)
    scale = torch.clamp(torch.amax(torch.abs(xb), dim=1), min=1e-12) * (1.0 / 127.0)
    codes = torch.clamp(torch.round(xb / scale[:, None]), -127, 127).to(torch.int8)
    return codes, scale


def shard_decode_plain(codes: torch.Tensor, scales: torch.Tensor,
                       numel: Optional[int] = None) -> torch.Tensor:
    out = codes.to(torch.float32) * scales[:, None]
    return out if numel is None else out.reshape(-1)[:numel]


# ---------------------------------------------------------------------------
# CUDA kernels.
# ---------------------------------------------------------------------------


def _require_cuda(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")


def shard_encode_kernel(x: torch.Tensor):
    """CUDA encode of a float32 tensor of any shape (read flat)."""
    _require_cuda(x, torch.float32, "shard_encode")
    xf = x.contiguous().reshape(-1)
    n = xf.numel()
    nb = -(-n // Q_BLOCK)
    codes = torch.empty((nb, Q_BLOCK), dtype=torch.int8, device=x.device)
    scales = torch.empty((nb,), dtype=torch.float32, device=x.device)
    if nb:
        lib = build.load()
        build.check(lib.repro_shard_encode(xf.data_ptr(), n, codes.data_ptr(),
                                           scales.data_ptr(), nb,
                                           build.stream_of(x)),
                    "shard_encode")
    return codes, scales


def shard_decode_kernel(codes: torch.Tensor, scales: torch.Tensor,
                        numel: Optional[int] = None) -> torch.Tensor:
    """CUDA decode. Returns ``(nb, 256)`` fp32, or the first ``numel`` values
    flat when ``numel`` is given."""
    _require_cuda(codes, torch.int8, "shard_decode codes")
    _require_cuda(scales, torch.float32, "shard_decode scales")
    nb = codes.shape[0]
    if codes.shape != (nb, Q_BLOCK) or scales.shape != (nb,):
        raise ValueError(f"shard_decode: codes {tuple(codes.shape)} and "
                         f"scales {tuple(scales.shape)} do not match")
    full = nb * Q_BLOCK
    n = full if numel is None else int(numel)
    if not 0 <= n <= full:
        raise ValueError(f"shard_decode: numel {n} exceeds {full}")
    codes, scales = codes.contiguous(), scales.contiguous()
    out = torch.empty((n,), dtype=torch.float32, device=codes.device)
    if n:
        lib = build.load()
        build.check(lib.repro_shard_decode(codes.data_ptr(), scales.data_ptr(),
                                           n, out.data_ptr(),
                                           build.stream_of(codes)),
                    "shard_decode")
    return out.reshape(nb, Q_BLOCK) if numel is None else out
