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

Many-leaf encode: a list of fp32 leaves → one codes buffer ``(Σnb, 256)``,
one scales buffer ``(Σnb,)`` and the block prefix ``firsts`` (leaf ``i``'s
blocks are rows ``firsts[i]:firsts[i + 1]``), each leaf's rows equal to its
one-leaf encode. The kernel encodes them all in one launch.

Callers go through ``kernels.ops.shard_encode_many``/``shard_decode``,
which count launches and pick the plain version only for CPU tensors.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

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


def block_firsts(numels: Sequence[int]) -> List[int]:
    """Prefix of the leaves' block counts: leaf ``i`` codes as rows
    ``firsts[i]:firsts[i + 1]`` of a many-leaf encode."""
    firsts = [0]
    for n in numels:
        firsts.append(firsts[-1] + -(-int(n) // Q_BLOCK))
    return firsts


def shard_encode_many_plain(leaves: Sequence[torch.Tensor]):
    """The many-leaf encode as ``shard_encode_plain`` leaf by leaf:
    ``(codes (Σnb, 256), scales (Σnb,), firsts)``."""
    parts = [shard_encode_plain(x) for x in leaves]
    device = leaves[0].device if leaves else torch.device("cpu")
    codes = (torch.cat([c for c, _ in parts]) if parts else
             torch.empty((0, Q_BLOCK), dtype=torch.int8, device=device))
    scales = (torch.cat([s for _, s in parts]) if parts else
              torch.empty((0,), dtype=torch.float32, device=device))
    return codes, scales, block_firsts(x.numel() for x in leaves)


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


def shard_encode_many_kernel(leaves: Sequence[torch.Tensor]):
    """CUDA encode of float32 tensors of any shapes (each read flat) on one
    device, in one launch: ``(codes (Σnb, 256), scales (Σnb,), firsts)`` as
    ``shard_encode_many_plain``. The launch reads a device table of (data
    pointer, numel, first block) per non-empty leaf, copied from pinned host
    memory without a synchronisation."""
    if not leaves:
        raise ValueError("shard_encode_many: no leaves")
    for x in leaves:
        _require_cuda(x, torch.float32, "shard_encode_many")
    device = leaves[0].device
    if any(x.device != device for x in leaves):
        raise ValueError("shard_encode_many: leaves on more than one device")
    flats = [x.contiguous().reshape(-1) for x in leaves]
    firsts = block_firsts(xf.numel() for xf in flats)
    nb = firsts[-1]
    codes = torch.empty((nb, Q_BLOCK), dtype=torch.int8, device=device)
    scales = torch.empty((nb,), dtype=torch.float32, device=device)
    rows = [(xf.data_ptr(), xf.numel(), first)
            for xf, first in zip(flats, firsts) if xf.numel()]
    if rows:
        table = torch.tensor(rows, dtype=torch.int64).pin_memory().to(
            device, non_blocking=True)
        lib = build.load()
        build.check(lib.repro_shard_encode_many(
            table.data_ptr(), len(rows), nb, codes.data_ptr(),
            scales.data_ptr(), build.stream_of(leaves[0])), "shard_encode_many")
    return codes, scales, firsts


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
