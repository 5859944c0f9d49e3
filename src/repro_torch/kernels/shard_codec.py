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

Many-leaf decode: per leaf int8 codes ``(nb, 256)``, fp32 scales ``(nb,)``
and a ``numel`` → one flat fp32 tensor of ``numel`` values per leaf, each
equal to its one-leaf decode. The leaves need not share buffers; the kernel
decodes them all in one launch.

Callers go through ``kernels.ops.shard_encode_many``/``shard_decode_many``
(and ``shard_decode`` for one leaf), which count launches and pick the
plain version only for CPU tensors.
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


def shard_decode_many_plain(codes_list: Sequence[torch.Tensor],
                            scales_list: Sequence[torch.Tensor],
                            numels: Sequence[int]) -> List[torch.Tensor]:
    """The many-leaf decode as ``shard_decode_plain`` leaf by leaf."""
    return [shard_decode_plain(c, s, int(n))
            for c, s, n in zip(codes_list, scales_list, numels, strict=True)]


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


def _check_decode_shapes(codes: torch.Tensor, scales: torch.Tensor,
                         numel: Optional[int], what: str) -> int:
    """The number of values to decode: ``numel``, or all ``nb * 256``."""
    shape, sshape = codes.shape, scales.shape
    nb = shape[0] if len(shape) == 2 and shape[1] == Q_BLOCK else -1
    if nb < 0 or len(sshape) != 1 or sshape[0] != nb:
        raise ValueError(f"{what}: codes {tuple(shape)} and "
                         f"scales {tuple(sshape)} do not match")
    full = nb * Q_BLOCK
    n = full if numel is None else int(numel)
    if not 0 <= n <= full:
        raise ValueError(f"{what}: numel {n} exceeds {full}")
    return n


def shard_decode_kernel(codes: torch.Tensor, scales: torch.Tensor,
                        numel: Optional[int] = None) -> torch.Tensor:
    """CUDA decode. Returns ``(nb, 256)`` fp32, or the first ``numel`` values
    flat when ``numel`` is given."""
    _require_cuda(codes, torch.int8, "shard_decode codes")
    _require_cuda(scales, torch.float32, "shard_decode scales")
    n = _check_decode_shapes(codes, scales, numel, "shard_decode")
    nb = codes.shape[0]
    codes, scales = codes.contiguous(), scales.contiguous()
    out = torch.empty((n,), dtype=torch.float32, device=codes.device)
    if n:
        lib = build.load()
        build.check(lib.repro_shard_decode(codes.data_ptr(), scales.data_ptr(),
                                           n, out.data_ptr(),
                                           build.stream_of(codes)),
                    "shard_decode")
    return out.reshape(nb, Q_BLOCK) if numel is None else out


#: Each leaf's output in a many-leaf decode starts on a multiple of this many
#: elements (256 bytes), so that the kernel's 16-byte stores stay aligned.
OUT_ALIGN = 64


def shard_decode_many_kernel(codes_list: Sequence[torch.Tensor],
                             scales_list: Sequence[torch.Tensor],
                             numels: Sequence[int]) -> List[torch.Tensor]:
    """CUDA decode of many leaves on one device in one launch: leaf ``i``'s
    first ``numels[i]`` values of ``codes_list[i] * scales_list[i][:, None]``
    as one flat fp32 tensor each, as ``shard_decode_many_plain``. The
    outputs are views of one buffer, each starting on a 256-byte boundary.
    The launch reads a device table of (codes pointer, scales pointer,
    output pointer, numel, first block) per non-empty leaf, copied from
    pinned host memory without a synchronisation."""
    if not codes_list:
        raise ValueError("shard_decode_many: no leaves")
    if not len(codes_list) == len(scales_list) == len(numels):
        raise ValueError(f"shard_decode_many: {len(codes_list)} codes, "
                         f"{len(scales_list)} scales, {len(numels)} numels")
    ns = [_check_decode_shapes(c, s, n, f"shard_decode_many leaf {i}")
          for i, (c, s, n) in enumerate(zip(codes_list, scales_list, numels))]
    device = codes_list[0].device
    for c, s in zip(codes_list, scales_list):
        _require_cuda(c, torch.int8, "shard_decode_many codes")
        _require_cuda(s, torch.float32, "shard_decode_many scales")
        if c.device != device or s.device != device:
            raise ValueError("shard_decode_many: leaves on more than one device")
    starts = [0]
    for n in ns:
        starts.append(starts[-1] + -(-n // OUT_ALIGN) * OUT_ALIGN)
    out = torch.empty((starts[-1],), dtype=torch.float32, device=device)
    firsts = block_firsts(ns)
    live = [(c.contiguous(), s.contiguous()) for c, s in zip(codes_list, scales_list)]
    base = out.data_ptr()
    rows = [(c.data_ptr(), s.data_ptr(), base + 4 * start, n, first)
            for (c, s), n, start, first in zip(live, ns, starts, firsts) if n]
    if rows:
        table = torch.tensor(rows, dtype=torch.int64).pin_memory().to(
            device, non_blocking=True)
        lib = build.load()
        build.check(lib.repro_shard_decode_many(
            table.data_ptr(), len(rows), firsts[-1],
            build.stream_of(codes_list[0])), "shard_decode_many")
    return [out[start:start + n] for start, n in zip(starts, ns)]
