"""Flash attention forward: the CUDA kernel and its plain version.

Port of ``repro/kernels/flash_attention.py``. The kernel
(``csrc/flash_attention.cu``) keeps the Pallas kernel's contract: FA2 online
softmax with fp32 running max, denominator and accumulator; q scaled before
``QKᵀ``; optional ``softcap * tanh(s / softcap)``; causal, full or prefix
masks with a sliding ``window`` and ``q_offset``; GQA maps query head ``h``
to kv head ``h // (H // K)``. Ragged sequence lengths are masked inside the
kernel instead of asserted away. bf16 inputs run on the tensor cores
(``wgmma``, K/V tiles through a ``cp.async`` ring); fp32 inputs on the CUDA
cores, to hold the fp32 tolerance.

``attention_plain`` mirrors ``repro/kernels/ref.attention_ref``: dense
softmax attention in fp32. It is the CPU path, the oracle on the card, and
— under autograd — the backward of ``kernels.ops.flash_attention``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KINDS = {"causal": 0, "full": 1, "prefix": 2}
HEAD_DIMS = (16, 32, 64, 128)
NEG_INF = -2.0e38


def attention_plain(q, k, v, spec, *, scale, softcap=0.0, q_offset=0,
                    is_local=None):
    """q: (B,Sq,H,hd); k,v: (B,Skv,K,hd). Dense softmax attention in fp32."""
    from repro_torch.models.layers import _mask_block

    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    qr = (q.to(torch.float32) * scale).reshape(B, Sq, K, G, hd)
    s = torch.einsum("bqkgd,bjkd->bkgqj", qr, k.to(torch.float32))
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    q_pos = q_offset + torch.arange(Sq, dtype=torch.int32, device=q.device)
    kv_pos = torch.arange(Skv, dtype=torch.int32, device=q.device)
    m = _mask_block(spec, q_pos, kv_pos, is_local=is_local)
    s = s.masked_fill(~m, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqj,bjkd->bqkgd", p, v.to(torch.float32))
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def flash_attention_kernel(q, k, v, *, scale: float, softcap: float = 0.0,
                           kind: str = "causal", window: int = 0,
                           prefix_len: int = 0, q_offset: int = 0):
    """q: (B,Sq,H,hd); k,v: (B,Skv,K,hd) CUDA tensors of one dtype (float32
    or bfloat16) with H % K == 0. Returns (B,Sq,H,hd) in q's dtype."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention: q, k and v must be CUDA tensors")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: unsupported dtypes "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    if k.shape != (B, Skv, K, hd) or v.shape != k.shape or K == 0 or H % K:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    if kind not in _KINDS:
        raise ValueError(f"flash_attention: unknown mask kind {kind!r}")
    # The kernel reads 16-byte vectors: contiguous and 16-byte aligned.
    q, k, v = (t.contiguous() if t.data_ptr() % 16 == 0 and t.is_contiguous()
               else t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    out = torch.empty_like(q)
    lib = build.load()
    build.check(lib.repro_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], B, Sq, Skv, H, K, hd, float(scale), float(softcap),
        _KINDS[kind], int(window), int(prefix_len), int(q_offset),
        build.stream_of(q)), "flash_attention")
    return out
