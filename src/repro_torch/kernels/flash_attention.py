"""Flash attention forward: the CUDA kernel and its plain version.

Port of ``repro/kernels/flash_attention.py``. The kernel
(``csrc/flash_attention.cu``) keeps the Pallas kernel's contract: FA2 online
softmax with fp32 running max, denominator and accumulator; q scaled before
``QKᵀ``; optional ``softcap * tanh(s / softcap)``; causal, full or prefix
masks with a sliding ``window`` and ``q_offset``; GQA maps query head ``h``
to kv head ``h // (H // K)``. Ragged sequence lengths are masked inside the
kernel instead of asserted away. bf16 inputs run on the tensor cores
(``wgmma``, K/V tiles through a ``cp.async`` ring); fp32 inputs on the CUDA
cores, to hold the fp32 tolerance. bf16 calls with ``Sq·(H/K) <= 64`` (every
serving decode step) take the decode regime instead: one CTA per (batch, kv
head) holds the whole GQA group's rows, the admitted keys are cut into
``n_split`` runs of whole 64-key tiles (``decode_split_plan``), and a second
kernel merges the runs' fp32 partials in split order (``regime`` names the
kernel a call takes).

``attention_plain`` mirrors ``repro/kernels/ref.attention_ref``: dense
softmax attention in fp32. It is the CPU path, the oracle on the card, and
— under autograd — the backward of ``kernels.ops.flash_attention``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KINDS = {"causal": 0, "full": 1, "prefix": 2}
HEAD_DIMS = (16, 32, 64, 112, 128, 256)
NEG_INF = -2.0e38

#: The decode regime (``csrc/flash_attention.cuh``): at most ``DECODE_ROWS``
#: query rows (Sq·G) a CTA, keys in tiles of ``DECODE_KEYS``, at most
#: ``MAX_SPLITS`` runs of tiles per (batch, kv head). The plan splits until
#: about one CTA stands on each of the H100's ``SMS`` SMs (runs of at least
#: ``MIN_SPLIT_TILES`` tiles), further only while each run keeps
#: ``LONG_RUN_TILES`` tiles, and never past ``CTAS_PER_SM`` CTAs an SM.
#: ``tools/decode_splits.py`` timed every split count at the serving decode
#: shapes: a second CTA on an SM paid only where the runs stayed long
#: (gemma2's 65-73 tiles), and cost time where they fell to four or five
#: tiles (Arctic's and Kimi's 18).
DECODE_ROWS = 64
DECODE_KEYS = 64
MAX_SPLITS = 64
SMS = 132
CTAS_PER_SM = 2
MIN_SPLIT_TILES = 2
LONG_RUN_TILES = 8


def regime(dtype, Sq, H, K) -> str:
    """The kernel a call of ``flash_attention_kernel`` takes: ``"decode"``
    (bf16 with Sq·(H/K) <= 64), ``"wgmma"`` (other bf16) or ``"fma"``
    (fp32)."""
    if dtype != torch.bfloat16:
        return "fma"
    return "decode" if Sq * (H // K) <= DECODE_ROWS else "wgmma"


def admitted_keys(kind, window, prefix_len, Sq, Skv, q_offset=0):
    """The keys ``[lo, hi)`` that the mask can admit for queries at
    ``q_offset .. q_offset + Sq - 1``: the kernel's ``kv_range`` for one
    block of all Sq rows (``csrc/flash_attention.cuh``)."""
    if kind == "full":
        return 0, Skv
    pre = kind == "prefix" and prefix_len > 0
    hi = q_offset + Sq
    if pre and q_offset < prefix_len:
        hi = max(hi, prefix_len)
    hi = min(max(hi, 0), Skv)
    lo = max(0, q_offset - window + 1) if window > 0 and not pre else 0
    return lo, hi


class DecodePlan(NamedTuple):
    """The decode regime's cut of the admitted keys ``[lo, hi)``: tiles
    ``t_begin .. t_begin + n_tiles - 1`` of ``DECODE_KEYS`` keys, split ``j``
    of ``n_split`` taking tiles ``t_begin + j·n_tiles // n_split`` up to the
    next split's first, as the kernel cuts them."""
    lo: int
    hi: int
    t_begin: int
    n_tiles: int
    n_split: int

    def tiles(self, j):
        n, t = self.n_split, self.n_tiles
        return self.t_begin + j * t // n, self.t_begin + (j + 1) * t // n


def decode_split_plan(B, Sq, Skv, K, kind="causal", window=0, prefix_len=0,
                      q_offset=0, n_split=None) -> DecodePlan:
    """The split of the admitted keys for a decode-regime call on ``B·K``
    (batch, kv head) groups: ``n_split`` runs of whole tiles, enough for
    ``B·K·n_split`` to reach ``SMS`` CTAs with runs of ``MIN_SPLIT_TILES``
    tiles or more, or more runs while each keeps ``LONG_RUN_TILES`` tiles;
    never past ``CTAS_PER_SM`` CTAs an SM or ``MAX_SPLITS``, at least 1.
    ``n_split`` given pins it (the kernel's entry refuses a count past the
    tiles or ``MAX_SPLITS``)."""
    lo, hi = admitted_keys(kind, window, prefix_len, Sq, Skv, q_offset)
    t_begin = lo // DECODE_KEYS
    n_tiles = max(-(-hi // DECODE_KEYS) - t_begin, 0)
    if n_split is None:
        fill = min(SMS // (B * K), n_tiles // MIN_SPLIT_TILES)
        n_split = max(1, min(MAX_SPLITS, SMS * CTAS_PER_SM // (B * K),
                             max(fill, n_tiles // LONG_RUN_TILES)))
    return DecodePlan(lo, hi, t_begin, n_tiles, int(n_split))


def decode_workspace_floats(B, Sq, H, K, hd, n_split):
    """fp32 elements of the decode regime's partials: (m, l) and o for each
    of the B·K·n_split CTAs' Sq·G rows; none at ``n_split = 1``."""
    return 0 if n_split == 1 else B * K * n_split * Sq * (H // K) * (hd + 2)


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
                           prefix_len: int = 0, q_offset: int = 0,
                           n_split=None):
    """q: (B,Sq,H,hd); k,v: (B,Skv,K,hd) CUDA tensors of one dtype (float32
    or bfloat16) with H % K == 0. Returns (B,Sq,H,hd) in q's dtype.
    ``n_split`` (decode regime only) pins the split count instead of
    ``decode_split_plan``'s, as the card tests do."""
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
    splits, workspace = 1 if n_split is None else int(n_split), None
    if regime(q.dtype, Sq, H, K) == "decode":
        splits = decode_split_plan(B, Sq, Skv, K, kind, int(window), int(prefix_len),
                                   int(q_offset), n_split).n_split
        n_ws = decode_workspace_floats(B, Sq, H, K, hd, splits)
        if n_ws:
            workspace = torch.empty(n_ws, dtype=torch.float32, device=q.device)
    lib = build.load()
    build.check(lib.repro_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], B, Sq, Skv, H, K, hd, float(scale), float(softcap),
        _KINDS[kind], int(window), int(prefix_len), int(q_offset), splits,
        None if workspace is None else workspace.data_ptr(),
        build.stream_of(q)), "flash_attention")
    return out
