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

A call that wants a gradient (``writing_lse``) also writes each query row's
log-sum-exp of its scaled (and softcapped) scores, fp32 (B, H, Sq), and takes
the wgmma kernel whatever its shape: the decode regime writes none, and no
training call is that small. The backward kernels
(``csrc/attention_bwd.cuh``, ``flash_attention_bwd_kernel``) read it with
the output to give dq, dk and dv of bf16 calls at the head dims of
``BWD_HEAD_DIMS`` (``backward_regime``).

``attention_plain`` mirrors ``repro/kernels/ref.attention_ref``: dense
softmax attention in fp32. It is the CPU path and the oracle on the card,
and — under autograd — the backward of ``kernels.ops.flash_attention`` for
CPU tensors, fp32 card calls and head dim 256.
"""
from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KINDS = {"causal": 0, "full": 1, "prefix": 2}
HEAD_DIMS = (16, 32, 64, 112, 128, 256)
#: Head dims the backward kernels take: at 256, dK's and dV's accumulators
#: alone would need 256 fp32 registers a thread, past the 255 there are.
BWD_HEAD_DIMS = (16, 32, 64, 112, 128)
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


def backward_regime(dtype, hd) -> str:
    """The backward a card call of ``kernels.ops.flash_attention`` takes:
    ``"wgmma"`` (the backward kernels) for bf16 at a head dim of
    ``BWD_HEAD_DIMS``, else ``"plain"`` (autograd of ``attention_plain``:
    fp32 calls, held to the fp32 tolerance, and head dim 256). CPU calls
    always take the plain backward."""
    return "wgmma" if dtype == torch.bfloat16 and hd in BWD_HEAD_DIMS else "plain"


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


def admitted_queries(kind, window, prefix_len, Sq, Skv, q_offset=0, k_start=0,
                     rows=None):
    """The query rows ``[lo, hi)`` (indices into Sq, at positions
    ``q_offset + i``) that the mask can admit for keys ``k_start ..
    k_start + rows - 1`` (all Skv keys when ``rows`` is None): the backward's
    ``q_range`` (``csrc/attention_bwd.cuh``), ``admitted_keys`` turned
    around."""
    rows = Skv - k_start if rows is None else rows
    if kind == "full":
        return 0, Sq
    k_last = min(k_start + rows, Skv) - 1
    in_prefix = kind == "prefix" and 0 < prefix_len and k_start < prefix_len
    lo = 0 if in_prefix else k_start - q_offset
    hi = k_last + window - q_offset if window > 0 and not in_prefix else Sq
    lo = min(max(lo, 0), Sq)
    return lo, min(max(hi, lo), Sq)


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


#: ``out``: the fp32 (B, H, Sq) tensor that ``flash_attention_kernel`` writes
#: each query row's log-sum-exp into while ``writing_lse`` holds it on the
#: calling thread. Not a keyword of the function, nor a private function
#: beside it: the benchmark's ``attention_roofline`` wraps
#: ``flash_attention_kernel`` and reads each call through a signature with
#: only today's keywords, so a new keyword would raise there and a call that
#: bypassed the function would go unread. It becomes a keyword once that
#: reader accepts any keyword.
_lse = threading.local()


def lse_target() -> Optional[torch.Tensor]:
    """The tensor ``writing_lse`` holds on this thread, else None."""
    return getattr(_lse, "out", None)


@contextlib.contextmanager
def writing_lse(lse: torch.Tensor):
    """Inside the block, ``flash_attention_kernel`` (bf16 only) also writes
    each query row's log-sum-exp of its scaled (and softcapped) scores into
    ``lse``, fp32 (B, H, Sq), for the backward kernels; +inf for a row whose
    keys the mask all removes. Calls on other threads write none."""
    outer = lse_target()
    _lse.out = lse
    try:
        yield lse
    finally:
        _lse.out = outer


def _card_operands(*ts):
    """The tensors as the kernels read them: contiguous and 16-byte aligned
    (16-byte vector loads), copied where they are not."""
    return [t if t.data_ptr() % 16 == 0 and t.is_contiguous()
            else t.clone(memory_format=torch.contiguous_format) for t in ts]


def _check_operands(what, q, k, v, dtypes):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError(f"{what}: q, k and v must be CUDA tensors")
    if q.dtype not in dtypes or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{what}: unsupported dtypes "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    if k.shape != (B, Skv, K, hd) or v.shape != k.shape or K == 0 or H % K:
        raise ValueError(f"{what}: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")


def flash_attention_kernel(q, k, v, *, scale: float, softcap: float = 0.0,
                           kind: str = "causal", window: int = 0,
                           prefix_len: int = 0, q_offset: int = 0,
                           n_split=None):
    """q: (B,Sq,H,hd); k,v: (B,Skv,K,hd) CUDA tensors of one dtype (float32
    or bfloat16) with H % K == 0. Returns (B,Sq,H,hd) in q's dtype.
    ``n_split`` (decode regime only) pins the split count instead of
    ``decode_split_plan``'s, as the card tests do. Inside ``writing_lse``
    it also writes the rows' log-sum-exp (bf16 only, the wgmma kernel)."""
    _check_operands("flash_attention", q, k, v, _DTYPES)
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    if kind not in _KINDS:
        raise ValueError(f"flash_attention: unknown mask kind {kind!r}")
    lse = lse_target()
    if lse is not None and (q.dtype != torch.bfloat16 or n_split is not None
                            or lse.shape != (B, H, Sq) or lse.dtype != torch.float32
                            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError("flash_attention: the log-sum-exp is written by bf16 calls "
                         "without n_split, into a contiguous fp32 (B, H, Sq) tensor "
                         "on q's device")
    q, k, v = _card_operands(q, k, v)
    out = torch.empty_like(q)
    splits, workspace = 1 if n_split is None else int(n_split), None
    if lse is None and regime(q.dtype, Sq, H, K) == "decode":
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
        None if lse is None else lse.data_ptr(),
        build.stream_of(q)), "flash_attention")
    return out


def flash_attention_bwd_kernel(q, k, v, o, lse, do, *, scale: float,
                               softcap: float = 0.0, kind: str = "causal",
                               window: int = 0, prefix_len: int = 0,
                               q_offset: int = 0):
    """dq, dk and dv of ``flash_attention_kernel``'s bf16 output ``o`` against
    its gradient ``do``, from ``lse`` (written by the forward inside
    ``writing_lse``): the backward kernels (``csrc/attention_bwd.cuh``),
    three launches and no atomics. bf16 CUDA tensors at a head dim of
    ``BWD_HEAD_DIMS``; the gradients in q's, k's and v's shapes, bf16."""
    _check_operands("flash_attention_bwd", q, k, v, (torch.bfloat16,))
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    if hd not in BWD_HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head_dim {hd} not in {BWD_HEAD_DIMS}")
    if kind not in _KINDS:
        raise ValueError(f"flash_attention_bwd: unknown mask kind {kind!r}")
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} {o.dtype}, "
                         f"do {tuple(do.shape)} against q {tuple(q.shape)}")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32 or not lse.is_cuda:
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} {lse.dtype}")
    q, k, v, o, do = _card_operands(q, k, v, o, do.to(q.dtype))
    lse = lse.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib = build.load()
    build.check(lib.repro_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
        B, Sq, Skv, H, K, hd, float(scale), float(softcap), _KINDS[kind],
        int(window), int(prefix_len), int(q_offset), build.stream_of(q)),
        "flash_attention_bwd")
    return dq, dk, dv
