"""SSD (the Mamba2 state-space scan): the CUDA kernel and its plain version.

Port of ``repro/kernels/ssd.py``. Per (batch, head h), head channel p and
state channel n, with ``a_t = exp(-exp(A_log[h]) · dt_t)``:

    h_t[p, n] = a_t · h_{t-1}[p, n] + dt_t · x_t[p] · B_t[n]
    y_t[p]    = Σ_n C_t[n] · h_t[p, n]

The output reads the state *after* step t's update (the opposite of WKV6).
``Bm`` and ``Cm`` are (B, S, N), shared by every head.

The kernel (``csrc/ssd.cu``) reads ``B``/``C`` at (b, t) — the per-head
broadcast that the JAX wrapper materialises is never built — and takes any
S. For bf16 x/B/C it computes the Pallas kernel's chunked form on tensor
cores (one CTA per (b, h), chunk 64, the fp32 state in registers, bf16
products with fp32 sums, the operands it computes split as bf16 hi + lo);
for fp32 it walks the sequence one step at a time on the CUDA cores.
``chunk`` is accepted and ignored: the bf16 kernel's chunk of 64 is its own
tile. Calls of at most ``DECODE_MAX_STEPS`` steps (a serving decode step
from the carried state) take the decode regime instead (``csrc/
ssd_decode.cu``, either dtype): the fp32 state streamed once through
registers, no shared memory, and x, B and C read through their row strides,
so the views that ``models/mamba2.block_apply`` splits from one tensor
need no copy (``regime`` names the kernel a call takes).

``ssd_plain`` is ``repro/models/mamba2.ssd_chunked``: the chunked form with
every exponent a non-positive log-decay difference, one
``torch.utils.checkpoint`` per chunk step, fp32 arithmetic. It is the CPU
path, the oracle on the card and — under autograd — the backward of
``kernels.ops.ssd``. A sequence that the chunk does not divide is padded
with steps that leave the state unchanged (x = 0, dt = 0) and the pad's
outputs are dropped. ``ssd_ref`` mirrors ``repro/kernels/ref.ssd_ref`` (the
sequential oracle) and serves the tests only.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64)  # P
STATE_DIMS = (8, 16, 64)  # N
#: Calls of at most this many steps take the decode regime: timed in turns
#: at Zamba2's decode shape, it was faster than the chunked kernel (bf16) up
#: to 16 steps and slower from 32, faster than the sequential one (fp32) up
#: to 64 (chip_smoke.py's step sweep, PERF.md §6).
DECODE_MAX_STEPS = 16


def regime(dtype, S) -> str:
    """The kernel a call of ``ssd_kernel`` takes: ``"decode"`` (S <=
    ``DECODE_MAX_STEPS``), else ``"chunked"`` (bf16) or ``"sequential"``
    (fp32)."""
    if S <= DECODE_MAX_STEPS:
        return "decode"
    return "chunked" if dtype == torch.bfloat16 else "sequential"


# ---------------------------------------------------------------------------
# Plain PyTorch versions.
# ---------------------------------------------------------------------------


def _chunk_step(h_in, xb, dtb, lb, Bb, Cb, tri):
    """One chunk of ``ssd_chunked``'s scan. xb (B,C,H,P); dtb, lb (B,C,H);
    Bb, Cb (B,C,N); h_in (B,H,P,N)."""
    Lc = torch.cumsum(lb, dim=1)  # (B,C,H) inclusive
    # Intra: M[t,j,h] = exp(Lc[t,h]-Lc[j,h]) * (C_t·B_j) * dt_j, j ≤ t.
    cb = Cb @ Bb.transpose(1, 2)  # (B,t,j)
    decay = torch.exp(torch.clamp(Lc[:, :, None, :] - Lc[:, None, :, :],
                                  max=0.0))
    M = cb[..., None] * decay * dtb[:, None, :, :]  # (B,t,j,H)
    M = torch.where(tri[None, :, :, None], M, 0.0)
    y = torch.einsum("btjh,bjhp->bthp", M, xb)
    # Inter: y += exp(Lc_t) · C_t · h_in.
    y = y + torch.einsum("btn,bhpn->bthp", Cb, h_in) * torch.exp(Lc)[..., None]
    # State: h' = exp(L_last) h + Σ_j exp(L_last - L_j) dt_j B_j x_j.
    Llast = Lc[:, -1:, :]  # (B,1,H)
    w = torch.exp(Llast - Lc) * dtb  # (B,C,H)
    h_out = (torch.exp(Llast[:, 0, :])[:, :, None, None] * h_in
             + torch.einsum("bjhp,bjn->bhpn", xb * w[..., None], Bb))
    return h_out, y


def ssd_plain(x, dt, A_log, Bm, Cm, state=None, chunk: int = 32):
    """x: (B,S,H,P); dt: (B,S,H) > 0; A_log: (H,); Bm, Cm: (B,S,N);
    state: (B,H,P,N) or None.

    Returns (y (B,S,H,P) fp32, final_state (B,H,P,N) fp32)."""
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    f32 = torch.float32
    x, dt, Bm, Cm = (t.to(f32) for t in (x, dt, Bm, Cm))
    C = max(1, min(chunk, S))
    pad = (-S) % C
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt, Bm, Cm = (F.pad(t, (0, 0, 0, pad)) for t in (dt, Bm, Cm))
    NC = (S + pad) // C
    lA = -torch.exp(A_log.to(f32))  # (H,) < 0
    l = dt * lA[None, None, :]  # (B,S,H) log-decay ≤ 0

    xc = x.reshape(Bb, NC, C, H, P).transpose(0, 1)
    dtc = dt.reshape(Bb, NC, C, H).transpose(0, 1)
    lc = l.reshape(Bb, NC, C, H).transpose(0, 1)
    Bc = Bm.reshape(Bb, NC, C, N).transpose(0, 1)
    Cc = Cm.reshape(Bb, NC, C, N).transpose(0, 1)
    h = (torch.zeros((Bb, H, P, N), dtype=f32, device=x.device)
         if state is None else state.to(f32))
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=x.device))
    ys = []
    for i in range(NC):
        h, y = checkpoint(_chunk_step, h, xc[i], dtc[i], lc[i], Bc[i], Cc[i],
                          tri, use_reentrant=False)
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(Bb, NC * C, H, P)
    return y[:, :S], h


def ssd_ref(x, dt, A_log, Bm, Cm, state=None):
    """Sequential oracle (``kernels/ref.ssd_ref``); tests only."""
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    f32 = torch.float32
    x, dt, Bm, Cm = (t.to(f32) for t in (x, dt, Bm, Cm))
    lA = -torch.exp(A_log.to(f32))
    h = (torch.zeros((Bb, H, P, N), dtype=f32, device=x.device)
         if state is None else state.to(f32))
    ys = []
    for t in range(S):
        a = torch.exp(dt[:, t] * lA[None, :])  # (B,H)
        inject = (dt[:, t, :, None, None] * x[:, t, :, :, None]
                  * Bm[:, t, None, None, :])
        h = a[..., None, None] * h + inject
        ys.append(torch.einsum("bn,bhpn->bhp", Cm[:, t], h))
    return torch.stack(ys, dim=1), h


# ---------------------------------------------------------------------------
# CUDA kernel.
# ---------------------------------------------------------------------------


def row_stride(t):
    """Elements between consecutive (b, t) rows of ``t`` (B, S, ...) whose
    trailing dims are contiguous, as the decode regime reads x, B and C; or
    None where the rows have no one stride, overlap, or the pointer or the
    stride in bytes is not a multiple of 16 (the kernel's vector loads)."""
    B, S = t.shape[:2]
    inner = 1
    for size, stride in reversed(list(zip(t.shape[2:], t.stride()[2:]))):
        if size != 1 and stride != inner:
            return None
        inner *= size
    sb, ss = t.stride()[:2]
    if S > 1:
        rs = ss
        if B > 1 and sb != S * ss:
            return None
    else:
        rs = sb if B > 1 else inner
    if rs < inner or t.data_ptr() % 16 or rs * t.element_size() % 16:
        return None
    return rs


def ssd_kernel(x, dt, A_log, Bm, Cm, state=None, *, chunk: int = 64):
    """x: (B,S,H,P), Bm/Cm: (B,S,N) CUDA tensors of one dtype (float32 or
    bfloat16); dt: (B,S,H) and A_log: (H,), read as fp32; state: (B,H,P,N)
    or None. Returns (y (B,S,H,P) fp32, final_state (B,H,P,N) fp32). The
    shape picks the kernel (``regime``); a failed build or launch raises."""
    del chunk  # the bf16 kernel's chunk is its own tile of 64
    if not all(t.is_cuda for t in (x, dt, A_log, Bm, Cm)):
        raise ValueError("ssd: x, dt, A_log, Bm and Cm must be CUDA tensors")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"ssd: unsupported dtypes {x.dtype}/{Bm.dtype}/{Cm.dtype}")
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if (dt.shape != (B, S, H) or A_log.shape != (H,) or Bm.shape != (B, S, N)
            or Cm.shape != Bm.shape):
        raise ValueError(f"ssd: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A_log {tuple(A_log.shape)}, Bm {tuple(Bm.shape)}, "
                         f"Cm {tuple(Cm.shape)}")
    if P not in HEAD_DIMS or N not in STATE_DIMS:
        raise ValueError(f"ssd: head dim {P} not in {HEAD_DIMS} or state dim "
                         f"{N} not in {STATE_DIMS}")
    if state is not None and (not state.is_cuda or state.shape != (B, H, P, N)):
        raise ValueError(f"ssd: state {tuple(state.shape)} on {state.device}")
    return ssd_launch(regime(x.dtype, S), x, dt, A_log, Bm, Cm, state)


def _copy(t):
    return t.clone(memory_format=torch.contiguous_format)


def ssd_launch(kind, x, dt, A_log, Bm, Cm, state=None):
    """One launch of the regime ``kind`` (``regime``'s names; "chunked" and
    "sequential" are one C entry, ``repro_ssd_fwd``, which picks by dtype)
    on inputs ``ssd_kernel`` has checked. ``ssd_kernel`` passes its regime;
    a timing or a test may name another at any S."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    dt = dt.to(torch.float32).contiguous()
    A_log = A_log.to(torch.float32).contiguous()
    h0 = None if state is None else state.to(torch.float32).contiguous()
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=x.device)
    hf = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    if not B * H:
        return y, hf
    lib = build.load()
    h0_ptr = None if h0 is None else h0.data_ptr()
    stream = build.stream_of(x)
    if kind == "decode":
        # x, B and C go by their row strides; an operand whose pointer or
        # stride is off 16 bytes (no view the models make) is copied.
        xs = row_stride(x)
        if xs is None:
            x, xs = _copy(x), H * P
        bs, cs = row_stride(Bm), row_stride(Cm)
        if bs is None or bs != cs:
            Bm, Cm, bs = _copy(Bm), _copy(Cm), N
        build.check(lib.repro_ssd_decode(
            x.data_ptr(), dt.data_ptr(), A_log.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), h0_ptr, y.data_ptr(), hf.data_ptr(),
            _DTYPES[x.dtype], B, S, H, P, N, xs, bs, stream), "ssd decode")
        return y, hf
    # The chunked kernel copies 16-byte pieces: contiguous and 16-byte
    # aligned.
    x, Bm, Cm = (t if t.data_ptr() % 16 == 0 and t.is_contiguous() else _copy(t)
                 for t in (x, Bm, Cm))
    build.check(lib.repro_ssd_fwd(
        x.data_ptr(), dt.data_ptr(), A_log.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), h0_ptr, y.data_ptr(), hf.data_ptr(), _DTYPES[x.dtype],
        B, S, H, P, N, stream), "ssd")
    return y, hf
