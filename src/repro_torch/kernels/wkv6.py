"""WKV6 (the RWKV-6 recurrence): the CUDA kernel and its plain version.

Port of ``repro/kernels/wkv6.py``. Per (batch, head), with the state's axes
[key channel c, value channel d]:

    o_t = r_t · (diag(u) k_t v_tᵀ + S_{t-1})
    S_t = diag(exp lw_t) S_{t-1} + k_t v_tᵀ

The output reads the state *before* step t's update, plus the ``u`` bonus.

The kernel (``csrc/wkv6.cu``) walks the sequence one step at a time, as the
official RWKV-6 CUDA kernel does, with the per-step latency taken out: one
CTA per (b, h), each thread holding a tile of the state in registers (8 key
rows by 4 value columns at hd 64; partial outputs meet by warp shuffles);
the ``u`` bonus hoisted to one scalar per step; r, k, v and lw staged 32
steps at a time in shared memory by ``cp.async``, double buffered, with
``exp(lw)`` taken once per element there. It takes any S; ``chunk`` is
accepted and ignored, so the contract equals the Pallas kernel's. Calls of
at most ``DECODE_MAX_STEPS`` steps (a serving decode step from the carried
state) take the decode regime instead (``csrc/wkv6_decode.cu``): the state
streamed once through registers, no staged chunk, one barrier a step
(``regime`` names the kernel a call takes).

``wkv6_plain`` is ``repro/models/rwkv6.wkv6_chunked``: the numerically
stable chunked form (every exponent is a non-positive log-decay difference),
one ``torch.utils.checkpoint`` per chunk step, chunk inputs streamed in the
caller's dtype (bf16 stays bf16) with fp32 arithmetic. It is the CPU path,
the oracle on the card and — under autograd — the backward of
``kernels.ops.wkv6``. A sequence that the chunk does not divide is padded
with steps that leave the state unchanged (k = v = 0, lw = 0) and the pad's
outputs are dropped. ``wkv6_ref`` mirrors ``repro/kernels/ref.wkv6_ref``
(the sequential oracle) and serves the tests and checks only.

Accuracy: the chunked form takes each decay product as the difference of
two in-chunk cumulative log-decay sums, which loses fp32 digits as the sums
grow. With decays across the model's whole clip range (lw down to -20 per
step) and chunk 64, at S = 1024 it departs from an fp64 sequential oracle
by up to about 8e-4 where the sequential form stays near 2e-5, beyond
``_rec_tol``'s 1e-4; at the decays the RWKV-6 init gives (lw ≈ -0.55) both
stay far inside it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64)
#: Calls of at most this many steps take the decode regime: timed in turns
#: with the sequential kernel at RWKV-6's decode shape, it was faster up to 4
#: steps in both dtypes (fp32 up to 8) and slower from 16 (chip_smoke.py's
#: step sweep, PERF.md §6).
DECODE_MAX_STEPS = 4


def regime(dtype, S) -> str:
    """The kernel a call of ``wkv6_kernel`` takes: ``"decode"`` (S <=
    ``DECODE_MAX_STEPS``) or ``"sequential"``, for either dtype."""
    del dtype  # both regimes take fp32 and bf16 r/k/v
    return "decode" if S <= DECODE_MAX_STEPS else "sequential"


# ---------------------------------------------------------------------------
# Plain PyTorch versions.
# ---------------------------------------------------------------------------


def _chunk_step(S_in, rb, kb, vb, lwb, u, tri):
    """One chunk of ``wkv6_chunked``'s scan. rb/kb/vb/lwb: (B,H,C,hd)."""
    f32 = torch.float32
    rb, kb, vb = (x.to(f32) for x in (rb, kb, vb))
    Lc = torch.cumsum(lwb, dim=2)  # inclusive
    Lx = Lc - lwb  # exclusive
    # Intra-chunk: D[t,j,c] = exp(Lx[t,c] - Lc[j,c]), j<t (arg ≤ 0: stable).
    D = torch.exp(torch.clamp(Lx[:, :, :, None, :] - Lc[:, :, None, :, :],
                              max=0.0))
    A = torch.sum(rb[:, :, :, None, :] * kb[:, :, None, :, :] * D, dim=-1)
    A = torch.where(tri, A, 0.0)
    diag = torch.sum(rb * kb * u[None, :, None, :], dim=-1)  # (B,H,C)
    o = A @ vb + diag[..., None] * vb
    # Inter-chunk: o += (r ⊙ exp(Lx)) @ S_in.
    o = o + (rb * torch.exp(Lx)) @ S_in
    # State update: S' = exp(L_C) ⊙ S + Σ_j (k_j ⊙ exp(L_C − L_j)) v_jᵀ.
    Llast = Lc[:, :, -1:, :]  # (B,H,1,hd)
    S_out = (torch.exp(Llast[:, :, 0, :])[..., None] * S_in
             + (kb * torch.exp(Llast - Lc)).transpose(-1, -2) @ vb)
    return S_out, o


def wkv6_plain(r, k, v, lw, u, state=None, chunk: int = 32):
    """r,k,v,lw: (B, S, H, hd); lw = log-decay (≤ 0); u: (H, hd) bonus;
    state: (B, H, hd, hd) or None.

    Returns (out (B,S,H,hd) fp32, final_state (B,H,hd,hd) fp32)."""
    B, S, H, hd = r.shape
    f32 = torch.float32
    C = max(1, min(chunk, S))
    pad = (-S) % C
    if pad:
        r, k, v, lw = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (r, k, v, lw))
    NC = (S + pad) // C

    # Stream chunk inputs in the caller's dtype (bf16 stays bf16); the
    # log-decays stay fp32 (their cumsums feed exponents).
    stream_dt = r.dtype if r.dtype in (torch.bfloat16, torch.float16) else f32

    def to_chunks(x, dt):
        return x.to(dt).reshape(B, NC, C, H, hd).permute(1, 0, 3, 2, 4)

    rc, kc, vc = (to_chunks(x, stream_dt) for x in (r, k, v))
    lwc = to_chunks(lw, f32)
    u = u.to(f32)
    S_cur = (torch.zeros((B, H, hd, hd), dtype=f32, device=r.device)
             if state is None else state.to(f32))
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=r.device),
                     diagonal=-1)  # strict lower: j < t
    outs = []
    for i in range(NC):
        S_cur, o = checkpoint(_chunk_step, S_cur, rc[i], kc[i], vc[i], lwc[i],
                              u, tri, use_reentrant=False)
        outs.append(o)
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(B, NC * C, H, hd)
    return out[:, :S], S_cur


def wkv6_ref(r, k, v, lw, u, state=None):
    """Sequential oracle (``kernels/ref.wkv6_ref``), in fp32 — or in fp64
    when ``r`` is fp64; tests and checks only."""
    B, S, H, hd = r.shape
    ct = torch.promote_types(r.dtype, torch.float32)
    r, k, v, lw, u = (x.to(ct) for x in (r, k, v, lw, u))
    St = (torch.zeros((B, H, hd, hd), dtype=ct, device=r.device)
          if state is None else state.to(ct))
    outs = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]  # (B,H,hd,hd)
        outs.append(torch.einsum("bhc,bhcd->bhd", r[:, t],
                                 u[None, :, :, None] * kv + St))
        St = torch.exp(lw[:, t])[..., None] * St + kv
    return torch.stack(outs, dim=1), St


# ---------------------------------------------------------------------------
# CUDA kernel.
# ---------------------------------------------------------------------------


def _aligned(t):
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def wkv6_kernel(r, k, v, lw, u, state=None, *, chunk: int = 64):
    """r,k,v: (B,S,H,hd) CUDA tensors of one dtype (float32 or bfloat16);
    lw: (B,S,H,hd) and u: (H,hd), read as fp32; state: (B,H,hd,hd) or None.
    Returns (out (B,S,H,hd) fp32, final_state (B,H,hd,hd) fp32). The shape
    picks the kernel (``regime``); a failed build or launch raises."""
    del chunk  # the sequential kernel stages its own 32-step chunks
    if not all(t.is_cuda for t in (r, k, v, lw, u)):
        raise ValueError("wkv6: r, k, v, lw and u must be CUDA tensors")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"wkv6: unsupported dtypes {r.dtype}/{k.dtype}/{v.dtype}")
    B, S, H, hd = r.shape
    if (k.shape != r.shape or v.shape != r.shape or lw.shape != r.shape
            or u.shape != (H, hd)):
        raise ValueError(f"wkv6: shapes r {tuple(r.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, lw {tuple(lw.shape)}, "
                         f"u {tuple(u.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"wkv6: head_dim {hd} not in {HEAD_DIMS}")
    if state is not None and (not state.is_cuda or state.shape != (B, H, hd, hd)):
        raise ValueError(f"wkv6: state {tuple(state.shape)} on {state.device}")
    return wkv6_launch(regime(r.dtype, S), r, k, v, lw, u, state)


def wkv6_launch(kind, r, k, v, lw, u, state=None):
    """One launch of the regime ``kind`` (``regime``'s names) on inputs
    ``wkv6_kernel`` has checked. ``wkv6_kernel`` passes its regime; a timing
    or a test may name the other at any S."""
    B, S, H, hd = r.shape
    # Both kernels move 16 bytes at a time: copy a view that starts off a
    # 16-byte boundary.
    r, k, v, lw = (_aligned(t) for t in (r, k, v, lw.to(torch.float32)))
    u = u.to(torch.float32).contiguous()
    s0 = None if state is None else _aligned(state.to(torch.float32))
    out = torch.empty((B, S, H, hd), dtype=torch.float32, device=r.device)
    sf = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    if B * H:
        lib = build.load()
        entry = lib.repro_wkv6_decode if kind == "decode" else lib.repro_wkv6_fwd
        build.check(entry(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
            u.data_ptr(), None if s0 is None else s0.data_ptr(),
            out.data_ptr(), sf.data_ptr(), _DTYPES[r.dtype], B, S, H, hd,
            build.stream_of(r)), f"wkv6 {kind}")
    return out, sf
