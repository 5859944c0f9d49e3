"""The port's SSD (Mamba2 scan) against the JAX package's, on the CPU.

The port's plain chunked SSD (the CPU path of ``ops.ssd``) is held to the
Pallas ``ssd_kernel`` (interpret mode), to the XLA ``ssd_chunked`` and to
``kernels/ref.ssd_ref`` over the JAX kernel sweep, under the JAX tests'
``_rec_tol``; its gradients are held to ``jax.vjp`` of ``ops.ssd``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as R
from repro.kernels.ssd import ssd_kernel as jax_ssd_kernel
from repro.models.mamba2 import ssd_chunked
from repro_torch.kernels import ops
from repro_torch.kernels import ssd as SD

# The sweep of tests/test_kernels.py (SSD_SWEEP), with dtype names.
SSD_SWEEP = [
    # (B, S, H, P, N, chunk, dtype)
    (1, 64, 2, 16, 8, 16, "float32"),
    (2, 128, 4, 32, 16, 32, "float32"),
    (1, 128, 2, 64, 64, 64, "float32"),
    (2, 128, 2, 32, 16, 32, "bfloat16"),
]


def _rec_tol(dtype):
    """``_rec_tol`` of tests/test_kernels.py: the chunked and sequential
    forms sum in different orders; bf16 inputs round first."""
    return (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
            else dict(rtol=1e-3, atol=1e-4))


def _inputs(case, seed=7):
    B, S, H, P, N = case[:5]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = (np.logaddexp(rng.standard_normal((B, S, H)), 0.0) + 0.01).astype(np.float32)
    A_log = rng.uniform(-1.0, 1.5, (H,)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, S, N)).astype(np.float32) for _ in range(2))
    state = (rng.standard_normal((B, H, P, N)) * 0.1).astype(np.float32)
    return x, dt, A_log, Bm, Cm, state


def _torch(x, dtype="float32"):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _jax(x, dtype="float32"):
    return jnp.asarray(x).astype(getattr(jnp, dtype))


@pytest.mark.parametrize("case", SSD_SWEEP, ids=[str(i) for i in range(len(SSD_SWEEP))])
def test_plain_ssd_matches_pallas_kernel_chunked_and_ref(case):
    chunk, dtype = case[5], case[6]
    x, dt, A_log, Bm, Cm, st = _inputs(case)
    jx, jB, jC = (_jax(a, dtype) for a in (x, Bm, Cm))
    tx, tB, tC = (_torch(a, dtype) for a in (x, Bm, Cm))
    y, hf = SD.ssd_plain(tx, _torch(dt), _torch(A_log), tB, tC, _torch(st),
                         chunk=chunk)
    assert y.dtype == hf.dtype == torch.float32
    refs = [
        jax_ssd_kernel(jx, _jax(dt), _jax(A_log), jB, jC, state=_jax(st),
                       chunk=chunk),
        ssd_chunked(jx, _jax(dt), _jax(A_log), jB, jC, state=_jax(st),
                    chunk=chunk),
        R.ssd_ref(jx, _jax(dt), _jax(A_log), jB, jC, state=_jax(st)),
    ]
    for ry, rh in refs:
        np.testing.assert_allclose(y.numpy(), np.asarray(ry), **_rec_tol(dtype))
        np.testing.assert_allclose(hf.numpy(), np.asarray(rh), **_rec_tol(dtype))
    # The port's sequential oracle is the JAX oracle's twin.
    ry, rh = R.ssd_ref(jx, _jax(dt), _jax(A_log), jB, jC, state=_jax(st))
    py, ph = SD.ssd_ref(tx, _torch(dt), _torch(A_log), tB, tC, _torch(st))
    np.testing.assert_allclose(py.numpy(), np.asarray(ry), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ph.numpy(), np.asarray(rh), rtol=1e-5, atol=1e-5)


def test_plain_ssd_takes_a_sequence_the_chunk_does_not_divide():
    """50 steps in chunks of 32: the padded steps (dt = 0) leave the state
    as it is, so y and final state equal the sequential oracle's."""
    x, dt, A_log, Bm, Cm, st = _inputs(SSD_SWEEP[1])
    x, dt, Bm, Cm = (a[:, :50] for a in (x, dt, Bm, Cm))
    args = (x, dt, A_log, Bm, Cm, st)
    y, hf = SD.ssd_plain(*(_torch(a) for a in args), chunk=32)
    ry, rh = R.ssd_ref(*(_jax(a) for a in args[:5]), state=_jax(st))
    assert y.shape == (2, 50, 4, 32)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **_rec_tol("float32"))
    np.testing.assert_allclose(hf.numpy(), np.asarray(rh), **_rec_tol("float32"))


@pytest.mark.parametrize("with_state", [True, False])
def test_ssd_gradients_match_jax(with_state):
    """The CPU path's backward differentiates ``ssd_plain`` at
    ``min(chunk, 32)`` as ``_ssd_bwd`` differentiates ``ssd_chunked``: fp32
    on both sides, so 1e-4 covers the summation order."""
    case = (2, 64, 2, 16, 8, 64, "float32")
    x, dt, A_log, Bm, Cm, st = _inputs(case, seed=3)
    rng = np.random.default_rng(4)
    g_y = rng.standard_normal(x.shape).astype(np.float32)
    g_st = rng.standard_normal(st.shape).astype(np.float32)
    args = [x, dt, A_log, Bm, Cm] + ([st] if with_state else [])

    def f(*a):
        return jax_ops.ssd(*a[:5], state=a[5] if with_state else None)

    (jy, js), vjp = jax.vjp(f, *(_jax(a) for a in args))
    jgrads = vjp((_jax(g_y), _jax(g_st)))
    live = [_torch(a).requires_grad_(True) for a in args]
    ops.reset_launches()
    ty, ts = ops.ssd(*live[:5], state=live[5] if with_state else None)
    torch.autograd.backward([ty, ts], [_torch(g_y), _torch(g_st)])
    assert ops.launches["ssd"] == 0  # the CPU path runs no kernel
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ts.detach().numpy(), np.asarray(js), rtol=1e-4, atol=1e-4)
    assert len(jgrads) == len(live)
    for t, j in zip(live, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=1e-4, atol=1e-4)


def test_kernel_refuses_cpu_tensors():
    """The kernel's entry point takes CUDA tensors only; the CPU path goes
    through ``ops.ssd`` to the plain version."""
    x = torch.zeros((1, 8, 2, 16))
    bc = torch.zeros((1, 8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        SD.ssd_kernel(x, torch.ones((1, 8, 2)), torch.zeros(2), bc, bc)


# ---------------------------------------------------------------------------
# The bf16 CUDA kernel's arithmetic, emulated on the CPU.
# ---------------------------------------------------------------------------

KERNEL_CHUNK = 64  # the bf16 kernel's own chunk L (csrc/ssd.cu)


def _bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


def _bf16_pair(t):
    """``t`` as the sum of two bf16 values, hi + lo, as the kernel splits
    an operand over two products (about 2^-18 relative)."""
    hi = _bf16(t)
    return hi + _bf16(t - hi)


def _ssd_bf16_kernel_emulation(x, dt, A_log, Bm, Cm, state=None,
                               operand=_bf16_pair):
    """The chunked tensor-core form of ``csrc/ssd.cu``'s bf16 kernel, step
    for step: chunk 64, a ragged last chunk padded with zero rows (dt = 0);
    per chunk the inclusive cumulative log-decay ``Lc`` in fp32, and four
    bf16 products with fp32 sums. The bf16 inputs x, B and C enter as they
    are (exact). The three operands the kernel computes enter as bf16 hi +
    lo pairs: ``M = S ⊙ exp(min(Lc_t − Lc_j, 0)) ⊙ dt_j`` (j ≤ t) of ``y =
    M·X``, the copy of the fp32 state in ``C·hᵀ``, and ``X ⊙ w`` of the
    state update ``(X ⊙ w)ᵀ·B`` with ``w = exp(L_last − Lc)·dt``. The
    state itself stays fp32. (Rounded once to bf16, these operands leave
    ``_rec_tol``(bf16): see the test below. The kernel's exp2/log2
    approximations, about 2^-22 relative, are not modelled.) ``operand``
    rounds those three operands."""
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    f32 = torch.float32
    L = KERNEL_CHUNK
    pad = (-S) % L
    x, Bm, Cm = (_bf16(t.to(f32)) for t in (x, Bm, Cm))
    dt = dt.to(f32)
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt, Bm, Cm = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                      for t in (dt, Bm, Cm))
    lA = -torch.exp(A_log.to(f32))
    h = (torch.zeros((Bb, H, P, N), dtype=f32) if state is None
         else state.to(f32).clone())
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool))
    ys = []
    for c in range(x.shape[1] // L):
        sl = slice(c * L, (c + 1) * L)
        xc, dtc, Bc, Cc = x[:, sl], dt[:, sl], Bm[:, sl], Cm[:, sl]
        Lc = torch.cumsum(dtc * lA, dim=1)  # (B, L, H)
        s = Cc @ Bc.transpose(1, 2)  # (B, t, j), exact in fp32
        decay = torch.exp(torch.clamp(Lc[:, :, None, :] - Lc[:, None, :, :],
                                      max=0.0))  # (B, t, j, H)
        M = s[..., None] * decay * dtc[:, None, :, :]
        M = operand(torch.where(tri[None, :, :, None], M, 0.0))
        y = torch.einsum("btjh,bjhp->bthp", M, xc)
        ch = torch.einsum("btn,bhpn->bthp", Cc, operand(h))
        ys.append(y + torch.exp(Lc)[..., None] * ch)
        Llast = Lc[:, -1, :]  # (B, H)
        w = torch.exp(Llast[:, None, :] - Lc) * dtc  # (B, j, H)
        h = (torch.exp(Llast)[:, :, None, None] * h
             + torch.einsum("bjhp,bjn->bhpn", operand(xc * w[..., None]), Bc))
    return torch.cat(ys, dim=1)[:, :S], h


#: (B, S, H, P, N): the reduced shapes (Zamba2's reduced config has P 16,
#: N 16), ragged last chunks, and S = 1024 at a narrow H; every (P, N) the
#: wrapper takes is crossed with them below.
EMULATION_SHAPES = [(2, 128, 2), (1, 100, 2), (1, 1024, 1)]


@pytest.mark.parametrize("P", SD.HEAD_DIMS)
@pytest.mark.parametrize("N", SD.STATE_DIMS)
@pytest.mark.parametrize("shape", EMULATION_SHAPES,
                         ids=[f"B{b}-S{s}-H{h}" for b, s, h in EMULATION_SHAPES])
def test_bf16_kernel_arithmetic_within_rec_tol(shape, P, N):
    """The kernel's arithmetic (bf16 hi + lo operands for ``M``, the state
    copy and ``X ⊙ w``) holds ``_rec_tol``(bf16) against ``ssd_plain`` and the Pallas
    kernel in interpret mode, on bf16 x/B/C draws as
    ``chip_smoke.ssd_inputs`` makes them (dt = softplus(normal) + 0.01,
    A_log in [-1, 1.5))."""
    B, S, H = shape
    x, dt, A_log, Bm, Cm, st = _inputs((B, S, H, P, N), seed=S + P + N)
    tx, tB, tC = (_torch(a, "bfloat16") for a in (x, Bm, Cm))
    args = (tx, _torch(dt), _torch(A_log), tB, tC, _torch(st))
    y, hf = _ssd_bf16_kernel_emulation(*args)
    py, ph = SD.ssd_plain(*args, chunk=64)
    tol = _rec_tol("bfloat16")
    torch.testing.assert_close(y, py, **tol)
    torch.testing.assert_close(hf, ph, **tol)
    if S % KERNEL_CHUNK == 0:  # the Pallas kernel asserts S % chunk == 0
        jy, jh = jax_ssd_kernel(_jax(x, "bfloat16"), _jax(dt), _jax(A_log),
                                _jax(Bm, "bfloat16"), _jax(Cm, "bfloat16"),
                                state=_jax(st), chunk=KERNEL_CHUNK)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **tol)
        np.testing.assert_allclose(hf.numpy(), np.asarray(jh), **tol)


def test_single_bf16_operands_would_leave_rec_tol():
    """Why the kernel splits its computed operands: rounded once to bf16,
    M, the state copy and ``X ⊙ w`` leave ``_rec_tol``(bf16) against
    ``ssd_plain`` on an ordinary draw, where the hi + lo pairs hold it."""
    x, dt, A_log, Bm, Cm, st = _inputs((2, 128, 2, 64, 8), seed=200)
    args = (_torch(x, "bfloat16"), _torch(dt), _torch(A_log),
            _torch(Bm, "bfloat16"), _torch(Cm, "bfloat16"), _torch(st))
    py, _ = SD.ssd_plain(*args, chunk=64)
    tol = _rec_tol("bfloat16")

    def excess(y):  # > 0 where |y - plain| leaves atol + rtol·|plain|
        return float(((y - py).abs() - tol["atol"] - tol["rtol"] * py.abs()).max())

    assert excess(_ssd_bf16_kernel_emulation(*args)[0]) <= 0
    assert excess(_ssd_bf16_kernel_emulation(*args, operand=_bf16)[0]) > 0
