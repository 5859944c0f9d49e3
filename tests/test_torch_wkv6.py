"""The port's WKV6 against the JAX package's, on the CPU.

The port's plain chunked WKV6 (the CPU path of ``ops.wkv6``) is held to the
Pallas ``wkv6_kernel`` (interpret mode), to the XLA ``wkv6_chunked`` and to
``kernels/ref.wkv6_ref`` over the JAX kernel sweep, under the JAX tests'
``_rec_tol``; its gradients are held to ``jax.vjp`` of ``ops.wkv6``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as R
from repro.kernels.wkv6 import wkv6_kernel as jax_wkv6_kernel
from repro.models.rwkv6 import wkv6_chunked
from repro_torch.kernels import ops
from repro_torch.kernels import wkv6 as W

# The sweep of tests/test_kernels.py (WKV_SWEEP), with dtype names.
WKV_SWEEP = [
    # (B, S, H, hd, chunk, decay_lo, dtype)
    (1, 64, 2, 16, 16, -1.0, "float32"),
    (2, 128, 4, 32, 32, -0.5, "float32"),
    (1, 128, 2, 64, 64, -5.0, "float32"),  # strong decay
    (1, 96, 3, 16, 32, -1.0, "float32"),  # chunk > remainder handling
    (2, 128, 2, 32, 32, -1.0, "bfloat16"),
]


def _rec_tol(dtype):
    """``_rec_tol`` of tests/test_kernels.py: the chunked and sequential
    forms sum in different orders; bf16 inputs round first."""
    return (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
            else dict(rtol=1e-3, atol=1e-4))


def _inputs(case, seed=7):
    B, S, H, hd, _, decay_lo, _ = case
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    lw = -np.exp(rng.uniform(decay_lo, 0.5, (B, S, H, hd))).astype(np.float32)
    u = (rng.standard_normal((H, hd)) * 0.3).astype(np.float32)
    state = (rng.standard_normal((B, H, hd, hd)) * 0.1).astype(np.float32)
    return r, k, v, lw, u, state


def _torch(x, dtype="float32"):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _jax(x, dtype="float32"):
    return jnp.asarray(x).astype(getattr(jnp, dtype))


@pytest.mark.parametrize("case", WKV_SWEEP, ids=[str(i) for i in range(len(WKV_SWEEP))])
def test_plain_wkv6_matches_pallas_kernel_chunked_and_ref(case):
    chunk, dtype = case[4], case[6]
    r, k, v, lw, u, st = _inputs(case)
    jr, jk, jv = (_jax(x, dtype) for x in (r, k, v))
    tr, tk, tv = (_torch(x, dtype) for x in (r, k, v))
    out, sf = W.wkv6_plain(tr, tk, tv, _torch(lw), _torch(u), _torch(st),
                           chunk=chunk)
    assert out.dtype == sf.dtype == torch.float32
    refs = [
        jax_wkv6_kernel(jr, jk, jv, _jax(lw), _jax(u), state=_jax(st),
                        chunk=chunk),
        wkv6_chunked(jr, jk, jv, _jax(lw), _jax(u), state=_jax(st),
                     chunk=chunk),
        R.wkv6_ref(jr, jk, jv, _jax(lw), _jax(u), state=_jax(st)),
    ]
    for ro, rs in refs:
        np.testing.assert_allclose(out.numpy(), np.asarray(ro), **_rec_tol(dtype))
        np.testing.assert_allclose(sf.numpy(), np.asarray(rs), **_rec_tol(dtype))
    # The port's sequential oracle is the JAX oracle's twin.
    ro, rs = R.wkv6_ref(jr, jk, jv, _jax(lw), _jax(u), state=_jax(st))
    po, ps = W.wkv6_ref(tr, tk, tv, _torch(lw), _torch(u), _torch(st))
    np.testing.assert_allclose(po.numpy(), np.asarray(ro), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ps.numpy(), np.asarray(rs), rtol=1e-5, atol=1e-5)


def test_plain_wkv6_takes_a_sequence_the_chunk_does_not_divide():
    """77 steps in chunks of 32: the padded steps leave the state as it is,
    so out and final state equal the sequential oracle's (``_rec_tol``)."""
    r, k, v, lw, u, st = _inputs(WKV_SWEEP[3])
    r, k, v, lw = (x[:, :77] for x in (r, k, v, lw))
    out, sf = W.wkv6_plain(*(_torch(x) for x in (r, k, v, lw, u, st)), chunk=32)
    ro, rs = R.wkv6_ref(*(_jax(x) for x in (r, k, v, lw, u)), state=_jax(st))
    assert out.shape == (1, 77, 3, 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ro), **_rec_tol("float32"))
    np.testing.assert_allclose(sf.numpy(), np.asarray(rs), **_rec_tol("float32"))


@pytest.mark.parametrize("with_state", [True, False])
def test_wkv6_gradients_match_jax(with_state):
    """The CPU path's backward differentiates ``wkv6_plain`` at
    ``min(chunk, 32)`` as ``_wkv6_bwd`` differentiates ``wkv6_chunked``:
    fp32 on both sides, so 1e-4 covers the summation order."""
    case = (2, 64, 2, 16, 64, -1.0, "float32")
    r, k, v, lw, u, st = _inputs(case, seed=3)
    rng = np.random.default_rng(4)
    g_out = rng.standard_normal(r.shape).astype(np.float32)
    g_st = rng.standard_normal(st.shape).astype(np.float32)
    args = [r, k, v, lw, u] + ([st] if with_state else [])

    def f(*a):
        return jax_ops.wkv6(*a[:5], state=a[5] if with_state else None)

    (jo, js), vjp = jax.vjp(f, *(_jax(x) for x in args))
    jgrads = vjp((_jax(g_out), _jax(g_st)))
    live = [_torch(x).requires_grad_(True) for x in args]
    ops.reset_launches()
    to, ts = ops.wkv6(*live[:5], state=live[5] if with_state else None)
    torch.autograd.backward([to, ts], [_torch(g_out), _torch(g_st)])
    assert ops.launches["wkv6"] == 0  # the CPU path runs no kernel
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ts.detach().numpy(), np.asarray(js), rtol=1e-4, atol=1e-4)
    for t, j in zip(live, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=1e-4, atol=1e-4)
    assert len(jgrads) == len(live)


def test_kernel_refuses_cpu_tensors():
    """The kernel's entry point takes CUDA tensors only; the CPU path goes
    through ``ops.wkv6`` to the plain version."""
    r = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        W.wkv6_kernel(r, r, r, r, torch.zeros((2, 16)))


# ---------------------------------------------------------------------------
# The CUDA kernel's arithmetic, emulated on the CPU.
# ---------------------------------------------------------------------------

#: hd -> (16-byte row pieces per thread, row groups per column group) of
#: ``csrc/wkv6.cu``'s state tile (``Tile``).
KERNEL_TILE = {16: (1, 4), 32: (1, 8), 64: (2, 8)}


def _lane_sums(terms):
    """``terms`` (..., hd) summed as one warp of ``csrc/wkv6.cu``'s
    preparing pass sums them: lane l adds channels l, l + 32, ... in order,
    then an xor butterfly over the 32 lanes (offsets 16, 8, 4, 2, 1); lane
    0's sum."""
    hd = terms.shape[-1]
    lanes = torch.zeros(terms.shape[:-1] + (32,), dtype=terms.dtype)
    for c0 in range(0, hd, 32):
        n = min(32, hd - c0)
        lanes[..., :n] = lanes[..., :n] + terms[..., c0:c0 + n]
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., torch.arange(32) ^ off]
    return lanes[..., 0]


def _wkv6_kernel_emulation(r, k, v, lw, u, state=None):
    """``csrc/wkv6.cu``'s arithmetic, step for step, in fp32:

    * ``w = exp(lw)`` once per element, as the chunk is staged;
    * the hoisted bonus ``a_t = Σ_c (r_c u_c) k_c`` in the preparing
      warp's order (``_lane_sums``);
    * ``o_t[d]``: the RG row groups of a column each own the 16-byte pieces
      q = rg, rg + RG, ... of the key rows (c = 4q + e) and sum ``r_c
      S[c][d]`` over them in order, row group 0 starting from ``v_d a_t``,
      the others from 0; the RG partials meet by xor shuffles at offsets
      RG/2, ..., 2, 1 (the reduce-scatter adds the same pairs, in the same
      order, as an all-reduce);
    * ``S[c][d] ← w_c S[c][d] + k_c v_d``.

    The kernel's FMA contractions (one rounding where this rounds twice)
    are not modelled."""
    B, S, H, hd = r.shape
    f32 = torch.float32
    nq, rg = KERNEL_TILE[hd]
    r, k, v, lw, u = (t.to(f32) for t in (r, k, v, lw, u))
    w = torch.exp(lw)
    a = _lane_sums((r * u) * k)  # (B, S, H)
    St = (torch.zeros((B, H, hd, hd), dtype=f32) if state is None
          else state.to(f32).clone())
    outs = []
    for t in range(S):
        # c = 4 (g + RG j) + e: rows as axes (j, g, e); partials (B, H, g, d).
        prod = (r[:, t, :, :, None] * St).reshape(B, H, nq, rg, 4, hd)
        acc = torch.zeros((B, H, rg, hd), dtype=f32)
        acc[:, :, 0] = v[:, t] * a[:, t, :, None]
        for j in range(nq):
            for e in range(4):
                acc = acc + prod[:, :, j, :, e]
        off = rg // 2
        while off:
            acc = acc + acc[:, :, torch.arange(rg) ^ off]
            off //= 2
        outs.append(acc[:, :, 0])
        St = w[:, t, :, :, None] * St + k[:, t, :, :, None] * v[:, t, :, None, :]
    return torch.stack(outs, dim=1), St


def _path_inputs(B, S, H, hd, decays, seed):
    """fp32 r/k/v as the RWKV-6 path gives them; lw at the RWKV-6 init's
    decays (-exp(-0.6 + 0.1 normal)) or over ``_decay``'s whole clip range
    (-exp(uniform(-8, 3)), clipped to [-60, -1e-6]), as
    ``chip_smoke.wkv6_inputs`` draws them; u; an initial state."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    if decays == "init":
        lw = -np.exp(-0.6 + 0.1 * rng.standard_normal((B, S, H, hd)))
    else:
        lw = -np.exp(rng.uniform(-8.0, 3.0, (B, S, H, hd)))
    lw = np.clip(lw, -60.0, -1e-6).astype(np.float32)
    u = (rng.standard_normal((H, hd)) * 0.3).astype(np.float32)
    state = (rng.standard_normal((B, H, hd, hd)) * 0.1).astype(np.float32)
    return r, k, v, lw, u, state


#: (B, S, H): a long sequence at a narrow width, and a ragged one (the
#: kernel stages 32 steps at a time).
EMULATION_SHAPES = [(1, 1024, 2), (2, 77, 3)]


@pytest.mark.parametrize("hd", W.HEAD_DIMS)
@pytest.mark.parametrize("decays", ["init", "clip"])
@pytest.mark.parametrize("shape", EMULATION_SHAPES,
                         ids=[f"B{b}-S{s}-H{h}" for b, s, h in EMULATION_SHAPES])
def test_kernel_arithmetic_within_rec_tol_of_fp64_oracle(shape, decays, hd):
    """The kernel's arithmetic (each column's rows split over its row
    groups, the hoisted bonus, exp(lw) at staging) holds ``_rec_tol`` against the fp64
    sequential oracle at the RWKV-6 init's decays and at the whole clip
    range, where the chunked form at chunk 64 does not (``wkv6_kernel``'s
    docstring); and the JAX package's sequential oracle, in fp32."""
    B, S, H = shape
    args = _path_inputs(B, S, H, hd, decays, seed=S + hd)
    out, sf = _wkv6_kernel_emulation(*(_torch(x) for x in args))
    o64, s64 = W.wkv6_ref(*(torch.from_numpy(x).double() for x in args))
    tol = _rec_tol("float32")
    torch.testing.assert_close(out.double(), o64, **tol)
    torch.testing.assert_close(sf.double(), s64, **tol)
    ro, rs = R.wkv6_ref(*(_jax(x) for x in args[:5]), state=_jax(args[5]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ro), **tol)
    np.testing.assert_allclose(sf.numpy(), np.asarray(rs), **tol)


def test_kernel_arithmetic_reads_bf16_inputs_as_the_plain_version():
    """bf16 r/k/v enter the kernel's fp32 arithmetic as they are; the
    emulation holds ``_rec_tol``(bf16) against ``wkv6_plain`` and the Pallas
    kernel (interpret mode) on the same bf16 inputs."""
    case = (2, 128, 2, 32, 32, -1.0, "bfloat16")
    r, k, v, lw, u, st = _inputs(case, seed=11)
    tr, tk, tv = (_torch(x, "bfloat16") for x in (r, k, v))
    out, sf = _wkv6_kernel_emulation(tr, tk, tv, _torch(lw), _torch(u), _torch(st))
    po, ps = W.wkv6_plain(tr, tk, tv, _torch(lw), _torch(u), _torch(st), chunk=32)
    tol = _rec_tol("bfloat16")
    torch.testing.assert_close(out, po, **tol)
    torch.testing.assert_close(sf, ps, **tol)
    jo, js = jax_wkv6_kernel(*(_jax(x, "bfloat16") for x in (r, k, v)),
                             _jax(lw), _jax(u), state=_jax(st), chunk=32)
    np.testing.assert_allclose(out.numpy(), np.asarray(jo), **tol)
    np.testing.assert_allclose(sf.numpy(), np.asarray(js), **tol)
