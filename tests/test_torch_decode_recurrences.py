"""The SSD and WKV6 decode regimes against the JAX package's, on the CPU.

A serving decode step runs each recurrence at S = 1 from the state the last
step left. Calls of at most ``DECODE_MAX_STEPS`` steps take a kernel of
their own (``csrc/ssd_decode.cu``, ``csrc/wkv6_decode.cu``), which cannot
run here. Its arithmetic and its sums' order are emulated in torch (each
thread's float4 partials, the lane shuffles and, for WKV6, the warps'
partials in warp order) and held to the JAX package on the same
numpy-seeded inputs at ``_rec_tol("float32")``, at every (P, N) and head dim
the wrappers take, with and without a state. Also: ``regime`` at its
boundaries, and that the decode calls the reduced Zamba2 and RWKV-6 make
take the decode regime (SSD's strided views without a copy), their
prefills not.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as R
from repro.kernels.ssd import ssd_kernel as jax_ssd_kernel
from repro.models.mamba2 import ssd_chunked
from repro.models.rwkv6 import wkv6_decode as jax_wkv6_decode
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels import ssd as SD
from repro_torch.kernels import wkv6 as W
from repro_torch.models import build_model


def _rec_tol(dtype):
    """``_rec_tol`` of tests/test_kernels.py."""
    return (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
            else dict(rtol=1e-3, atol=1e-4))


def _jax(x):
    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(x)


def _bf16_valued(x):
    """fp32 values a bf16 tensor holds: the inputs rounded once to bf16."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _butterfly(lanes):
    """An xor butterfly over the last axis (its lanes), offsets n/2, ...,
    1, each lane adding its partner's value to its own; lane 0's sum."""
    n = lanes.shape[-1]
    off = n // 2
    while off:
        lanes = lanes + lanes[..., torch.arange(n) ^ off]
        off //= 2
    return lanes[..., 0]


# ---------------------------------------------------------------------------
# regime
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype, longer", [(torch.bfloat16, "chunked"),
                                           (torch.float32, "sequential")])
def test_ssd_regime_boundaries(dtype, longer):
    m = SD.DECODE_MAX_STEPS
    assert m >= 1
    assert [SD.regime(dtype, s) for s in (1, m, m + 1, 1024)] == [
        "decode", "decode", longer, longer]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wkv6_regime_boundaries(dtype):
    m = W.DECODE_MAX_STEPS
    assert m >= 1
    assert [W.regime(dtype, s) for s in (1, m, m + 1, 1024)] == [
        "decode", "decode", "sequential", "sequential"]


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------


def _ssd_decode_emulation(x, dt, A_log, Bm, Cm, state=None):
    """``csrc/ssd_decode.cu``'s arithmetic, step for step, in fp32: ``a =
    exp(dt · -exp(A_log))``; ``h ← a h + (dt x[p]) B[n]``; ``y[p]``: each
    thread's float4 of ``C[n] h[p, n]`` summed in order, then the N/4 lanes
    of the row by an xor butterfly (offsets N/8, ..., 1), lane 0's sum. The
    kernel's FMAs (one rounding where this rounds twice) are not
    modelled."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    f32 = torch.float32
    x, dt, A_log, Bm, Cm = (t.to(f32) for t in (x, dt, A_log, Bm, Cm))
    lA = -torch.exp(A_log)
    h = (torch.zeros((B, H, P, N), dtype=f32) if state is None
         else state.to(f32).clone())
    ys = []
    for t in range(S):
        a = torch.exp(dt[:, t] * lA)  # (B, H)
        dx = dt[:, t, :, None] * x[:, t]  # (B, H, P)
        h = a[..., None, None] * h + dx[..., None] * Bm[:, t, None, None, :]
        q = (Cm[:, t, None, None, :] * h).reshape(B, H, P, N // 4, 4)
        ys.append(_butterfly(((q[..., 0] + q[..., 1]) + q[..., 2]) + q[..., 3]))
    return torch.stack(ys, dim=1), h


def _ssd_inputs(B, S, H, P, N, seed):
    """bf16-valued x, B and C read as fp32 (as the decode regime reads the
    bf16 path's), dt = softplus(normal) + 0.01, A_log in [-1, 1.5), as
    ``chip_smoke.ssd_inputs`` draws them; a state whose batch row 0 is
    zeros (that row is also run from no state)."""
    rng = np.random.default_rng(seed)
    x = _bf16_valued(rng.standard_normal((B, S, H, P)).astype(np.float32))
    dt = (np.logaddexp(rng.standard_normal((B, S, H)), 0.0) + 0.01).astype(np.float32)
    A_log = rng.uniform(-1.0, 1.5, (H,)).astype(np.float32)
    Bm, Cm = (_bf16_valued(rng.standard_normal((B, S, N)).astype(np.float32))
              for _ in range(2))
    state = (rng.standard_normal((B, H, P, N)) * 0.1).astype(np.float32)
    state[0] = 0.0
    return x, dt, A_log, Bm, Cm, state


@pytest.mark.parametrize("P", SD.HEAD_DIMS)
@pytest.mark.parametrize("N", SD.STATE_DIMS)
def test_ssd_decode_arithmetic_matches_jax(P, N):
    """One decode step at every (P, N): the emulation against the JAX
    sequential oracle, the XLA ``ssd_chunked`` and the Pallas ``ssd_kernel``
    (interpret mode), and against the port's ``ssd_plain``, at
    ``_rec_tol("float32")``: the regime has no bf16 operand split, so it
    holds the fp32 bar. Batch row 0 runs from no state (``state=None``) and
    from a zero state; row 1 from a carried one."""
    args = _ssd_inputs(2, 1, 3, P, N, seed=P * 100 + N)
    x, dt, A_log, Bm, Cm, st = args
    y, hf = _ssd_decode_emulation(*(_t(a) for a in args))
    y0, h0 = _ssd_decode_emulation(*(_t(a[:1]) for a in (x, dt)), _t(A_log),
                                   *(_t(a[:1]) for a in (Bm, Cm)))
    tol = _rec_tol("float32")
    torch.testing.assert_close(y0, y[:1], rtol=0, atol=0)
    torch.testing.assert_close(h0, hf[:1], rtol=0, atol=0)
    jargs = [_jax(a) for a in (x, dt, A_log, Bm, Cm)]
    for ry, rh in (R.ssd_ref(*jargs, state=_jax(st)),
                   ssd_chunked(*jargs, state=_jax(st)),
                   jax_ssd_kernel(*jargs, state=_jax(st), chunk=64)):
        np.testing.assert_allclose(y.numpy(), np.asarray(ry), **tol)
        np.testing.assert_allclose(hf.numpy(), np.asarray(rh), **tol)
    py, ph = SD.ssd_plain(*(_t(a) for a in args), chunk=64)
    torch.testing.assert_close(y, py, **tol)
    torch.testing.assert_close(hf, ph, **tol)


@pytest.mark.parametrize("S", [2, SD.DECODE_MAX_STEPS])
def test_ssd_decode_arithmetic_over_several_steps(S):
    """The regime walks up to ``DECODE_MAX_STEPS`` steps with the state in
    registers: the emulation at Zamba2's (P, N) = (64, 64) over S steps
    against the JAX sequential oracle and the port's ``ssd_ref``."""
    args = _ssd_inputs(2, S, 2, 64, 64, seed=S)
    y, hf = _ssd_decode_emulation(*(_t(a) for a in args))
    ry, rh = R.ssd_ref(*(_jax(a) for a in args[:5]), state=_jax(args[5]))
    tol = _rec_tol("float32")
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **tol)
    np.testing.assert_allclose(hf.numpy(), np.asarray(rh), **tol)
    py, ph = SD.ssd_ref(*(_t(a) for a in args))
    torch.testing.assert_close(y, py, **tol)
    torch.testing.assert_close(hf, ph, **tol)


def test_row_stride_of_the_block_views():
    """``row_stride`` of the views ``mamba2.block_apply`` splits from one
    (B, S, d_in + 2N) tensor: x's and B/C's rows are d_in + 2N apart; a
    contiguous tensor's rows are its trailing size apart; a view off 16
    bytes, and rows that overlap, have none (the wrapper copies those)."""
    B, S, H, P, N = 3, 1, 4, 32, 8
    for dtype in (torch.bfloat16, torch.float32):
        xbc = torch.zeros((B, S, H * P + 2 * N), dtype=dtype)
        xs, Bm, Cm = torch.split(xbc, [H * P, N, N], dim=-1)
        assert SD.row_stride(xs.reshape(B, S, H, P)) == H * P + 2 * N
        assert SD.row_stride(Bm) == SD.row_stride(Cm) == H * P + 2 * N
        assert SD.row_stride(torch.zeros((B, 5, H, P), dtype=dtype)) == H * P
        assert SD.row_stride(torch.zeros((2, 5, H, P), dtype=dtype)[:, 1:]) is None
        assert SD.row_stride(torch.zeros((B, 1, 9), dtype=dtype)[..., 1:]) is None
        assert SD.row_stride(torch.zeros((1, N), dtype=dtype).expand(B, 1, N)) is None


# ---------------------------------------------------------------------------
# WKV6
# ---------------------------------------------------------------------------

#: hd -> (key rows per thread R, row groups per warp, warps) of
#: ``csrc/wkv6_decode.cu``'s ``Tile``; a thread's rows are c = rg + j·RG
#: (RG = row groups per warp × warps), a row group rg = warp·RGW + lane/LR.
DECODE_TILE = {16: (1, 8, 2), 32: (2, 4, 4), 64: (4, 4, 4)}


def _lane_sums(terms):
    """``terms`` (..., hd) summed as warp 0 sums the bonus: lane l adds
    channels l, l + 32 in order, then an xor butterfly over 32 lanes."""
    hd = terms.shape[-1]
    lanes = torch.zeros(terms.shape[:-1] + (32,), dtype=terms.dtype)
    for c0 in range(0, hd, 32):
        n = min(32, hd - c0)
        lanes[..., :n] = lanes[..., :n] + terms[..., c0:c0 + n]
    return _butterfly(lanes)


def _wkv6_decode_emulation(r, k, v, lw, u, state=None):
    """``csrc/wkv6_decode.cu``'s arithmetic, step for step, in fp32 (or in
    fp64 for fp64 inputs): the bonus ``a = Σ_c (r_c u_c) k_c`` in warp 0's
    order; ``Σ_c r_c S[c][d]``: each thread's R rows (c = rg + j·RG) in
    order, the row groups of a warp by an xor butterfly, the warps in warp
    order; ``o[d] = v[d] a + Σ``; then ``S[c][d] ← exp(lw_c) S[c][d] + k_c
    v[d]``. The kernel's FMAs are not modelled."""
    B, S, H, hd = r.shape
    ct = torch.promote_types(r.dtype, torch.float32)
    R_, RGW, NW = DECODE_TILE[hd]
    r, k, v, lw, u = (t.to(ct) for t in (r, k, v, lw, u))
    a = _lane_sums((r * u) * k)  # (B, S, H)
    St = (torch.zeros((B, H, hd, hd), dtype=ct) if state is None
          else state.to(ct).clone())
    outs = []
    for t in range(S):
        prod = (r[:, t, :, :, None] * St).reshape(B, H, R_, NW * RGW, hd)
        acc = prod[:, :, 0]
        for j in range(1, R_):
            acc = acc + prod[:, :, j]
        acc = _butterfly(acc.reshape(B, H, NW, RGW, hd).transpose(-1, -2))
        s = acc[:, :, 0]
        for w in range(1, NW):
            s = s + acc[:, :, w]
        outs.append(v[:, t] * a[:, t, :, None] + s)
        St = torch.exp(lw[:, t])[..., None] * St + k[:, t, :, :, None] * v[:, t, :, None, :]
    return torch.stack(outs, dim=1), St


def _wkv6_inputs(B, S, H, hd, decays, bf16, seed):
    """r, k, v (bf16-valued where ``bf16``); lw at the RWKV-6 init's decays
    or over ``_decay``'s whole clip range, as ``chip_smoke.wkv6_inputs``
    draws them; u; a state whose batch row 0 is zeros."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    if bf16:
        r, k, v = (_bf16_valued(x) for x in (r, k, v))
    if decays == "init":
        lw = -np.exp(-0.6 + 0.1 * rng.standard_normal((B, S, H, hd)))
    else:
        lw = -np.exp(rng.uniform(-8.0, 3.0, (B, S, H, hd)))
    lw = np.clip(lw, -60.0, -1e-6).astype(np.float32)
    u = (rng.standard_normal((H, hd)) * 0.3).astype(np.float32)
    state = (rng.standard_normal((B, H, hd, hd)) * 0.1).astype(np.float32)
    state[0] = 0.0
    return r, k, v, lw, u, state


@pytest.mark.parametrize("hd", W.HEAD_DIMS)
@pytest.mark.parametrize("decays", ["init", "clip"])
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_wkv6_decode_arithmetic_matches_jax(hd, decays, bf16):
    """One decode step at every head dim, fp32 and bf16-valued r/k/v, at
    the init's decays and over the whole clip range: the emulation against
    JAX's ``wkv6_decode`` and ``ref.wkv6_ref`` at ``_rec_tol("float32")``,
    against the fp64 oracle, and against the port's ``wkv6_plain``. Batch
    row 0 runs from no state and from a zero state; row 1 from a carried
    one."""
    args = _wkv6_inputs(2, 1, 3, hd, decays, bf16, seed=hd + 7 * bf16)
    r, k, v, lw, u, st = args
    out, sf = _wkv6_decode_emulation(*(_t(a) for a in args))
    o0, s0 = _wkv6_decode_emulation(*(_t(a[:1]) for a in (r, k, v, lw)), _t(u))
    torch.testing.assert_close(o0, out[:1], rtol=0, atol=0)
    torch.testing.assert_close(s0, sf[:1], rtol=0, atol=0)
    tol = _rec_tol("float32")
    jo, js = jax_wkv6_decode(*(_jax(a[:, 0]) for a in (r, k, v, lw)), _jax(u), _jax(st))
    np.testing.assert_allclose(out[:, 0].numpy(), np.asarray(jo), **tol)
    np.testing.assert_allclose(sf.numpy(), np.asarray(js), **tol)
    ro, rs = R.wkv6_ref(*(_jax(a) for a in (r, k, v, lw, u)), state=_jax(st))
    np.testing.assert_allclose(out.numpy(), np.asarray(ro), **tol)
    np.testing.assert_allclose(sf.numpy(), np.asarray(rs), **tol)
    o64, s64 = W.wkv6_ref(*(torch.from_numpy(a).double() for a in args))
    torch.testing.assert_close(out.double(), o64, **tol)
    torch.testing.assert_close(sf.double(), s64, **tol)
    po, ps = W.wkv6_plain(*(_t(a) for a in args), chunk=64)
    torch.testing.assert_close(out, po, **tol)
    torch.testing.assert_close(sf, ps, **tol)


@pytest.mark.parametrize("decays", ["init", "clip"])
def test_wkv6_decode_arithmetic_over_several_steps(decays):
    """``DECODE_MAX_STEPS`` steps with the state in registers: the
    emulation at RWKV-6's hd 64 against the fp64 oracle and JAX's
    sequential oracle."""
    args = _wkv6_inputs(2, W.DECODE_MAX_STEPS, 2, 64, decays, False, seed=11)
    out, sf = _wkv6_decode_emulation(*(_t(a) for a in args))
    tol = _rec_tol("float32")
    o64, s64 = W.wkv6_ref(*(torch.from_numpy(a).double() for a in args))
    torch.testing.assert_close(out.double(), o64, **tol)
    torch.testing.assert_close(sf.double(), s64, **tol)
    ro, rs = R.wkv6_ref(*(_jax(a) for a in args[:5]), state=_jax(args[5]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ro), **tol)
    np.testing.assert_allclose(sf.numpy(), np.asarray(rs), **tol)


# ---------------------------------------------------------------------------
# The models' calls
# ---------------------------------------------------------------------------


#: A prompt longer than either regime's last step.
PROMPT = max(SD.DECODE_MAX_STEPS, W.DECODE_MAX_STEPS) + 4


def _served_calls(monkeypatch, arch, kernel):
    """The arguments of every ``ops.<kernel>`` call of the reduced
    ``arch``'s prefill (``PROMPT`` tokens) and two decode steps on the CPU,
    in order, as (phase, args, kwargs)."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    calls = []
    real = getattr(ops, kernel)
    phase = ["prefill"]

    def recording(*args, **kw):
        calls.append((phase[0], args, kw))
        return real(*args, **kw)

    monkeypatch.setattr(ops, kernel, recording)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, PROMPT)))
    logits, cache = model.prefill(params, {"tokens": tokens}, max_len=PROMPT + 3)
    phase[0] = "decode"
    for pos in (PROMPT, PROMPT + 1):
        tok = torch.argmax(logits[:, -1:], dim=-1)
        logits, cache = model.decode_step(params, {"tokens": tok, "pos": pos,
                                                   "cache": cache})
    return cfg, calls


def test_zamba2_decode_calls_take_the_decode_regime(monkeypatch):
    """Reduced Zamba2: every SSD call of a decode step selects ``"decode"``
    from a carried state, and its x, B and C (views of one tensor) have
    row strides the regime reads without a copy; the prefill's do not
    select it."""
    cfg, calls = _served_calls(monkeypatch, "zamba2-1.2b", "ssd")
    decode = [(args, kw) for phase, args, kw in calls if phase == "decode"]
    prefill = [args for phase, args, _ in calls if phase == "prefill"]
    assert len(decode) == 2 * cfg.n_layers and len(prefill) == cfg.n_layers
    for args in prefill:
        assert SD.regime(args[0].dtype, args[0].shape[1]) != "decode"
    for (x, dt, A_log, Bm, Cm), kw in decode:
        assert x.shape[1] == 1 and SD.regime(x.dtype, 1) == "decode"
        assert kw["state"] is not None
        assert not x.is_contiguous() and not Bm.is_contiguous()
        assert SD.row_stride(x) is not None
        assert SD.row_stride(Bm) == SD.row_stride(Cm) is not None


def test_rwkv6_decode_calls_take_the_decode_regime(monkeypatch):
    """Reduced RWKV-6: every WKV6 call of a decode step selects
    ``"decode"`` from a carried state; the prefill's do not."""
    cfg, calls = _served_calls(monkeypatch, "rwkv6-1.6b", "wkv6")
    decode = [(args, kw) for phase, args, kw in calls if phase == "decode"]
    prefill = [args for phase, args, _ in calls if phase == "prefill"]
    assert len(decode) == 2 * cfg.n_layers and len(prefill) == cfg.n_layers
    for args in prefill:
        assert W.regime(args[0].dtype, args[0].shape[1]) != "decode"
    for args, kw in decode:
        assert args[0].shape[1] == 1 and W.regime(args[0].dtype, 1) == "decode"
        assert kw["state"] is not None
