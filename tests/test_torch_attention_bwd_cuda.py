"""The attention backward kernels (``csrc/attention_bwd.cuh``) on the card.

dq, dk and dv of bf16 calls through ``ops.flash_attention`` against the
fp32 autograd of ``attention_plain`` on the same bf16 values, over every
mask kind, windows, prefixes, ``q_offset``, softcaps, GQA, every head dim
the kernels take and the training paths' lengths, ragged ones included;
the same bits on a second run; the forward's output the same bits with and
without the log-sum-exp it writes for the backward; and the plain backward's
profiler range gone from a bf16 step but still opened by fp32 calls and by
head dim 256. Every test needs an NVIDIA GPU and skips without one; like
``test_torch_cuda.py`` the file imports neither JAX nor ``repro``:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_attention_bwd_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.models.layers import MaskSpec, _mask_block

pytestmark = pytest.mark.cuda
bf16 = torch.bfloat16

#: (B, Sq, Skv, H, K, hd, kind, window, prefix, softcap, q_offset)
CASES = [
    ("gpt2", (2, 1024, 1024, 12, 12, 64, "causal", 0, 0, 0.0, 0)),
    ("whisper encoder", (2, 1500, 1500, 12, 12, 64, "full", 0, 0, 0.0, 0)),
    ("whisper decoder", (2, 448, 448, 12, 12, 64, "causal", 0, 0, 0.0, 0)),
    ("whisper cross", (2, 448, 1500, 12, 12, 64, "full", 0, 0, 0.0, 0)),
    ("ragged 1023", (1, 1023, 1023, 4, 4, 64, "causal", 0, 0, 0.0, 0)),
    ("ragged q_offset", (2, 193, 257, 4, 2, 32, "causal", 0, 0, 0.0, 64)),
    ("hd 16 ragged", (2, 129, 129, 2, 2, 16, "causal", 0, 0, 0.0, 0)),
    ("window", (1, 512, 512, 4, 4, 64, "causal", 128, 0, 0.0, 0)),
    ("window q_offset", (1, 200, 456, 8, 8, 64, "causal", 100, 0, 0.0, 256)),
    ("prefix", (2, 300, 300, 8, 1, 64, "prefix", 0, 100, 0.0, 0)),
    ("prefix window", (1, 300, 300, 4, 1, 112, "prefix", 64, 100, 0.0, 0)),
    ("softcap", (1, 256, 256, 4, 2, 128, "causal", 0, 0, 30.0, 0)),
    ("softcap window", (1, 300, 300, 4, 2, 128, "causal", 64, 0, 50.0, 0)),
    ("gqa 32:4", (1, 512, 512, 32, 4, 64, "causal", 0, 0, 0.0, 0)),
    ("gqa 56:8", (1, 256, 256, 56, 8, 128, "causal", 0, 0, 0.0, 0)),
    ("gqa 64:8 hd 112", (1, 320, 320, 64, 8, 112, "causal", 0, 0, 0.0, 0)),
]
#: The gradients' error against the fp32 oracle, over its norm (``REL``)
#: and, for the largest, over the oracle's largest element (``PEAK``). The
#: kernels' operands are bf16 (q, k, v, dO, and P and dS rounded to it
#: before their products, each off by up to 2^-9 of itself) and dq, dk, dv
#: are stored in bf16 (2^-9 more); every sum is fp32. Those errors are
#: independent from element to element, so the whole error stays a few
#: times 2^-9 ≈ 0.002 of the gradient's norm.
REL, PEAK = 1e-2, 2e-2


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _inputs(gen, case, dtype=bf16):
    B, Sq, Skv, H, K, hd = case[:6]

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return rnd(B, Sq, H, hd), rnd(B, Skv, K, hd), rnd(B, Skv, K, hd), rnd(B, Sq, H, hd)


def _mask(case):
    kind, window, prefix, softcap, q_offset = case[6:]
    return MaskSpec(kind, window=window, prefix_len=prefix), dict(
        scale=case[5] ** -0.5, softcap=softcap, q_offset=q_offset)


def _kernel_grads(q, k, v, g, case):
    spec, kw = _mask(case)
    live = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ops.flash_attention(*live, spec, **kw).backward(g)
    return [t.grad for t in live]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_gradients_match_fp32_autograd_of_plain(gen, case):
    case = case[1]
    q, k, v, g = _inputs(gen, case)
    ops.reset_launches()
    got = _kernel_grads(q, k, v, g, case)
    assert ops.launches["flash_attention_bwd"] == 1
    spec, kw = _mask(case)
    ref = [t.float().requires_grad_(True) for t in (q, k, v)]
    fa.attention_plain(*ref, spec, **kw).backward(g.float())
    for name, a, t in zip("qkv", got, ref):
        assert a.dtype == bf16 and a.shape == t.shape
        err = a.float() - t.grad
        rel = float(err.norm() / t.grad.norm())
        peak = float(err.abs().max() / t.grad.abs().max())
        assert rel <= REL and peak <= PEAK, (name, rel, peak)


@pytest.mark.parametrize("case", [CASES[0], CASES[9], CASES[12], CASES[14]],
                         ids=lambda c: c[0])
def test_two_runs_give_the_same_bits(gen, case):
    case = case[1]
    q, k, v, g = _inputs(gen, case)
    spec, kw = _mask(case)
    B, Sq, H = q.shape[:3]
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device="cuda")
    with fa.writing_lse(lse):
        o = fa.flash_attention_kernel(q, k, v, kind=spec.kind, window=spec.window,
                                      prefix_len=spec.prefix_len, **kw)
    args = dict(kind=spec.kind, window=spec.window, prefix_len=spec.prefix_len, **kw)
    first = fa.flash_attention_bwd_kernel(q, k, v, o, lse, g, **args)
    second = fa.flash_attention_bwd_kernel(q, k, v, o, lse, g, **args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", [CASES[0], CASES[1], CASES[5], CASES[10], CASES[12],
                                  ("decode shape", (2, 1, 300, 8, 2, 64, "causal", 0, 0,
                                                    0.0, 299))],
                         ids=lambda c: c[0])
def test_lse_leaves_the_output_bits_and_is_the_rows_logsumexp(gen, case):
    """Asking for the log-sum-exp leaves ``o`` bit for bit where the call
    takes the wgmma kernel either way; a decode-sized call that asks for it
    takes that kernel too (its ``o`` within the bf16 tolerance of the
    decode regime's). The lse is the fp32 log-sum-exp of the scaled (and
    softcapped) scores that the mask admits."""
    case = case[1]
    q, k, v, _ = _inputs(gen, case)
    spec, kw = _mask(case)
    B, Sq, H = q.shape[:3]
    args = dict(kind=spec.kind, window=spec.window, prefix_len=spec.prefix_len, **kw)
    plain = fa.flash_attention_kernel(q, k, v, **args)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device="cuda")
    with fa.writing_lse(lse):
        o = fa.flash_attention_kernel(q, k, v, **args)
    if fa.regime(bf16, Sq, H, k.shape[2]) == "wgmma":
        assert torch.equal(o, plain)
    else:
        torch.testing.assert_close(o.float(), plain.float(), rtol=2e-2, atol=2e-2)
    G = H // k.shape[2]
    s = torch.einsum("bqhd,bjhd->bhqj", q.float() * kw["scale"],
                     k.float().repeat_interleave(G, dim=2))
    if kw["softcap"] > 0:
        s = kw["softcap"] * torch.tanh(s / kw["softcap"])
    pos = kw["q_offset"] + torch.arange(Sq, device="cuda", dtype=torch.int32)
    keep = _mask_block(spec, pos, torch.arange(k.shape[1], device="cuda", dtype=torch.int32))
    want = torch.logsumexp(s.masked_fill(~keep, float("-inf")), dim=-1)
    # fp32 scores from bf16 operands in another order, exp2 in one MUFU op.
    torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-4)


def _profiled_ranges(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.name for e in prof.events()}


def test_a_bf16_step_runs_no_plain_backward(gen):
    cfg = get_config("gpt2").reduced()
    model = build_model(cfg, device="cuda")
    state = model.init_train_state(torch.Generator(device="cuda").manual_seed(1))
    step = model.make_train_step()
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 65))
    ops.reset_launches()
    names = _profiled_ranges(lambda: step(state, {"tokens": tokens}))
    assert "repro_torch.step.backward" in names
    assert ops.BACKWARD_RANGES[0] not in names
    assert ops.launches["flash_attention_bwd"] == cfg.n_layers
    assert any("attn_bwd_dkdv_kernel" in n for n in names), sorted(names)
    assert not any("attn_bwd" in n and "flash_attention" in n for n in names)


@pytest.mark.parametrize("dtype, hd", [(torch.float32, 64), (bf16, 256)])
def test_fp32_and_hd_256_keep_the_plain_backward(gen, dtype, hd):
    case = (1, 128, 128, 2, 2, hd, "causal", 0, 0, 0.0, 0)
    q, k, v, g = _inputs(gen, case, dtype)
    assert fa.backward_regime(dtype, hd) == "plain"
    ops.reset_launches()
    names = _profiled_ranges(lambda: _kernel_grads(q, k, v, g, case))
    assert ops.BACKWARD_RANGES[0] in names
    assert ops.launches["flash_attention_bwd"] == 0
    assert not any("attn_bwd" in n for n in names)


def test_serving_forward_writes_no_lse(gen, monkeypatch):
    """Without grad mode (serving) a bf16 call on inputs that require grad
    writes no log-sum-exp and gives the kernel's plain output; with grad
    mode it writes one."""
    asked = []
    writing = fa.writing_lse
    monkeypatch.setattr(fa, "writing_lse", lambda lse: asked.append(lse) or writing(lse))
    case = CASES[2][1]
    q, k, v, _ = _inputs(gen, case)
    spec, kw = _mask(case)
    q.requires_grad_(True)
    with torch.no_grad():
        out = ops.flash_attention(q, k, v, spec, **kw)
    assert out.grad_fn is None and not asked
    assert torch.equal(out, fa.flash_attention_kernel(
        q.detach(), k, v, kind=spec.kind, window=spec.window,
        prefix_len=spec.prefix_len, **kw))
    ops.flash_attention(q, k, v, spec, **kw)
    assert len(asked) == 1
