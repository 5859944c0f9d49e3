"""The port's attention against the JAX package's, on the CPU.

The port's plain attention (the CPU path of ``ops.flash_attention``) is held
to ``kernels/ref.attention_ref`` and to the Pallas ``flash_attention_kernel``
(interpret mode) over the JAX kernel sweep, under the JAX tests' ``_tol``;
its gradients are held to ``jax.vjp`` of ``blocked_attention``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as R
from repro.kernels.flash_attention import flash_attention_kernel
from repro.models.layers import MaskSpec as JaxMaskSpec
from repro.models.layers import blocked_attention as jax_blocked_attention
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models.layers import MaskSpec

# The sweep of tests/test_kernels.py (ATTN_SWEEP), with dtype names.
ATTN_SWEEP = [
    # (B, Sq, Skv, H, K, hd, kind, window, prefix, softcap, dtype)
    (1, 128, 128, 2, 2, 32, "causal", 0, 0, 0.0, "float32"),
    (2, 256, 256, 4, 2, 64, "causal", 0, 0, 0.0, "float32"),
    (2, 256, 256, 4, 1, 64, "causal", 0, 0, 0.0, "float32"),  # MQA
    (1, 128, 128, 4, 4, 16, "full", 0, 0, 0.0, "float32"),
    (1, 256, 256, 2, 2, 32, "causal", 64, 0, 0.0, "float32"),  # window
    (1, 256, 256, 2, 1, 32, "prefix", 0, 32, 0.0, "float32"),  # vlm
    (1, 128, 128, 2, 2, 32, "causal", 0, 0, 50.0, "float32"),  # softcap
    (1, 256, 256, 8, 2, 64, "causal", 0, 0, 0.0, "bfloat16"),
    (1, 128, 512, 2, 2, 32, "full", 0, 0, 0.0, "float32"),  # cross Skv>Sq
]


def _tol(dtype):
    """``_tol`` of tests/test_kernels.py: bf16 rounds the output."""
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def _inputs(case, seed=7):
    B, Sq, Skv, H, K, hd = case[:6]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Skv, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, Skv, K, hd)).astype(np.float32)
    return q, k, v


def _as_jax(x, dtype):
    return jnp.asarray(x).astype(getattr(jnp, dtype))


def _as_torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("case", ATTN_SWEEP, ids=[str(i) for i in range(len(ATTN_SWEEP))])
def test_plain_attention_matches_ref_and_pallas_kernel(case):
    B, Sq, Skv, H, K, hd, kind, window, prefix, softcap, dtype = case
    q, k, v = _inputs(case)
    scale = 1.0 / np.sqrt(hd)
    jspec = JaxMaskSpec(kind, window=window, prefix_len=prefix)
    jq, jk, jv = (_as_jax(x, dtype) for x in (q, k, v))
    ref = R.attention_ref(jq, jk, jv, jspec, scale=scale, softcap=softcap,
                          is_local=True if window else None)
    kern = flash_attention_kernel(jq, jk, jv, scale=scale, softcap=softcap,
                                  kind=kind, window=window, prefix_len=prefix,
                                  block_q=64, block_k=64)
    spec = MaskSpec(kind, window=window, prefix_len=prefix)
    tq, tk, tv = (_as_torch(x, dtype) for x in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, spec, scale=scale, softcap=softcap)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    out = out.float().numpy()
    np.testing.assert_allclose(out, np.asarray(ref, np.float32), **_tol(dtype))
    np.testing.assert_allclose(out, np.asarray(kern, np.float32), **_tol(dtype))


def test_is_local_false_drops_the_window():
    case = (1, 128, 128, 2, 2, 32)
    q, k, v = (torch.from_numpy(x) for x in _inputs(case))
    spec = MaskSpec("causal", window=16)
    a = ops.flash_attention(q, k, v, spec, scale=0.2, is_local=False)
    b = ops.flash_attention(q, k, v, MaskSpec("causal"), scale=0.2)
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, spec, scale=0.2, is_local=torch.tensor(True))


@pytest.mark.parametrize("H,K,kind,window", [(2, 2, "causal", 0),
                                              (4, 2, "causal", 32),
                                              (4, 1, "full", 0)])
def test_gradients_match_jax_vjp_of_blocked_attention(H, K, kind, window):
    """fp32 inputs: the backward differentiates the plain attention, the
    JAX one the XLA path; both are fp32 throughout, so ``_tol``'s 2e-5
    relative plus the JAX grad test's 1e-4 absolute for summation order."""
    q, k, v = _inputs((1, 128, 128, H, K, 32), seed=3)
    g = np.random.default_rng(4).standard_normal(q.shape).astype(np.float32)
    jspec = JaxMaskSpec(kind, window=window)

    def jax_attn(q, k, v):
        return jax_blocked_attention(q, k, v, jspec, scale=0.2)

    _, vjp = jax.vjp(jax_attn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, MaskSpec(kind, window=window), scale=0.2)
    out.backward(torch.from_numpy(g))
    for t, j in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                   rtol=2e-5, atol=1e-4)


def test_kernel_entry_point_refuses_cpu_tensors():
    x = torch.zeros((1, 64, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_kernel(x, x, x, scale=0.25)
