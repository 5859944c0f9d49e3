"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU (and ``nvcc`` to build the kernels);
without one it skips. The file imports neither JAX nor ``repro`` so that it
runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports the JAX package.)
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import shard_codec as codec
from repro_torch.models.layers import MaskSpec

pytestmark = pytest.mark.cuda

ATTN_CASES = [
    # (B, Sq, Skv, H, K, hd, kind, window, prefix, softcap, dtype)
    (2, 1024, 1024, 12, 12, 64, "causal", 0, 0, 0.0, torch.bfloat16),  # gpt2
    (1, 100, 100, 2, 2, 32, "causal", 0, 0, 0.0, torch.float32),  # ragged
    (1, 96, 200, 4, 2, 16, "full", 0, 0, 0.0, torch.float32),  # ragged cross
    (1, 256, 256, 2, 1, 32, "prefix", 16, 32, 0.0, torch.float32),
    (1, 192, 192, 2, 2, 128, "causal", 48, 0, 30.0, torch.bfloat16),
]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("n", [1, 256, 257, 768, 50257 * 768 // 7])
def test_codec_kernels_bit_identical_to_plain(gen, n):
    x = torch.randn(n, generator=gen, device="cuda") * 2.0
    kc, ks = codec.shard_encode_kernel(x)
    pc, ps = codec.shard_encode_plain(x)
    assert torch.equal(kc, pc) and torch.equal(ks, ps)
    assert torch.equal(codec.shard_decode_kernel(kc, ks, n),
                       codec.shard_decode_plain(pc, ps, n))
    assert torch.equal(codec.shard_decode_kernel(kc, ks),
                       codec.shard_decode_plain(pc, ps))


@pytest.mark.parametrize("case", ATTN_CASES, ids=[str(i) for i in range(len(ATTN_CASES))])
def test_flash_attention_kernel_matches_plain(gen, case):
    B, Sq, Skv, H, K, hd, kind, window, prefix, softcap, dt = case
    q = torch.randn((B, Sq, H, hd), generator=gen, device="cuda").to(dt)
    k = torch.randn((B, Skv, K, hd), generator=gen, device="cuda").to(dt)
    v = torch.randn((B, Skv, K, hd), generator=gen, device="cuda").to(dt)
    out = fa.flash_attention_kernel(q, k, v, scale=hd ** -0.5, softcap=softcap,
                                    kind=kind, window=window, prefix_len=prefix)
    ref = fa.attention_plain(q, k, v, MaskSpec(kind, window, prefix),
                             scale=hd ** -0.5, softcap=softcap)
    tol = 2e-2 if dt == torch.bfloat16 else 2e-5  # _tol of test_kernels.py
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


def test_wrappers_launch_and_count_on_cuda(gen):
    ops.reset_launches()
    x = torch.randn(1000, generator=gen, device="cuda")
    c, s = ops.shard_encode(x)
    ops.shard_decode(c, s, 1000)
    q = torch.randn((1, 128, 2, 32), generator=gen, device="cuda",
                    requires_grad=True)
    out = ops.flash_attention(q, q, q, MaskSpec("causal"), scale=0.2)
    out.sum().backward()
    assert ops.launches == {"shard_encode": 1, "shard_decode": 1,
                            "flash_attention": 1}


def test_flash_attention_gradient_is_the_plain_gradient(gen):
    q, k, v = (torch.randn((1, 128, 4, 32), generator=gen, device="cuda")
               .requires_grad_(True) for _ in range(3))
    g = torch.randn((1, 128, 4, 32), generator=gen, device="cuda")
    ops.flash_attention(q, k, v, MaskSpec("causal"), scale=0.2).backward(g)
    grads = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    fa.attention_plain(q, k, v, MaskSpec("causal"), scale=0.2).backward(g)
    for a, t in zip(grads, (q, k, v)):
        torch.testing.assert_close(a, t.grad, rtol=1e-6, atol=1e-6)
