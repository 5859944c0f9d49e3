"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU (and ``nvcc`` to build the kernels);
without one it skips. The file imports neither JAX nor ``repro`` so that it
runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports the JAX package.)
"""
import importlib.util
import pathlib

import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import shard_codec as codec
from repro_torch.kernels import ssd as SD
from repro_torch.kernels import wkv6 as W
from repro_torch.models.layers import MaskSpec

pytestmark = pytest.mark.cuda


def _load_chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


#: The card script's checks are the source of the cases, inputs and
#: tolerances; the tests add ragged shapes and others no main path gives.
chip_smoke = _load_chip_smoke()
f32, bf16 = torch.float32, torch.bfloat16
ATTN_CASES = chip_smoke.attention_cases() + [
    # (B, Sq, Skv, H, K, hd, kind, window, prefix, softcap, dtype)
    ("ragged", (1, 100, 100, 2, 2, 32, "causal", 0, 0, 0.0, f32), 0.0),
    ("ragged cross", (1, 96, 200, 4, 2, 16, "full", 0, 0, 0.0, f32), 0.0),
    ("prefix window", (1, 256, 256, 2, 1, 32, "prefix", 16, 32, 0.0, f32), 0.0),
    ("hd 128", (1, 192, 192, 2, 2, 128, "causal", 48, 0, 30.0, bf16), 0.0),
]
WKV_CASES = chip_smoke.wkv6_cases() + [
    ("ragged S", (1, 100, 3, 16, (-1.0, 0.5), f32, True, 64, False)),
    ("chunk 32", (2, 128, 4, 32, (-0.5, 0.5), f32, True, 32, False)),
    # The kernel stages 32 steps at a time: one step, one chunk and one
    # step more (at the clip range, against the fp64 oracle too), a ragged
    # bf16 tail, and a long bf16 run at hd 32.
    ("one step", (2, 1, 2, 64, (-1.0, 0.5), f32, True, 64, False)),
    ("S 33 clip range", (1, 33, 2, 64, (-8.0, 3.0), f32, True, 16, True)),
    ("ragged S bf16", (1, 100, 3, 16, (-1.0, 0.5), bf16, True, 64, False)),
    ("S 1024 hd 32 bf16", (1, 1024, 2, 32, "init", bf16, False, 64, False)),
]
SSD_CASES = chip_smoke.ssd_cases() + [
    ("fp32 long", (2, 1024, 8, 64, 64, f32, True)),
    ("ragged S", (1, 100, 2, 16, 8, f32, True)),
]


def _ids(cases):
    return [f"{i}-{c[0]}" for i, c in enumerate(cases)]


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


def test_many_leaf_encode_bit_identical_to_per_leaf_plain(gen):
    chip_smoke.check_encode_many(codec, chip_smoke.codec_many_leaves(gen))


def test_many_leaf_decode_bit_identical_to_per_leaf_plain_on_gpt2_leaves(gen):
    leaves = [torch.randn(shape, generator=gen, device="cuda")
              for shape in chip_smoke.gpt2_fp32_shapes()]
    codes, scales = chip_smoke.leaf_rows(*codec.shard_encode_many_kernel(leaves))
    chip_smoke.check_decode_many(codec, codes, scales, [x.numel() for x in leaves])


def test_many_leaf_decode_bit_identical_to_per_leaf_plain_on_ragged_set(gen):
    chip_smoke.check_decode_many(codec, *chip_smoke.codec_decode_leaves(codec, gen))


@pytest.mark.parametrize("offset", [1, 3, 8])
def test_many_leaf_decode_reads_misaligned_codes(gen, offset):
    """Codes views that start ``offset`` bytes off a 16-byte boundary, with
    an aligned leaf before and after them in the same launch."""
    x = torch.randn(5000, generator=gen, device="cuda")
    c, s = codec.shard_encode_kernel(x)
    raw = torch.empty(c.numel() + offset, dtype=torch.int8, device="cuda")
    raw[offset:] = c.reshape(-1)
    view = raw[offset:].view(c.shape)
    assert view.data_ptr() % 16 == offset % 16
    chip_smoke.check_decode_many(codec, [c, view, c], [s, s, s], [5000, 4999, 4097])


def test_encode_state_launches_the_encode_once(gen):
    """One ``encode_state`` launches the encode once for all its fp32 leaves
    (not for the empty or the int32 leaf), and ``decode_state`` the decode
    once for all coded leaves; codes, scales and wire bytes equal the CPU
    path's, and the decoded leaves the per-leaf plain decode."""
    from repro_torch import tree as T
    from repro_torch.core import replication as rep

    state = {"a": torch.randn(1000, generator=gen, device="cuda"),
             "b": {"c": torch.randn((3, 300), generator=gen, device="cuda"),
                   "n": torch.arange(5, dtype=torch.int32, device="cuda")},
             "e": torch.zeros(0, device="cuda"),
             "w": torch.randn((64, 256), generator=gen, device="cuda")}
    ops.reset_launches()
    enc, manifest, wire = rep.encode_state(state, "int8")
    assert ops.launches["shard_encode"] == 1 and ops.launches["shard_decode"] == 0
    dec = rep.decode_state(enc, manifest)
    assert ops.launches == {"shard_encode": 1, "shard_decode": 1,
                            "flash_attention": 0, "wkv6": 0, "ssd": 0}
    assert rep.roundtrip_max_error_ok(state, dec, enc)
    for e, d in zip(enc, T.leaves(dec)):
        if e.kind == "int8":
            assert torch.equal(d.reshape(-1), codec.shard_decode_plain(
                e.codes, e.scales, d.numel()))
    cpu = {"a": state["a"].cpu(), "b": {"c": state["b"]["c"].cpu(),
                                        "n": state["b"]["n"].cpu()},
           "e": state["e"].cpu(), "w": state["w"].cpu()}
    cenc, _, cwire = rep.encode_state(cpu, "int8")
    assert wire == cwire
    for g, c in zip(enc, cenc):
        assert (g.kind, g.payload_bytes, g.wire_bytes) == \
            (c.kind, c.payload_bytes, c.wire_bytes)
        if g.kind == "int8":
            assert torch.equal(g.codes.cpu(), c.codes)
            assert torch.equal(g.scales.cpu(), c.scales)


def test_decode_many_wrapper_launches_once_on_cuda(gen):
    codes, scales, numels = chip_smoke.codec_decode_leaves(codec, gen)
    ops.reset_launches()
    outs = ops.shard_decode_many(codes, scales, numels)
    assert ops.launches["shard_decode"] == 1
    for c, s, n, out in zip(codes, scales, numels, outs):
        assert torch.equal(out, codec.shard_decode_plain(c, s, n))
    ops.shard_decode_many(codes[4:5], scales[4:5], numels[4:5])  # empty leaf
    assert ops.launches["shard_decode"] == 1


@pytest.mark.parametrize("case", ATTN_CASES, ids=_ids(ATTN_CASES))
def test_flash_attention_kernel_matches_plain(gen, case):
    _, c, theta = case
    chip_smoke.attention_case(fa, gen, c, theta)


def test_wrappers_launch_and_count_on_cuda(gen):
    ops.reset_launches()
    x = torch.randn(1000, generator=gen, device="cuda")
    c, s, _ = ops.shard_encode_many([x])
    ops.shard_decode(c, s, 1000)
    q = torch.randn((1, 128, 2, 32), generator=gen, device="cuda",
                    requires_grad=True)
    out = ops.flash_attention(q, q, q, MaskSpec("causal"), scale=0.2)
    out.sum().backward()
    r = torch.randn((1, 64, 2, 16), generator=gen, device="cuda",
                    requires_grad=True)
    lw = -torch.rand((1, 64, 2, 16), generator=gen, device="cuda")
    u = torch.zeros((2, 16), device="cuda")
    ops.wkv6(r, r, r, lw, u)[0].sum().backward()
    x = torch.randn((1, 64, 2, 16), generator=gen, device="cuda",
                    requires_grad=True)
    bc = torch.randn((1, 64, 8), generator=gen, device="cuda")
    dt = torch.rand((1, 64, 2), generator=gen, device="cuda") + 0.01
    ops.ssd(x, dt, torch.zeros(2, device="cuda"), bc, bc)[0].sum().backward()
    assert ops.launches == {"shard_encode": 1, "shard_decode": 1,
                            "flash_attention": 1, "wkv6": 1, "ssd": 1}


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


@pytest.mark.parametrize("case", WKV_CASES, ids=_ids(WKV_CASES))
def test_wkv6_kernel_matches_plain(gen, case):
    chip_smoke.wkv6_case(W, gen, case[1])


@pytest.mark.parametrize("case", SSD_CASES, ids=_ids(SSD_CASES))
def test_ssd_kernel_matches_plain(gen, case):
    chip_smoke.ssd_case(SD, gen, case[1])


def test_recurrence_kernels_refuse_unsupported_shapes(gen):
    r = torch.zeros((1, 8, 2, 48), device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        W.wkv6_kernel(r, r, r, r, torch.zeros((2, 48), device="cuda"))
    x = torch.zeros((1, 8, 2, 16), device="cuda")
    bc = torch.zeros((1, 8, 32), device="cuda")
    with pytest.raises(ValueError, match="state dim"):
        SD.ssd_kernel(x, torch.ones((1, 8, 2), device="cuda"),
                      torch.zeros(2, device="cuda"), bc, bc)


def test_profile_reader_matches_key_averages(gen):
    """``chip_smoke.device_times`` reads the profiler's raw events in place
    of ``key_averages()`` (which builds an event tree and takes minutes on a
    full step): per device event name it must give the same time and count,
    and per plain-backward range the same device time inside it."""
    from torch.profiler import ProfilerActivity, profile

    r = torch.randn((2, 128, 2, 16), generator=gen, device="cuda",
                    requires_grad=True)
    lw = -torch.rand((2, 128, 2, 16), generator=gen, device="cuda")
    x = torch.randn((2, 128, 2, 16), generator=gen, device="cuda",
                    requires_grad=True)
    bc = torch.randn((2, 128, 8), generator=gen, device="cuda")
    dt = torch.rand((2, 128, 2), generator=gen, device="cuda") + 0.01
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ops.wkv6(r, r, r, lw, torch.zeros((2, 16), device="cuda"))[0].sum().backward()
        ops.ssd(x, dt, torch.zeros(2, device="cuda"), bc, bc)[0].sum().backward()
        torch.cuda.synchronize()
    rows, ranges = chip_smoke.device_times(prof.profiler.kineto_results.events(),
                                           ops.BACKWARD_RANGES)
    averages = prof.key_averages()
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    want = {e.key: (e.self_device_time_total / 1e3, e.count) for e in averages
            if e.device_type == cuda and e.self_device_time_total > 0
            and e.key not in ops.BACKWARD_RANGES}
    got = {name: (ms, count) for ms, count, name in rows}
    assert got.keys() == want.keys() and len(got) > 5
    for name, (ms, count) in want.items():
        assert got[name][1] == count
        assert got[name][0] == pytest.approx(ms, rel=1e-9, abs=1e-9)
    want = {e.key: (e.device_time_total / 1e3, e.count) for e in averages
            if e.key in ops.BACKWARD_RANGES and e.device_type == cpu}
    assert set(ranges) == set(want) == {"wkv6_plain_backward", "ssd_plain_backward"}
    for name, (ms, count) in want.items():
        assert ranges[name][1] == count
        assert ranges[name][0] == pytest.approx(ms, rel=1e-9, abs=1e-9)
        assert ms > 0
