"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU (and ``nvcc`` to build the kernels);
without one it skips. The file imports neither JAX nor ``repro`` so that it
runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports the JAX package.)
"""
import dataclasses
import importlib.util
import pathlib

import numpy as np
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
    # (B, Sq, Skv, H, K, hd, kind, window, prefix, softcap, dtype), theta,
    # q_offset, scale (None: 1/sqrt(hd))
    ("ragged", (1, 100, 100, 2, 2, 32, "causal", 0, 0, 0.0, f32), 0.0, 0, None),
    ("ragged cross", (1, 96, 200, 4, 2, 16, "full", 0, 0, 0.0, f32), 0.0, 0, None),
    ("prefix window", (1, 256, 256, 2, 1, 32, "prefix", 16, 32, 0.0, f32), 0.0, 0,
     None),
    ("hd 128", (1, 192, 192, 2, 2, 128, "causal", 48, 0, 30.0, bf16), 0.0, 0, None),
    # One query row over a cache, fp32 and GQA, as a decode step.
    ("decode fp32", (2, 1, 300, 4, 4, 64, "causal", 0, 0, 0.0, f32), 0.0, 200, None),
    ("decode GQA", (2, 1, 300, 8, 2, 64, "causal", 0, 0, 0.0, bf16), 0.0, 299, None),
    # gemma2's local and global layers in fp32 (its fp32 serving check),
    # query scale 0.0625, a window that binds.
    ("gemma2 local fp32", (1, 1, 300, 4, 2, 128, "causal", 64, 0, 50.0, f32), 1e4,
     200, 0.0625),
    ("gemma2 global fp32", (1, 80, 300, 4, 2, 128, "causal", 0, 0, 50.0, f32), 1e4,
     200, 0.0625),
    # Head dim 256: PaliGemma's prefix of 256 into a longer, ragged cache in
    # fp32 (its fp32 serving check), and a bf16 decode row at MQA 8:1 over a
    # ragged cache.
    ("hd 256 prefix fp32", (2, 300, 400, 8, 1, 256, "prefix", 0, 256, 0.0, f32), 1e4,
     0, None),
    ("hd 256 decode bf16", (3, 1, 777, 8, 1, 256, "causal", 0, 0, 0.0, bf16), 1e4,
     700, None),
    # Head dim 112 (Kimi-K2's, two panels, the second half padding): GQA
    # 64:8 decode rows over a ragged cache in bf16 and fp32, a ragged
    # causal block in fp32, a prefix with a window in bf16.
    ("hd 112 decode bf16", (3, 1, 777, 64, 8, 112, "causal", 0, 0, 0.0, bf16), 1e4,
     700, None),
    ("hd 112 decode fp32", (2, 1, 300, 64, 8, 112, "causal", 0, 0, 0.0, f32), 1e4,
     299, None),
    ("hd 112 ragged fp32", (1, 100, 100, 8, 1, 112, "causal", 0, 0, 0.0, f32), 1e4,
     0, None),
    ("hd 112 prefix window", (1, 300, 300, 4, 1, 112, "prefix", 64, 100, 0.0, bf16),
     0.0, 0, None),
    # Whisper's shapes, ragged: the encoder's full attention over 1,500
    # frames in fp32 (its fp32 serving check), cross-attention from 7
    # queries and from one over them.
    ("whisper encoder fp32", (1, 1500, 1500, 12, 12, 64, "full", 0, 0, 0.0, f32), 0.0,
     0, None),
    ("whisper cross fp32", (2, 7, 1500, 12, 12, 64, "full", 0, 0, 0.0, f32), 0.0, 0,
     None),
    ("whisper cross decode", (3, 1, 1500, 12, 12, 64, "full", 0, 0, 0.0, bf16), 0.0, 0,
     None),
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
    # The decode regime from no state, in both dtypes; the sequential
    # kernel one step past the regime's last.
    ("decode no state", (2, 1, 3, 64, (-1.0, 0.5), f32, False, 64, False)),
    ("decode no state bf16", (2, 1, 3, 16, (-1.0, 0.5), bf16, False, 64, False)),
    ("sequential past decode", (2, W.DECODE_MAX_STEPS + 1, 3, 64, (-8.0, 3.0), f32,
                                True, 16, True)),
]
SSD_CASES = chip_smoke.ssd_cases() + [
    ("fp32 long", (2, 1024, 8, 64, 64, f32, True, False)),
    ("ragged S", (1, 100, 2, 16, 8, f32, True, False)),
    # The decode regime from no state, in both dtypes, on views and on
    # contiguous tensors; one (b, h) at (16, 8): four threads of one CTA.
    ("decode no state", (3, 1, 5, 64, 64, bf16, False, True)),
    ("decode no state fp32", (2, 1, 3, 32, 16, f32, False, False)),
    ("decode one (b, h)", (1, 1, 1, 16, 8, bf16, True, True)),
    # The chunked and sequential kernels one step past the regime's last.
    ("chunked past decode", (2, SD.DECODE_MAX_STEPS + 1, 3, 64, 64, bf16, True, True)),
    ("sequential past decode", (2, SD.DECODE_MAX_STEPS + 1, 3, 32, 16, f32, True, False)),
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
                            "flash_attention": 0, "wkv6": 0, "ssd": 0,
                            "flash_attention_bwd": 0}
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
    _, c, theta, q_offset, scale = case
    chip_smoke.attention_case(fa, gen, c, theta, q_offset, scale)


#: The one-row bf16 cases of the serving runs (``DECODE_Q_OFFSETS``, the
#: window's edges, PaliGemma past its prefix, Whisper's self and cross
#: attention, granite's 48:1 and llama3's 128:8 at full width).
DECODE_SERVE = [c for c in chip_smoke.serve_attention_cases() if c[1][1] == 1]


def _attention(q, k, v, c, q_offset, scale, n_split=None):
    B, Sq, Skv, H, K, d, kind, window, prefix, softcap, _ = c
    return fa.flash_attention_kernel(
        q, k, v, scale=d ** -0.5 if scale is None else scale, softcap=softcap,
        kind=kind, window=window, prefix_len=prefix, q_offset=q_offset,
        n_split=n_split)


def _plain(q, k, v, c, q_offset, scale):
    B, Sq, Skv, H, K, d, kind, window, prefix, softcap, _ = c
    return fa.attention_plain(q, k, v, MaskSpec(kind, window=window, prefix_len=prefix),
                              scale=d ** -0.5 if scale is None else scale,
                              softcap=softcap, q_offset=q_offset)


@pytest.mark.parametrize("case", DECODE_SERVE, ids=_ids(DECODE_SERVE))
def test_decode_regime_at_one_split_the_plans_and_the_most(gen, case):
    """Each serving decode case takes the decode regime and holds the plain
    version at ``_tol`` at n_split 1 (no merge), the plan's and the most
    the entry allows; two calls give the same bits."""
    _, c, theta, q_offset, scale = case
    B, Sq, Skv, H, K, d, kind, window, prefix, softcap, dt = c
    assert fa.regime(dt, Sq, H, K) == "decode"
    plan = fa.decode_split_plan(B, Sq, Skv, K, kind, window, prefix, q_offset)
    q, k, v = chip_smoke.attention_inputs(gen, c, theta, q_offset)
    want = _plain(q, k, v, c, q_offset, scale).float()
    for n in sorted({1, plan.n_split, min(fa.MAX_SPLITS, max(plan.n_tiles, 1))}):
        out = _attention(q, k, v, c, q_offset, scale, n)
        torch.testing.assert_close(out.float(), want, **chip_smoke.tol(dt))
        assert torch.equal(out, _attention(q, k, v, c, q_offset, scale, n)), n


def test_decode_split_the_mask_empties(gen):
    """A prefix of 64 and a window of 64 at position 400 leave keys 64-336
    out: at one split per tile, splits 1-4 hold no admitted key."""
    c = (2, 1, 512, 8, 2, 64, "prefix", 64, 64, 0.0, bf16)
    q, k, v = chip_smoke.attention_inputs(gen, c, 0.0, 400)
    plan = fa.decode_split_plan(2, 1, 512, 2, "prefix", 64, 64, 400)
    assert plan.n_tiles == 7
    want = _plain(q, k, v, c, 400, None).float()
    for n in (1, 7):
        torch.testing.assert_close(_attention(q, k, v, c, 400, None, n).float(), want,
                                   **chip_smoke.tol(bf16))


#: Edges of the admitted key range: (case, q_offset). A window starting
#: mid-tile and on a tile's first key, a prefix wider than the position,
#: q_offset 0, a full mask over a ragged Skv, a causal range ending mid-tile.
ENTRY_RANGE_CASES = [
    ((1, 1, 1000, 8, 2, 64, "causal", 100, 0, 50.0, bf16), 700),
    ((1, 1, 1000, 8, 2, 64, "causal", 101, 0, 0.0, bf16), 740),
    ((1, 1, 900, 8, 1, 128, "prefix", 0, 300, 0.0, bf16), 200),
    ((1, 1, 900, 8, 1, 128, "prefix", 0, 300, 0.0, bf16), 650),
    ((2, 1, 333, 4, 4, 64, "causal", 0, 0, 0.0, bf16), 0),
    ((2, 1, 1500, 12, 12, 64, "full", 0, 0, 0.0, bf16), 0),
    ((1, 1, 1100, 16, 2, 256, "causal", 0, 0, 0.0, bf16), 1000),
]


@pytest.mark.parametrize("case, q_offset", ENTRY_RANGE_CASES,
                         ids=[f"{c[6]}-w{c[7]}-p{c[8]}-Skv{c[2]}-at{o}"
                              for c, o in ENTRY_RANGE_CASES])
def test_decode_entry_cuts_the_plans_tiles(gen, case, q_offset):
    """The C entry's tile range is the plan's: at one split per tile (the
    plan's ``n_tiles``) every split is one of the plan's tiles, so a range
    shifted by a tile would drop an admitted tile and miss the plain
    version; one split more is refused, so the entry counts no more
    tiles."""
    B, Sq, Skv, H, K, d, kind, window, prefix, softcap, dt = case
    plan = fa.decode_split_plan(B, Sq, Skv, K, kind, window, prefix, q_offset)
    assert 1 <= plan.n_tiles < fa.MAX_SPLITS, plan
    q, k, v = chip_smoke.attention_inputs(gen, case, 0.0, q_offset)
    torch.testing.assert_close(
        _attention(q, k, v, case, q_offset, None, plan.n_tiles).float(),
        _plain(q, k, v, case, q_offset, None).float(), **chip_smoke.tol(dt))
    with pytest.raises(RuntimeError, match="CUDA error"):
        _attention(q, k, v, case, q_offset, None, plan.n_tiles + 1)


def test_decode_entry_refuses_a_split_outside_its_limits(gen):
    c = (1, 1, 300, 8, 1, 64, "causal", 0, 0, 0.0, bf16)
    q, k, v = chip_smoke.attention_inputs(gen, c, 0.0, 299)
    for n in (0, 6):  # 5 tiles of keys
        with pytest.raises(RuntimeError, match="CUDA error"):
            _attention(q, k, v, c, 299, None, n)
    f32c = c[:-1] + (f32,)
    with pytest.raises(RuntimeError, match="CUDA error"):  # no split outside the regime
        _attention(*(x.float() for x in (q, k, v)), f32c, 299, None, 2)


@pytest.mark.parametrize("H, want", [(64, "flash_attention_decode_kernel"),
                                     (65, "flash_attention_wgmma_kernel")])
def test_dispatch_either_side_of_sq_g_64(gen, H, want):
    """Sq·G = 64 takes the decode kernel (and its merge), 65 the wgmma
    tile: the profiler names the kernels that ran, and both hold the plain
    version."""
    from torch.profiler import ProfilerActivity, profile

    c = (2, 1, 700, H, 1, 128, "causal", 0, 0, 0.0, bf16)
    q, k, v = chip_smoke.attention_inputs(gen, c, 0.0, 650)
    assert fa.regime(bf16, 1, H, 1) == ("decode" if H == 64 else "wgmma")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = _attention(q, k, v, c, 650, None)
        torch.cuda.synchronize()
    names = " ".join(e.key for e in prof.key_averages())
    assert want in names, names
    other = ("flash_attention_wgmma_kernel" if H == 64
             else "flash_attention_decode_kernel")
    assert other not in names and ("merge" in names) == (H == 64), names
    torch.testing.assert_close(out.float(), _plain(q, k, v, c, 650, None).float(),
                               **chip_smoke.tol(bf16))


def test_decode_counts_one_launch_for_its_two_kernels(gen):
    q = torch.randn((2, 1, 8, 64), generator=gen, device="cuda").to(bf16)
    kv = torch.randn((2, 700, 1, 64), generator=gen, device="cuda").to(bf16)
    assert fa.decode_split_plan(2, 1, 700, 1, q_offset=650).n_split > 1
    ops.reset_launches()
    ops.flash_attention(q, kv, kv, MaskSpec("causal"), scale=0.125, q_offset=650)
    assert ops.launches["flash_attention"] == 1


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
                            "flash_attention": 1, "wkv6": 1, "ssd": 1,
                            "flash_attention_bwd": 0}


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


@pytest.mark.parametrize("dtype", [bf16, f32])
def test_ssd_decode_regime_reads_the_views_and_repeats_its_bits(gen, dtype):
    """At S = 1 ``ssd_kernel`` takes the decode regime: on the views
    ``block_apply`` passes (rows H·P + 2N elements apart, B·H leaving the
    last CTA part-filled) it gives the bits the regime gives
    on contiguous copies, and the same bits on a second run; the chunked or
    sequential kernel agrees within ``_rec_tol``."""
    args = chip_smoke.ssd_inputs(gen, 3, 1, 5, 64, 64, dtype, state=True, strided=True)
    assert SD.row_stride(args[0]) == 5 * 64 + 128 and not args[0].is_contiguous()
    y, hf = SD.ssd_kernel(*args)
    y2, hf2 = SD.ssd_kernel(*args)
    copies = [t.contiguous() for t in args[:5]] + [args[5]]
    y3, hf3 = SD.ssd_launch("decode", *copies)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(hf, hf2)
    assert torch.equal(y, y3) and torch.equal(hf, hf3)
    other = "chunked" if dtype == bf16 else "sequential"
    yo, ho = SD.ssd_launch(other, *args)
    torch.testing.assert_close(y, yo, **chip_smoke.rec_tol(dtype))
    torch.testing.assert_close(hf, ho, **chip_smoke.rec_tol(dtype))


@pytest.mark.parametrize("dtype", [bf16, f32])
@pytest.mark.parametrize("hd", W.HEAD_DIMS)
def test_wkv6_decode_regime_repeats_its_bits(gen, dtype, hd):
    """At S = 1 ``wkv6_kernel`` takes the decode regime: the same bits as
    the regime's own launch and on a second run; the sequential kernel
    agrees within ``_rec_tol``."""
    args = chip_smoke.wkv6_inputs(gen, 3, 1, 5, hd, dtype, state=True)
    out, sf = W.wkv6_kernel(*args)
    out2, sf2 = W.wkv6_launch("decode", *args)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(sf, sf2)
    oo, so = W.wkv6_launch("sequential", *args)
    torch.testing.assert_close(out, oo, **chip_smoke.rec_tol(dtype))
    torch.testing.assert_close(sf, so, **chip_smoke.rec_tol(dtype))


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


#: the served archs, reduced: the serving runs' (GPT-2, RWKV-6, Zamba2,
#: TinyLlama, PaliGemma, Arctic, Kimi, Whisper), the dense configs the card
#: runs only reduced (granite, llama3), and gemma2 (window 8: its local and
#: global layers differ).
SERVE_ARCHS = chip_smoke.SERVE_PATHS + chip_smoke.REDUCED_DENSE + ("gemma2-27b",)
#: and Zamba2 at 5 blocks: 3 applications of the shared block (the reduced
#: config has one), a ragged last segment.
SERVE_CASES = SERVE_ARCHS + ("zamba2-1.2b, 5 blocks",)


def _served(case):
    """The reduced config of ``case``, its params (seeded), tokens (a
    64-token prompt and ``FP32_DECODE_STEPS`` more) and the stubbed inputs
    as keyword arguments (a vlm's ``patches``, an encdec model's
    ``frames``)
    (None for the other families)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    arch, _, blocks = case.partition(", ")
    cfg = get_config(arch).reduced()
    if blocks:
        cfg = dataclasses.replace(cfg, n_layers=int(blocks.split()[0]))
    params = build_model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(2, 64 + chip_smoke.FP32_DECODE_STEPS))).cuda()
    stub = {key: torch.from_numpy(x).cuda()
            for key, x in chip_smoke.stub_for(cfg, 2, np.random.default_rng(1)).items()}
    return cfg, params, tokens, stub


@pytest.mark.parametrize("case", SERVE_CASES)
def test_serve_fp32_cached_matches_cache_free(gen, case):
    """``chip_smoke.serve_fp32_check`` on the reduced model on the card:
    fp32 prefill and forced decode steps through the kernels against the
    cache-free fp32 forward, within ``serve_tol``, and each planted fault
    outside it."""
    cfg, params, tokens, stub = _served(case)
    # A vlm's cache holds no spare row, so that one made without the
    # patches' rows overflows (its planted fault).
    cache_len = 64 + chip_smoke.FP32_DECODE_STEPS if "patches" in stub else 80
    ops.reset_launches()
    out = chip_smoke.serve_fp32_check(cfg, params, tokens, 64, cache_len,
                                      **stub)
    assert out["outside"] == 0
    assert set(out["faults"]) == set(chip_smoke.serve_faults(cfg))
    assert all("raised" in f or f["outside"] > 0 for f in out["faults"].values())
    for name, n in chip_smoke.serve_launches(cfg, 1).items():
        assert (ops.launches[name] > 0) == (n > 0), name


def _cpu(tree):
    return {k: _cpu(v) if isinstance(v, dict) else v.cpu() for k, v in tree.items()}


#: Reduced configs whose bf16 logits, served through the attention kernel,
#: leave bf16 ``_tol`` of the CPU's: the kernel's P·V runs on bf16 tensor
#: cores, so it rounds the probabilities to bf16 (the kernel is held to its
#: plain version at ``_tol`` call by call, ``chip_smoke.attention_cases``),
#: and over these models' untied unembedding that rounding moves 127
#: (TinyLlama), 48 (llama3), 85 (Arctic, routed as on the CPU) and 91
#: (Kimi-K2, routed alike) of 4,096 logits past ``_tol``, where the card's
#: plain attention (fp32 probabilities) leaves none (PERF.md §6).
#: JAX's XLA attention, which rounds them too, moves the reduced TinyLlama
#: past ``_tol`` of the port on the CPU the same way
#: (tests/test_torch_serve.py). Their bf16 comparison runs the plain
#: attention on the card; fp32 runs the kernel.
BF16_PROBABILITIES = ("tinyllama-1.1b", "llama3-405b", "arctic-480b",
                      "kimi-k2-1t-a32b")
CARD_CPU_CASES = [(c, d) for c in SERVE_CASES for d in (f32, bf16)
                  if not (d == bf16 and c in BF16_PROBABILITIES)]


class _Routing:
    """While active, records each MoE call's router probabilities (G, T, E)
    and its own expert choices (G, T, k), on the host (``moe._top_k``
    wrapped). With ``forced``, the choices of an earlier run, call by call,
    each call routes by those choices instead of its own, its gates read
    from its own probabilities at them."""

    def __init__(self, forced=None):
        self.forced = forced

    def __enter__(self):
        from repro_torch.models import moe

        self.calls, self._orig = [], moe._top_k
        forced = None if self.forced is None else iter(self.forced)

        def recorded(probs, k):
            vals, idx = self._orig(probs, k)
            self.calls.append((probs.cpu(), idx.cpu()))
            if forced is not None:
                idx = next(forced).to(probs.device)
                vals = torch.gather(probs, -1, idx.long())
            return vals, idx

        moe._top_k = recorded
        return self.calls

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe._top_k = self._orig


def _flips(card_routes, cpu_routes, tol):
    """The MoE calls' routing flips, card against CPU: (call, token, card's
    choices, CPU's). Each must be a tie within ``tol``: at every choice
    where the two differ, the two experts' router logits (log-probabilities
    up to a constant) lie within ``tol`` of each other on both sides."""
    flips = []
    for i, ((pa, a), (pb, b)) in enumerate(zip(card_routes, cpu_routes)):
        la, lb = torch.log(pa), torch.log(pb)
        for g, t in torch.nonzero((a != b).any(-1)).tolist():
            flips.append((i, t, a[g, t].tolist(), b[g, t].tolist()))
            for ea, eb in zip(a[g, t].long().tolist(), b[g, t].long().tolist()):
                if ea == eb:
                    continue
                for logit in (la[g, t], lb[g, t]):
                    bar = tol["atol"] + tol["rtol"] * max(abs(logit[ea]), abs(logit[eb]))
                    assert abs(logit[ea] - logit[eb]) <= bar, (
                        f"MoE call {i}, token {t}: routing flip card "
                        f"{a[g, t].tolist()} vs cpu {b[g, t].tolist()}, not a tie: "
                        f"router logits {logit[ea]:.4f} and {logit[eb]:.4f}")
    return flips


def _card_against_cpu(cfg, params, tokens, stub, dtype, plain=()):
    """Forced serving on the card (the kernels in ``plain`` run as their
    plain versions) against the CPU's plain versions, within ``serve_tol``.
    An MoE config's card run routes by the CPU run's choices, call by call,
    and records its own: where they differ (a routing flip) the two
    experts' router logits must tie within ``serve_tol`` on both sides, and
    the flips are printed; a flip is never left to the logits' bar."""
    with _Routing() as cpu_routes:
        cpu = chip_smoke.serve_forced(cfg, _cpu(params), tokens.cpu(), 64, 80, dtype,
                                      **{key: x.cpu() for key, x in stub.items()})
    on_card = ops._on_card
    ops._on_card = lambda t, what: False if what in plain else on_card(t, what)
    try:
        with _Routing(forced=[idx for _, idx in cpu_routes]) as card_routes:
            card = chip_smoke.serve_forced(cfg, params, tokens, 64, 80, dtype,
                                           **stub)
    finally:
        ops._on_card = on_card
    assert len(card_routes) == len(cpu_routes) == \
        (1 + chip_smoke.FP32_DECODE_STEPS) * cfg.n_layers * cfg.is_moe
    tol = chip_smoke.serve_tol(cfg, dtype)
    flips = _flips(card_routes, cpu_routes, tol)
    if flips:
        print(f"{cfg.name} {dtype}: {len(flips)} routing flips, each a tie of "
              f"router logits within {tol}: {flips}")
    torch.testing.assert_close(card.cpu().float(), cpu.float(), **tol)


@pytest.mark.parametrize("case, dtype", CARD_CPU_CASES,
                         ids=[f"{c}-dtype{int(d == bf16)}" for c, d in CARD_CPU_CASES])
def test_serve_on_the_card_matches_the_cpu(gen, case, dtype):
    """Prefill and forced decode steps through the kernels on the card
    against the plain versions on the CPU, on the same params and tokens,
    within ``serve_tol``: only forced tokens, since one greedy token that
    differs makes every later step differ."""
    _card_against_cpu(*_served(case), dtype)


@pytest.mark.parametrize("case", BF16_PROBABILITIES)
def test_serve_bf16_matches_the_cpu_with_plain_attention(gen, case):
    """bf16 serving of ``BF16_PROBABILITIES`` on the card with the attention
    as its plain version (the other kernels as they run): within bf16
    ``_tol`` of the CPU."""
    _card_against_cpu(*_served(case), bf16, plain=("flash_attention",))


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_launches_each_layer_once_per_step(gen, arch):
    """The serving launcher's ``generate`` on the card launches each layer's
    kernel once in the prefill and once per decode step (Zamba2's attention
    once per application of its shared block), and a decode past a KV cache
    raises."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model

    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    prompts = torch.randint(0, cfg.vocab, (2, 16), generator=gen, device="cuda")
    stub = {key: torch.from_numpy(x).cuda()
            for key, x in chip_smoke.stub_for(cfg, 2, np.random.default_rng(1)).items()}
    ops.reset_launches()
    run = generate(model, params, prompts, 5, stream=True, **stub)
    assert ops.launches == chip_smoke.serve_launches(cfg, 5)
    assert run.tokens.shape == (2, 5) and len(run.step_ms) == 4
    window = generate(model, params, prompts, 5, **stub)
    assert torch.equal(window.tokens, run.tokens) and window.step_ms == []
    if cfg.family != "ssm":
        batch = {"tokens": prompts, **stub}
        _, cache = model.prefill(params, batch, max_len=16)
        end = 16 + chip_smoke.prefix_rows(cfg)
        with pytest.raises(ValueError, match="KV cache overflow"):
            model.decode_step(params, {"tokens": run.tokens[:, :1], "pos": end,
                                       "cache": cache})


def test_q8_on_the_card_matches_the_cpu(gen):
    """adamw8bit's ``_q8`` / ``_dq8_static`` on TinyLlama's embedding shape
    on the card, bit for bit as on the CPU (``chip_smoke.check_q8``)."""
    assert chip_smoke.check_q8(gen) == 0.0


def test_gemma2_cut_serves_at_full_width(gen):
    """gemma2-27b at full width on its 2-layer cut (one local, one global
    layer) through ``generate`` on the card: each layer's attention once in
    the prefill and once per decode step, finite logits."""
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model

    cfg = chip_smoke.gemma2_cut()
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    prompts = torch.randint(0, cfg.vocab, (2, 32), generator=gen, device="cuda")
    ops.reset_launches()
    run = generate(model, params, prompts, 4, keep_logits=True)
    assert ops.launches == chip_smoke.serve_launches(cfg, 4)
    assert run.tokens.shape == (2, 4)
    assert all(bool(torch.isfinite(x).all()) for x in run.logits)


def _tied_router_probs(gen, T, E):
    """Softmax of router logits rounded to bf16 (as ``moe_sublayer`` makes
    them), on the card, with exact ties planted at the top-1/top-2 boundary
    in a third of the rows and at the top-2/top-3 boundary in another."""
    logits = torch.randn((T, E), generator=gen, device="cuda").bfloat16().float()
    order = torch.argsort(logits, dim=-1, descending=True, stable=True)
    rows = torch.arange(T, device="cuda")
    a, b = rows[:T // 3], rows[T // 3:2 * T // 3]
    logits[a, order[a, 1]] = logits[a, order[a, 0]]
    logits[b, order[b, 2]] = logits[b, order[b, 1]]
    return torch.softmax(logits, dim=-1)


@pytest.mark.parametrize("E", [8, 128])
def test_moe_top_k_on_the_card_equals_the_cpu(gen, E):
    """``moe._top_k`` (the stable descending sort, ``lax.top_k``'s tie
    order, tests/test_torch_moe.py) on the card: the same experts, in the
    same order, and the same values as on the CPU, on 8,192 rows of
    bf16-rounded router probabilities with planted ties."""
    from repro_torch.models import moe

    probs = _tied_router_probs(gen, 8192, E)
    vals, idx = moe._top_k(probs, 2)
    cvals, cidx = moe._top_k(probs.cpu(), 2)
    assert idx.dtype == torch.int32 and torch.equal(idx.cpu(), cidx)
    assert torch.equal(vals.cpu(), cvals)


@pytest.mark.parametrize("case", ["random", "all on one expert"])
def test_moe_dispatch_indices_on_the_card_equal_the_cpu(gen, case):
    """``moe._dispatch_indices`` at Arctic's E = 128, k = 2, T = 8,192 on
    the card: experts, slots and keeps equal the CPU's (``==``), at the
    capacity the serving prefill gets; every token on one expert overflows
    it."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    T, E, k = 8192, 128, 2
    if case == "random":
        idx = torch.argsort(torch.rand((T, E), generator=gen, device="cuda"),
                            dim=-1)[:, :k].to(torch.int32)
    else:
        idx = torch.stack([torch.zeros(T, dtype=torch.int32, device="cuda"),
                           torch.ones(T, dtype=torch.int32, device="cuda")], dim=1)
    C = moe._capacity(T, get_config("arctic-480b"))
    got = moe._dispatch_indices(idx, E, C)
    want = moe._dispatch_indices(idx.cpu(), E, C)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b)
    if case != "random":
        assert int((~got[2]).sum()) == 2 * (T - C)


# ---------------------------------------------------------------------------
# Sharding on the card: a one-rank DeviceMesh and the trainer's layouts.
# ---------------------------------------------------------------------------


@pytest.fixture
def one_rank_mesh():
    """A one-rank NCCL process group (``HashStore``) and the (1, 1) mesh."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist

    from repro_torch.core.plans import ParallelismPlan
    from repro_torch.launch.mesh import mesh_from_plan

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield mesh_from_plan(ParallelismPlan((1, 1), ("data", "model")))
    finally:
        dist.destroy_process_group()


def test_one_rank_device_mesh_round_trip(one_rank_mesh):
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.models import sharding as SH
    from repro_torch.models.shardctx import activation_sharding, constrain

    dm = one_rank_mesh.device_mesh()
    assert dm.device_type == "cuda" and dm.mesh_dim_names == ("data", "model")
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((64, 48), generator=gen, device="cuda")
    for spec in (SH.P(), SH.P("data", "model"), SH.P(("data", "model"))):
        dt = distribute_tensor(x, dm, SH.placements(spec, dm.mesh_dim_names))
        assert torch.equal(dt.to_local(), x) and torch.equal(dt.full_tensor(), x)
    act = torch.randn((4, 16, 32), generator=gen, device="cuda").to(torch.bfloat16)
    with activation_sharding(one_rank_mesh):
        y = constrain(distribute_tensor(act, dm, SH.placements(SH.P(), ("data", "model"))),
                      "batch", None, "model")
    assert isinstance(y, DTensor) and torch.equal(y.full_tensor(), act)


@pytest.mark.parametrize("tp", [2, 4])
def test_local_state_views_of_full_tinyllama(gen, tp):
    """TinyLlama's full train state under the trainer's tp layout over 4
    logical devices: every device's blocks are views of the state, and they
    reassemble it bit for bit."""
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.elastic import ElasticTrainer
    from repro_torch.models import build_model

    trainer = ElasticTrainer(build_model(get_config("tinyllama-1.1b")), initial=4)
    trainer.init(gen)
    trainer.apply_reshard(tp)
    grid = trainer.mesh().devices
    assert grid.shape == (4 // tp, tp)
    blocks = {pos: T.leaves(trainer.local_state(grid[pos])) for pos in np.ndindex(*grid.shape)}
    ptrs = {leaf.untyped_storage().data_ptr() for leaf in T.leaves(trainer.state)}
    assert all(b.untyped_storage().data_ptr() in ptrs for bl in blocks.values() for b in bl)
    assert chip_smoke.reassembles(trainer.state, trainer.layout, blocks)
