"""The attention backward's CPU-side parts: the query range the dK/dV kernel
walks (``admitted_queries``, the mirror of ``q_range`` in
``csrc/attention_bwd.cuh``) against a brute-force mask, the choice of
backward (``backward_regime``), the yardstick of its work, the wrapper's
refusals, and CPU calls keeping the plain backward bit for bit."""
import importlib.util
import pathlib
import threading

import pytest
import torch

from repro_torch import spans
from repro_torch.kernels import cost
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models.layers import MaskSpec, _mask_block

SQ, SKV = 130, 300
#: (kind, window, prefix_len, q_offset)
MASKS = [(kind, window, prefix, q_offset)
         for kind, prefix in (("causal", 0), ("full", 0), ("prefix", 40), ("prefix", 100))
         for window in (0, 16, 64)
         for q_offset in (0, 37, 170)
         if not (kind == "full" and (window or q_offset))]


def _admitted(kind, window, prefix, q_offset):
    """(Sq, Skv) bool: which pairs the mask admits, as ``attention_plain``
    masks them."""
    pos = q_offset + torch.arange(SQ, dtype=torch.int32)
    return _mask_block(MaskSpec(kind, window=window, prefix_len=prefix), pos,
                       torch.arange(SKV, dtype=torch.int32))


@pytest.mark.parametrize("kind, window, prefix, q_offset", MASKS)
def test_admitted_queries_cover_every_admitted_pair(kind, window, prefix, q_offset):
    """Every key block of the dK/dV kernel (128 keys) and every single key:
    each query the mask admits for a key of the block lies in the range;
    for one key the range is exactly the admitted queries (an interval),
    or empty when there are none."""
    mask = _admitted(kind, window, prefix, q_offset)
    for k_start, rows in [(k, 128) for k in range(0, SKV, 128)] + [(k, 1) for k in range(SKV)]:
        lo, hi = fa.admitted_queries(kind, window, prefix, SQ, SKV, q_offset, k_start, rows)
        assert 0 <= lo <= hi <= SQ
        rows_hit = mask[:, k_start:k_start + rows].any(dim=1).nonzero().flatten().tolist()
        assert all(lo <= i < hi for i in rows_hit), (k_start, rows, lo, hi)
        if rows == 1:
            want = (rows_hit[0], rows_hit[-1] + 1) if rows_hit else None
            assert rows_hit == list(range(*want)) if want else lo == hi, (k_start, lo, hi)
            if want:
                assert (lo, hi) == want, (k_start, lo, hi, want)


def test_admitted_queries_turn_admitted_keys_around():
    """Ranges worked by hand at the training paths' shapes: a causal key
    block admits the rows from its first key on (under a window, to its
    last key's window), a prefix block every row, queries past a block's
    keys none."""
    assert fa.admitted_queries("causal", 0, 0, 1024, 1024) == (0, 1024)
    assert fa.admitted_queries("causal", 0, 0, 1024, 1024, 0, 896, 128) == (896, 1024)
    assert fa.admitted_queries("causal", 64, 0, 448, 448, 0, 128, 128) == (128, 319)
    assert fa.admitted_queries("full", 0, 0, 448, 1500, 0, 1408, 128) == (0, 448)
    assert fa.admitted_queries("prefix", 0, 256, 1280, 1280, 0, 128, 128) == (0, 1280)
    assert fa.admitted_queries("prefix", 0, 256, 1280, 1280, 0, 384, 128) == (384, 1280)
    assert fa.admitted_queries("causal", 0, 0, 4, 1152, 100, 0, 64) == (0, 4)
    assert fa.admitted_queries("causal", 0, 0, 4, 1152, 100, 128, 64) == (4, 4)


@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
def test_backward_regime(dtype, hd):
    want = "wgmma" if dtype == torch.bfloat16 and hd != 256 else "plain"
    assert fa.backward_regime(dtype, hd) == want
    assert (hd in fa.BWD_HEAD_DIMS) == (hd != 256)


def test_backward_yardstick_at_gpt2():
    """10·hd operations a pair and head: 48.4 GFLOP for GPT-2's layer at
    batch 12, 49 µs at 989 TFLOP/s; 152.2 MB, 45 µs at 3.35 TB/s."""
    pairs = cost.admitted_pairs("causal", 0, 0, 1024, 1024)
    flops, nbytes = cost.attention_bwd(12, 1024, 1024, 12, 12, 64, pairs)
    assert flops == 10 * 12 * 12 * 64 * 1024 * 1025 // 2 == 48_365_568_000
    assert nbytes == 2 * 8 * 12 * 1024 * 12 * 64 + 8 * 12 * 12 * 1024 == 152_174_592
    fwd_flops, _ = cost.attention(12, 1024, 1024, 12, 12, 64, pairs)
    assert flops == 2.5 * fwd_flops


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind, window, prefix, q_offset",
                         [("causal", 0, 0, 0), ("causal", 24, 0, 16), ("prefix", 0, 40, 0),
                          ("full", 0, 0, 0)])
def test_cpu_calls_keep_the_plain_backward(dtype, kind, window, prefix, q_offset, monkeypatch):
    """On CPU tensors the backward is the autograd of ``attention_plain``,
    bit for bit, inside its span; nothing writes a log-sum-exp and no
    backward launch is counted."""
    asked = []
    monkeypatch.setattr(fa, "writing_lse", lambda lse: asked.append(lse))
    gen = torch.Generator().manual_seed(5)
    q = torch.randn((2, 96, 4, 32), generator=gen).to(dtype)
    k, v = (torch.randn((2, 112, 2, 32), generator=gen).to(dtype) for _ in range(2))
    g = torch.randn((2, 96, 4, 32), generator=gen).to(dtype)
    spec = MaskSpec(kind, window=window, prefix_len=prefix)
    live = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ops.reset_launches()
    spans.drain()
    spans.enable()
    try:
        ops.flash_attention(*live, spec, scale=0.2, softcap=20.0, q_offset=q_offset).backward(g)
    finally:
        spans.disable()
    names = [r.name for r in spans.drain()]
    fa.attention_plain(*ref, spec, scale=0.2, softcap=20.0, q_offset=q_offset).backward(g)
    for a, b in zip(live, ref):
        assert torch.equal(a.grad, b.grad)
    assert names == [ops.BACKWARD_RANGES[0]]
    assert not asked and ops.launches["flash_attention_bwd"] == 0


def test_backward_kernel_refuses_what_it_does_not_take():
    x = torch.zeros((1, 64, 2, 64), dtype=torch.bfloat16)
    lse = torch.zeros((1, 2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd_kernel(x, x, x, x, lse, x, scale=0.125)


def test_writing_lse_is_cleared_after_the_block():
    lse = torch.zeros((1, 2, 3))
    with pytest.raises(RuntimeError):
        with fa.writing_lse(lse) as got:
            assert got is lse and fa.lse_target() is lse
            raise RuntimeError("leave the block")
    assert fa.lse_target() is None


def test_writing_lse_holds_only_for_the_calling_thread():
    """A forward on another thread (a server beside the trainer) writes no
    log-sum-exp into the training call's tensor; nested blocks restore the
    outer one."""
    outer, inner = torch.zeros((1, 2, 3)), torch.zeros((1, 2, 4))
    seen = []
    with fa.writing_lse(outer):
        worker = threading.Thread(target=lambda: seen.append(fa.lse_target()))
        worker.start()
        worker.join(timeout=10)
        assert not worker.is_alive()
        with fa.writing_lse(inner):
            assert fa.lse_target() is inner
        assert fa.lse_target() is outer
    assert seen == [None] and fa.lse_target() is None


def _load_chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_backward_cases_cover_the_benchmark_and_main_paths():
    """``chip_smoke`` holds the backward at the benchmark's GPT-2 layer and
    Whisper's three shapes (also the timed ones) and at every main path's
    bf16 shape whose head dim the kernels take, and at no other."""
    cs = _load_chip_smoke()
    cases = cs.attention_bwd_cases()
    timed = cs.attention_bwd_cases(paths=False)
    assert cases[:len(timed)] == timed
    assert [case[:7] for _, case, _ in timed] == [
        (12, 1024, 1024, 12, 12, 64, "causal"), (8, 1500, 1500, 12, 12, 64, "full"),
        (8, 448, 448, 12, 12, 64, "causal"), (8, 448, 1500, 12, 12, 64, "full")]
    hds = {case[5] for _, case, _ in cases}
    assert hds == {64, 112, 128} and hds <= set(fa.BWD_HEAD_DIMS)
    paths = {label.split(" B=")[0] for label, _, _ in cases[len(timed):]}
    assert paths == {name for name, (_, _, _, _, hd, *_) in cs.main_shapes()["flash_attention"]
                     if fa.backward_regime(torch.bfloat16, hd) == "wgmma"}
    assert "paligemma-3b" not in paths  # hd 256 keeps the plain backward
    assert all(case[-1] == torch.bfloat16 for _, case, _ in cases)
