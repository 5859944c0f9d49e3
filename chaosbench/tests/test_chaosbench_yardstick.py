"""The frozen copies agree with their originals today: the attention cost
and mask pairs (``repro_torch/kernels/cost.py``), the codec's bytes and
encode (``repro_torch/kernels/shard_codec.py``), the trace reader
(``chip_smoke.device_times``)."""
import importlib.util
import itertools

import pytest
import torch

from chaosbench import trace, yardstick
from chaosbench.catalog import HERE
from chaosbench.reference.common import encode

ROOT = HERE.parent


@pytest.mark.parametrize("kind,window,prefix", [
    ("full", 0, 0), ("causal", 0, 0), ("causal", 5, 0), ("causal", 64, 0),
    ("prefix", 0, 7), ("prefix", 5, 7), ("prefix", 16, 3), ("prefix", 2, 40)])
def test_admitted_pairs_and_attention_cost(kind, window, prefix):
    from repro_torch.kernels import cost

    for Sq, Skv, off in ((8, 8, 0), (1, 30, 12), (5, 40, 30), (64, 64, 0), (3, 64, 60),
                         (17, 9, 0), (448, 1500, 0), (1024, 1024, 0)):
        pairs = yardstick.admitted_pairs(kind, window, prefix, Sq, Skv, off)
        assert pairs == cost.admitted_pairs(kind, window, prefix, Sq, Skv, off)
        for itemsize in (2, 4):
            assert (yardstick.attention(2, Sq, Skv, 8, 2, 64, pairs, itemsize=itemsize)
                    == cost.attention(2, Sq, Skv, 8, 2, 64, pairs, itemsize=itemsize))


def test_codec_bytes_match_the_codec_layout():
    from repro_torch.kernels.shard_codec import shard_encode_many_plain

    leaves = [torch.randn(n) for n in (1, 255, 256, 257, 1000, 4096)]
    codes, scales, _ = shard_encode_many_plain(leaves)
    n = sum(x.numel() for x in leaves)
    assert yardstick.codec_bytes([x.numel() for x in leaves]) == (
        4 * n + codes.numel() * codes.element_size() + scales.numel() * 4)


def test_encode_is_the_codecs_bit_for_bit():
    from repro_torch.kernels.shard_codec import shard_encode_plain
    from repro_torch.optim.compression import int8_quantize

    gen = torch.Generator().manual_seed(3)
    x = torch.randn(5000, generator=gen) * 0.02
    x[:256] = torch.arange(256) / 127.0 * 3.0 - 1.5  # codes on the .5 ties
    x[256:512] = 0.0
    x[512] = 1e-20
    for leaf in (x, x[:300], x.reshape(50, 100)):
        codes, scales = encode(leaf)
        want_codes, want_scales = shard_encode_plain(leaf)
        assert torch.equal(codes, want_codes) and torch.equal(scales, want_scales)
        q_codes, q_scales, _ = int8_quantize(leaf)
        assert torch.equal(codes, q_codes) and torch.equal(scales, q_scales)


def test_encode_by_hand():
    codes, scales = encode(torch.tensor([0.0, 1.27, -0.635, 0.005]))
    assert scales.tolist() == [pytest.approx(0.01)]
    assert codes[0, :4].tolist() == [0, 127, -64, 0]  # -63.5 rounds to even
    assert codes.shape == (1, 256) and int(codes[0, 4:].abs().sum()) == 0


class Event:
    """The part of a profiler event that the readers call."""

    def __init__(self, name, device, start, dur, corr=0, linked=0):
        self._v = (name, device, start, dur, corr, linked)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]


def synthetic_events():
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ev = [Event(trace.WINDOW, cpu, 0, 1_000_000),
          Event("chaosbench.step", cpu, 10_000, 500_000),
          Event("chaosbench.step", cuda, 20_000, 300_000),  # a range's device marker
          Event("flash_attention_plain_backward", cpu, 100_000, 100_000),
          Event("chaosbench.event.join", cpu, 600_000, 300_000),
          Event("chaosbench.span.plan_replication", cpu, 610_000, 100_000)]
    corr = itertools.count(1)
    for start, name, dur, launch in ((20_000, "gemm", 50_000, 15_000),
                                     (120_000, "softmax", 30_000, 110_000),
                                     (150_000, "gemm", 40_000, 150_000),
                                     (400_000, "copy", 10_000, 300_000),
                                     (405_000, "copy", 10_000, 301_000),  # overlaps
                                     (750_000, "shard_encode_kernel", 100_000, 720_000)):
        c = next(corr)
        ev.append(Event("cudaLaunchKernel", cpu, launch, 1_000, corr=c))
        ev.append(Event(name, cuda, start, dur, linked=c))
    return ev


def test_trace_reader_matches_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_copy", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    ranges = ("flash_attention_plain_backward",)
    rows, smoke_ranges = smoke.device_times(synthetic_events(), ranges)
    t = trace.read(synthetic_events(), ranges)
    want = {name: (ms, n) for ms, n, name in rows if not name.startswith("chaosbench.")}
    assert sorted(t.device) == sorted(want)
    for name, (s, n) in t.device.items():
        assert (1e3 * s, n) == (pytest.approx(want[name][0]), want[name][1])
    assert sorted(t.ranges) == sorted(smoke_ranges)
    for name, (s, n) in t.ranges.items():
        assert (1e3 * s, n) == (pytest.approx(smoke_ranges[name][0]), smoke_ranges[name][1])
    # busy: [20, 70) + [120, 190) + [400, 415) + [750, 850) microseconds
    assert t.busy_s == pytest.approx((50 + 70 + 15 + 100) * 1e-6)
    assert t.window_s == pytest.approx(1e-3)
    # gaps by their middles: three inside the step, two outside any range
    assert t.idle["step"] == pytest.approx((20 + 50 + 210) * 1e-6)
    assert t.idle[trace.BETWEEN] == pytest.approx((335 + 150) * 1e-6)
    assert sum(t.idle.values()) == pytest.approx(t.window_s - t.busy_s)
    assert trace.breakdown(t)["device_ops"][0][0] == "shard_encode_kernel"
