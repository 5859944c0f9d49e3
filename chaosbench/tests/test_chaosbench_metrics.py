"""Each metric's reader on a hand-made run: its arithmetic, and nothing
where it finds nothing to read (a share of a roofline or a peak is never
0)."""
import json

import pytest

from chaosbench import yardstick as Y
from chaosbench.catalog import HERE, Catalog
from chaosbench.drivers.elastic_train import Run
from chaosbench.trace import Trace

BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
NAMES = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


def metric(name):
    return Catalog.load(HERE).metric(name)


def hand_run(trace=None):
    run = Run(cfg={"seq": 1024}, mix={}, flops=lambda rows: 1e12 * rows)
    run.window_s, run.setup_s = 2.0, 15.0
    run.steps = [{"n": 2, "rows": 8, "s": 0.25, "after_change": True},
                 {"n": 2, "rows": 8, "s": 0.25, "after_change": False},
                 {"n": 3, "rows": 12, "s": 0.5, "after_change": True}]
    run.events = [{"kind": "join", "s": 0.04, "changed": True},
                  {"kind": "join", "s": 0.06, "changed": True},
                  {"kind": "leave", "s": 0.001, "changed": True}]
    run.spans = {"plan_replication": [0.02, 0.03], "roundtrip_check": [0.01],
                 "replica_push": [0.1, 0.3]}
    run.state_numels = [1000, 256]
    run.calls = {"attention": [(8, 1024, 1024, 12, 12, 64, "causal", 0, 0, 0, 2)],
                 "encode": [[1000, 256]], "decode": [[1000, 256]]}
    run.trace = trace
    return run


def test_end_to_end_by_hand():
    run = hand_run()
    assert metric("train_tokens_per_s").read(run) == pytest.approx(28 * 1024 / 2.0)
    assert metric("scaleout_ms").read(run) == pytest.approx(50.0)
    assert metric("step_ms_p95").read(run) == pytest.approx(500.0)
    assert metric("setup_s").read(run) == 15.0


def test_per_layer_by_hand():
    trace = Trace(window_s=2.0, busy_s=1.5,
                  device={"void flash_attention_wgmma_kernel<64>(x)": (0.001, 2),
                          "gemm": (0.9, 10), "shard_encode_kernel(y)": (0.0001, 1),
                          "shard_decode_kernel(z)": (0.0001, 1)},
                  ranges={"flash_attention_plain_backward": (0.45, 4)})
    run = hand_run(trace)
    assert metric("step_after_change_ms").read(run) == pytest.approx(375.0)
    assert metric("plan_ms").read(run) == pytest.approx(25.0)
    assert metric("roundtrip_check_ms").read(run) == pytest.approx(10.0)
    assert metric("replica_push_ms").read(run) == pytest.approx(200.0)
    assert metric("step_mfu").read(run) == pytest.approx(
        100 * 28e12 / 1.0 / Y.PEAK_BF16_FLOPS)
    assert metric("device_idle_share").read(run) == pytest.approx(25.0)
    assert metric("attn_plain_bwd_share").read(run) == pytest.approx(100 * 0.45 / 0.9012)
    flops, nbytes = Y.attention(8, 1024, 1024, 12, 12, 64, 1024 * 1025 // 2)
    assert metric("attention_roofline").read(run) == pytest.approx(
        100 * max(flops / Y.PEAK_BF16_FLOPS, nbytes / Y.PEAK_BYTES_PER_S) / 0.001)
    codec = 2 * (4 * 1256 + 5 * 256 + 4 * 5) / Y.PEAK_BYTES_PER_S
    assert metric("codec_roofline").read(run) == pytest.approx(100 * codec / 0.0002)


@pytest.mark.parametrize("name", NAMES)
def test_nothing_to_read_gives_nothing(name):
    if name == "setup_s":
        pytest.skip("every run has a set-up")
    run = Run(cfg={"seq": 1024}, mix={}, flops=lambda rows: 0.0)
    assert metric(name).read(run) is None
    run.trace = Trace(window_s=1.0, busy_s=0.0)
    assert metric(name).read(run) is None
