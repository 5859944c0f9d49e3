"""``attention_bwd_roofline`` on hand-made runs: its yardstick and its
arithmetic, nothing where it finds nothing to read, and no hook against a
program without the backward kernels."""
import json

import pytest

from chaosbench import yardstick as Y
from chaosbench.catalog import HERE, Catalog
from chaosbench.drivers.elastic_train import Run
from chaosbench.trace import Trace

NAME = "attention_bwd_roofline"
GPT2 = (12, 1024, 1024, 12, 12, 64, "causal", 0, 0, 0, 2)


def metric():
    return Catalog.load(HERE).metric(NAME)


def run_with(calls, device):
    run = Run(cfg={"seq": 1024}, mix={}, flops=lambda rows: 0.0)
    run.calls = {"attention_bwd": calls}
    run.trace = Trace(window_s=1.0, busy_s=0.5, device=device)
    return run


def test_entry():
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    entry = next(m for m in bench["per_layer"] if m["name"] == NAME)
    assert entry == {"name": NAME, "unit": "%", "better": "higher", "source": "device_trace",
                     "layer": "kernels", "moves": "train_tokens_per_s",
                     "workloads": [w["name"] for w in bench["workloads"]]}


def test_yardstick_at_gpt2():
    """GPT-2's layer at batch 12: 10·hd operations on each of 12 heads'
    524,800 admitted pairs (48.4 GFLOP, 49 µs at the bf16 peak) against
    8 · 12·1024·12·64 bf16 elements and 2 · 12·12·1024 fp32 rows (152.2 MB,
    45 µs): bound by the operations. The program's ``kernels.cost`` counts
    the same."""
    from repro_torch.kernels import cost

    pairs = Y.admitted_pairs("causal", 0, 0, 1024, 1024)
    assert pairs == 1024 * 1025 // 2
    flops, nbytes = metric().cost(12, 1024, 1024, 12, 12, 64, pairs)
    assert flops == 10 * 12 * 12 * 64 * pairs
    assert nbytes == 2 * 8 * 12 * 1024 * 12 * 64 + 4 * 2 * 12 * 12 * 1024
    assert Y.bound_s(flops, nbytes, Y.PEAK_BF16_FLOPS) == pytest.approx(
        flops / Y.PEAK_BF16_FLOPS)
    assert cost.attention_bwd(12, 1024, 1024, 12, 12, 64, pairs) == (flops, nbytes)


@pytest.mark.parametrize("calls, kernels", [([GPT2], 1), ([GPT2, GPT2], 2)])
def test_reads_the_backward_kernels_only(calls, kernels):
    device = {"void repro_fa::attn_bwd_dkdv_kernel<64>(repro_fa::BwdTensors)": (0.0003, kernels),
              "void repro_fa::attn_bwd_dq_kernel<64>(repro_fa::BwdTensors)": (0.0002, kernels),
              "void (anonymous namespace)::attn_bwd_prep_kernel(x)": (0.00001, kernels),
              "void (anonymous namespace)::flash_attention_wgmma_kernel<64>(y)": (0.01, 4),
              "gemm": (0.5, 10)}
    mod = metric()
    flops, nbytes = mod.cost(*GPT2[:6], Y.admitted_pairs("causal", 0, 0, 1024, 1024))
    want = 100 * len(calls) * Y.bound_s(flops, nbytes, Y.PEAK_BF16_FLOPS) / 0.00051
    assert mod.read(run_with(calls, device)) == pytest.approx(want)


def test_nothing_to_read():
    mod = metric()
    assert mod.read(run_with([], {"attn_bwd_dq_kernel": (0.1, 1)})) is None
    assert mod.read(run_with([GPT2], {"flash_attention_wgmma_kernel": (0.1, 1)})) is None
    run = run_with([GPT2], {"attn_bwd_dq_kernel": (0.1, 1)})
    run.trace = None
    assert mod.read(run) is None


def test_hooks_the_program_where_it_has_the_kernel():
    mod = metric()
    assert mod.CALLS == {"attention_bwd": (mod.TARGET, mod.shape)}
    assert not mod.present("repro_torch.kernels.flash_attention:no_such_kernel")
    assert not mod.present("no_such_module:flash_attention_bwd_kernel")
