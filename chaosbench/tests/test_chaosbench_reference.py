"""The plain reference: hand-worked cases at tiny sizes, and the program's
own forward in float32 on the CPU (its plain attention), which the
reference has to equal to rounding in loss and gradients."""
import math

import pytest
import torch

from chaosbench.catalog import HERE, Catalog
from chaosbench.reference import common as C
from tiny import tiny_config


def test_layernorm_by_hand():
    x = torch.tensor([[1.0, 2.0, 3.0, 6.0]])
    p = {"scale": torch.tensor([0.0, 1.0, 0.0, 0.0]), "bias": torch.tensor([0.0, 0.0, 1.0, 0.0])}
    y = C.layernorm(x, p, 0.0)
    # mean 3, deviations (-2, -1, 0, 3), variance 3.5; gains (1, 2, 1, 1)
    s = math.sqrt(3.5)
    assert torch.allclose(y, torch.tensor([[-2 / s, -2 / s, 1.0, 3 / s]]), atol=1e-6)


def test_attention_by_hand():
    # One head of width 2; identity projections; two positions.
    eye = torch.eye(2)
    p = {"wq": eye, "wk": eye, "wv": eye, "wo": eye}
    h = torch.tensor([[[1.0, 0.0], [0.0, 1.0]]])
    causal = C.attention(h, h, p, 1, True, C.Precision())
    w = torch.softmax(torch.tensor([0.0, 1.0]) / math.sqrt(2), 0)
    assert torch.allclose(causal[0, 0], torch.tensor([1.0, 0.0]))
    assert torch.allclose(causal[0, 1], w[0] * h[0, 0] + w[1] * h[0, 1], atol=1e-6)
    full = C.attention(h, h, p, 1, False, C.Precision())
    w0 = torch.softmax(torch.tensor([1.0, 0.0]) / math.sqrt(2), 0)
    assert torch.allclose(full[0, 0], w0[0] * h[0, 0] + w0[1] * h[0, 1], atol=1e-6)


def test_uniform_logits_lose_log_v():
    x = torch.zeros(1, 3, 4)
    table = torch.randn(10, 4)
    assert C.nll_sum(x, table, torch.tensor([[1, 2, 3]]), C.Precision()) == pytest.approx(
        3 * math.log(10), rel=1e-6)


def test_first_adamw_step_by_hand():
    """At step 1 Adam's update is the gradient's sign (to eps), plus the
    decay: p - lr * (sign(g) + wd * p), with the gradient clipped first."""

    class Line:
        @staticmethod
        def positions(cfg):
            return 1

        @staticmethod
        def loss_sum(cfg, p, batch, prec):
            return (p["w"] * batch["tokens"][:, 0].float()).sum()

    cfg = {"arch": {"learning_rate": 0.1, "weight_decay": 0.5, "grad_clip": 1.0},
           "optimizer": {"b1": 0.9, "b2": 0.95, "eps": 0.0}}
    w0 = torch.tensor([1.0, -2.0])
    out = C.train(Line, cfg, {("w",): w0}, [{"tokens": torch.tensor([[3], [-1]])}])
    # loss (1 * 3 + -2 * -1) / 2 rows; gradient (1.5, -0.5), of norm 1.58,
    # clipped to norm 1; Adam's first update its sign (1, -1)
    assert out["losses"] == [pytest.approx(2.5)]
    assert out["grad_norms"][("w",)] == pytest.approx(1.0)
    moved = torch.tensor([1.0 - 0.1 * (1 + 0.5), -2.0 - 0.1 * (-1 - 1.0)])
    assert out["change_norms"][("w",)] == pytest.approx(float(torch.linalg.vector_norm(moved - w0)))


def test_fp8_control_rounds_products():
    x = torch.tensor([1.0, 1.0 / 3.0, 0.1, 448.0])
    q = C.fp8(x)
    assert q[3] == 448.0 and q[0] == 1.0 and q[1] != x[1]
    assert torch.allclose(q, x, rtol=2 ** -4)
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(2, 3, 5, generator=gen, requires_grad=True)
    b = torch.randn(5, 4, generator=gen, requires_grad=True)
    out = C.Precision("fp8").mm(a, b)
    assert torch.allclose(out, a @ b, rtol=0.2, atol=0.2) and not torch.equal(out, a @ b)
    out.sum().backward()
    assert a.grad.shape == a.shape and b.grad.shape == b.shape
    assert torch.allclose(b.grad, a.detach().sum((0, 1))[:, None].expand(5, 4), rtol=0.3, atol=0.3)


def program_loss_and_grads(cfg, params, batch):
    """The program's loss in float32 (its plain attention on the CPU) and
    the gradients of its params."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import transformer, whisper

    arch = dict(cfg["arch"])
    pcfg = dataclasses.replace(get_config(arch.pop("base")), **arch)
    live = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    tree = C.nest(live)
    tokens = batch["tokens"]
    if cfg["family"] == "encdec":
        hidden, _ = whisper.forward(pcfg, tree, tokens[:, :-1], frames=batch["frames"].float(),
                                    return_hidden=True, dtype=torch.float32)
    else:
        hidden, _ = transformer.forward(pcfg, tree, tokens[:, :-1], return_hidden=True,
                                        dtype=torch.float32)
    loss = L.chunked_cross_entropy(tree["embed"], hidden, tokens[:, 1:], pcfg)
    grads = torch.autograd.grad(loss, [live[k] for k in sorted(live)])
    return float(loss.detach()), dict(zip(sorted(live), grads))


@pytest.mark.parametrize("config", ["gpt2", "whisper-small"])
def test_reference_is_the_programs_model(config):
    cfg = tiny_config(config)
    ref = Catalog.load(HERE).reference(cfg["family"])
    gen = torch.Generator().manual_seed(11)
    params = C.make_params(ref.specs(cfg), gen, "cpu")
    batch = ref.make_inputs(cfg, gen, 3, "cpu")
    want, want_grads = program_loss_and_grads(cfg, params, batch)
    live = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    count = batch["tokens"].shape[0] * ref.positions(cfg)
    got = ref.loss_sum(cfg, C.nest(live), batch, C.Precision()) / count
    got.backward()
    assert float(got) == pytest.approx(want, rel=1e-5)
    for k in sorted(live):
        assert torch.allclose(live[k].grad, want_grads[k], rtol=1e-4, atol=1e-7), k


@pytest.mark.parametrize("config", ["gpt2", "whisper-small"])
def test_state_tree_is_the_programs(config):
    """The benchmark's weights have the program's paths, shapes and dtypes."""
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer

    from chaosbench.drivers.elastic_train import check_state, program_config

    cfg = Catalog.load(HERE).config(config)
    ref = Catalog.load(HERE).reference(cfg["family"])
    params = C.nest({path: torch.empty(shape, device="meta")
                     for path, shape, _ in ref.specs(cfg)})
    arch = program_config(cfg)
    check_state({"params": params, "opt": make_optimizer(arch).init(params)},
                build_model(arch, "cpu").train_state_specs())


def test_model_flops_by_hand():
    cat = Catalog.load(HERE)
    gpt2 = cat.config("gpt2")
    per_token = 6 * (12 * (4 * 768 ** 2 + 2 * 768 * 3072) + 768 * 50257)
    attn = 12 * 768 * (1024 * 1025 // 2) * 12
    assert cat.reference("dense").train_flops(gpt2, 8) == 8 * (1024 * per_token + attn)
    whisper = cat.config("whisper-small")
    flops = cat.reference("encdec").train_flops(whisper, 1)
    assert 1.55e12 < flops < 1.65e12  # about 1.6 TFLOP a sample
