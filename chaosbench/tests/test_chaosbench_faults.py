"""``correct`` comes out false when the timed path is broken underneath,
and true when it is not: tiny cells on the CPU, the look for a card
skipped (``bench.execute``), each fault planted in the program.

The faults a training cell can have: a step that returns its state
unchanged; half of the batch left out, the mean taken over the rest; an
answer altered where it is produced (a scale of the int8 encode, a byte
of a replica push). The controls: the reference put in the program's
place one precision below the configuration's, its products in float8 or
its parameters and moments in bfloat16. An exchange between cards has no
place to be left out: the trainer's logical devices share one card and one
state, and no collective runs.
"""
import time

import pytest
import torch

from chaosbench import bench
from chaosbench.catalog import Catalog
from chaosbench.reference import common as C
from tiny import make_checkout

SEED = 2**31 + 77


@pytest.fixture(scope="module")
def cat(tmp_path_factory):
    return Catalog.load(make_checkout(tmp_path_factory.mktemp("checkout")))


def run(cat, cell="tiny-gpt2.tiny-churn_stress", seconds=1.0):
    return bench.execute(cat, cell, SEED, seconds, False, time.perf_counter(), device="cpu")


def failed(result):
    return sorted(k for k, c in result["checks"].items() if c["value"] > c["limit"])


@pytest.mark.parametrize("cell", ["tiny-gpt2.tiny-churn_stress", "tiny-whisper-small.tiny-churn_stress",
                                  "tiny-gpt2.tiny-steady"])
def test_sound_runs_are_correct(cat, cell):
    result = run(cat, cell, seconds=4.0)  # long enough for a join in the window
    assert result["correct"], result["checks"]
    if "steady" not in cell:
        assert {"codec_mismatch", "push_mismatch", "join_state_mismatch"} <= set(result["checks"])


def _patch_step(monkeypatch, make):
    from repro_torch.models import model_api

    orig = model_api.Model.make_train_step
    monkeypatch.setattr(model_api.Model, "make_train_step", lambda self: make(self, orig(self)))


def test_state_left_unchanged_fails(cat, monkeypatch):
    def make(model, step):
        def unchanged(state, batch):
            with torch.no_grad():
                loss, _ = model.loss_fn(state["params"], batch)
            return state, {"loss": loss}
        return unchanged
    _patch_step(monkeypatch, make)
    result = run(cat)
    assert not result["correct"] and {"grad_diff", "change_gap"} <= set(failed(result))


def test_half_the_batch_fails(cat, monkeypatch):
    def make(model, step):
        return lambda state, batch: step(state, {k: v[:v.shape[0] // 2] for k, v in batch.items()})
    _patch_step(monkeypatch, make)
    assert not run(cat)["correct"]


@pytest.mark.parametrize("precision,kept,fails", [("fp8", torch.float32, "grad_diff"),
                                                   ("fp32", torch.bfloat16, "change_gap")])
def test_control_in_the_programs_place_fails(cat, monkeypatch, precision, kept, fails):
    """The reference one precision below the configuration's, as the
    program: products in float8, or parameters and moments in bfloat16."""
    cfg = cat.config("tiny-gpt2")
    ref = cat.reference(cfg["family"])
    hp = C.hyper(cfg)

    def make(model, step):
        def control(state, batch):
            flat = dict(C.flat_items(state["params"]))
            live = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
            count = batch["tokens"].shape[0] * ref.positions(cfg)
            loss = ref.loss_sum(cfg, C.nest(live), batch, C.Precision(precision)) / count
            loss.backward()
            opt = state["opt"]
            opt["step"].add_(1)
            t = int(opt["step"])
            with torch.no_grad():
                norm = torch.sqrt(sum(torch.sum(torch.square(x.grad)) for x in live.values()))
                scale = torch.clamp(hp["clip"] / torch.clamp(norm, min=1e-9), max=1.0)
                m, v = dict(C.flat_items(opt["m"])), dict(C.flat_items(opt["v"]))
                for k, p in flat.items():
                    g = live[k].grad * scale
                    m[k].mul_(hp["b1"]).add_((1 - hp["b1"]) * g)
                    v[k].mul_(hp["b2"]).add_((1 - hp["b2"]) * torch.square(g))
                    u = (m[k] / (1 - hp["b1"] ** t)) / (
                        torch.sqrt(v[k] / (1 - hp["b2"] ** t)) + hp["eps"]) + hp["wd"] * p
                    p.sub_(hp["lr"] * u)
                    for x in (p, m[k], v[k]):
                        x.copy_(x.to(kept).float())
            return state, {"loss": loss.detach()}
        return control
    _patch_step(monkeypatch, make)
    result = run(cat)
    assert not result["correct"] and fails in failed(result)


def test_altered_encode_fails(cat, monkeypatch):
    """One scale of every encode one ulp up: inside the program's own
    round-trip bound, outside the exact comparison."""
    from repro_torch.kernels import ops

    orig = ops.shard_encode_many

    def altered(leaves):
        codes, scales, firsts = orig(leaves)
        scales[0] = torch.nextafter(scales[0], torch.tensor(float("inf")))
        return codes, scales, firsts
    monkeypatch.setattr(ops, "shard_encode_many", altered)
    result = run(cat)
    assert failed(result) == ["codec_mismatch"]


def test_altered_push_fails(cat, monkeypatch):
    from repro_torch.checkpoint import memory_ckpt

    orig = memory_ckpt.extract_shards

    def altered(buf, ranges):
        shards = orig(buf, ranges)
        first = min(shards)
        shards[first][0] ^= 1
        return shards
    monkeypatch.setattr(memory_ckpt, "extract_shards", altered)
    result = run(cat)
    assert failed(result) == ["push_mismatch"]
