"""Driver of the training cells: ``repro_torch``'s ``ElasticTrainer`` trained
under a churn mix, through ``ElasticTrainer.replay_scenario`` (``ChurnEngine``
→ ``TrainerBackend`` → ``step`` / ``scale_out`` / ``scale_in`` /
``apply_link_event`` / ``checkpoint``).

Set-up (timed as ``setup_s``, less the copies it keeps for the check):
the kernels built or loaded, the model and its weights made on the device
from the seed by the reference's own code (``reference/<family>.py``) and
installed with ``ElasticTrainer.init(state=...)``, a ring of distinct input
rows made on the device from the seed, then ``traffic.setup_slots``: one
step on each membership the window visits, the joins between them, a push
where the mix pushes, departures back to ``initial``. Those first three
steps are the ones the reference follows.

The window replays ``traffic.slots`` until ``--seconds`` have passed: the
harness times every step and every event itself, each closed by a
synchronize, and stops before the first step that would start after the
deadline.

After the window the program is freed and the reference runs: the three
set-up steps, the int8 encode of every set-up join and of one join of the
window (a seeded sample of its leaves), the set-up push and the window's
last push (the same sample), restored from the replica store. ``judge``
holds each number to its limit.
"""
from __future__ import annotations

import dataclasses
import gc
import random
import time

import torch

from chaosbench import judge, spans, traffic
from chaosbench.reference import common as C
from chaosbench.trace import WINDOW, breakdown
from chaosbench.trace import read as read_trace

#: leaves of the state the window's sampled join and pushes are checked on.
SAMPLE_LEAVES = 3
#: the window join checked is drawn among the first this many.
SAMPLE_JOINS = 4
OWNER = 0


class WindowClosed(Exception):
    """The deadline passed: the window ends before the next step."""


@dataclasses.dataclass
class Run:
    """What one run measured, as the metrics' readers read it."""
    cfg: dict
    mix: dict
    flops: object  # rows -> model FLOPs of one step
    setup_s: float = 0.0
    window_s: float = 0.0
    steps: list = dataclasses.field(default_factory=list)
    events: list = dataclasses.field(default_factory=list)
    spans: dict = dataclasses.field(default_factory=dict)
    calls: dict = dataclasses.field(default_factory=dict)
    trace: object = None
    breakdown: object = None
    #: numels of the fp32 leaves of the state a join encodes
    state_numels: list = dataclasses.field(default_factory=list)


def program_config(cfg: dict):
    """The program's config: its registered ``base`` with the file's
    ``arch`` values."""
    from repro_torch.configs import get_config

    arch = dict(cfg["arch"])
    return dataclasses.replace(get_config(arch.pop("base")), **arch)


def _signature(tree):
    return [(p, tuple(t.shape), t.dtype) for p, t in C.flat_items(tree)]


def check_state(state, specs) -> None:
    got, want = _signature(state), _signature(specs)
    if got != want:
        diff = next((g, w) for g, w in zip(got + [None] * len(want), want + [None] * len(got))
                    if g != w)
        raise ValueError(f"the benchmark's state differs from the program's: {diff}")


def host_copy(tree) -> dict:
    return {p: t.detach().to("cpu", copy=True) for p, t in C.flat_items(tree)}


class Recorder:
    """Times steps and events, feeds rows from the ring, and keeps what the
    check needs."""

    def __init__(self, trainer, data, run, device, traced, seed):
        self.trainer, self.data, self.run = trainer, data, run
        self.traced = traced
        self.cuda = device.type == "cuda"
        self.ring = data["tokens"].shape[0]
        self.pos = 0
        self.phase = "setup"
        self.deadline = None
        self.changed = False
        self.capture_s = 0.0
        self.t = 0.0
        # set-up: rows and losses of each step, the state after it (host),
        # each join's encode with the snapshot it encoded, the push restored
        self.step_rows, self.losses, self.snapshots = [], [], []
        self.joins, self.pushed = [], None
        # window: a seeded sample of leaves, and which join to check
        rng = random.Random(f"{seed}/sample")
        fp32 = [p for p, t in C.flat_items(trainer.state)
                if t.dtype == torch.float32 and t.numel()]
        self.sample = sorted(rng.sample(fp32, SAMPLE_LEAVES))
        self.join_pick = rng.randrange(SAMPLE_JOINS)
        self.window_joins = 0
        self.win_join, self.win_push = None, None
        self._capture = None

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def _leaves(self, paths):
        flat = dict(C.flat_items(self.trainer.state))
        return {p: flat[p].detach().clone() for p in paths}

    def _timed_capture(self, fn):
        self.sync()
        t0 = time.perf_counter()
        out = fn()
        self.sync()
        self.capture_s += time.perf_counter() - t0
        return out

    # -- the calls the harness wraps ------------------------------------------

    def batch(self) -> dict:
        """The next ``global_batch`` rows of the ring, in order."""
        gb = self.trainer.global_batch
        if self.pos + gb > self.ring:
            self.pos = 0
        start, self.pos = self.pos, self.pos + gb
        if self.phase == "setup":
            self.step_rows.append((start, gb))
        return {k: v[start:start + gb] for k, v in self.data.items()}

    def wrap_step(self, orig):
        def step(batch):
            if self.deadline is not None and time.perf_counter() >= self.deadline:
                raise WindowClosed
            n, rows = len(self.trainer.active), batch["tokens"].shape[0]
            with spans.label("step", self.traced):
                t0 = time.perf_counter()
                metrics = orig(batch)
                self.sync()
                dt = time.perf_counter() - t0
            if self.phase == "window":
                self.run.steps.append({"n": n, "rows": rows, "s": dt,
                                       "after_change": self.changed})
            elif self.phase == "setup":
                self.losses.append(metrics["loss"])
                self.snapshots.append(self._timed_capture(
                    lambda: host_copy(self.trainer.state)))
            self.changed = False
            return metrics
        return step

    def wrap_handle(self, orig):
        rec = self

        def handle(backend, seq, ev, ledger):
            before = len(backend.trainer.active)
            rec._before_event(ev)
            rec.sync()
            with spans.label("event." + ev.kind, rec.traced):
                t0 = time.perf_counter()
                orig(backend, seq, ev, ledger)
                rec.sync()
                dt = time.perf_counter() - t0
            changed = len(backend.trainer.active) != before
            rec.changed = rec.changed or changed
            rec._after_event(ev)
            if rec.phase == "window":
                rec.run.events.append({"kind": ev.kind, "s": dt, "changed": changed})
        return handle

    def wrap_encode(self, orig):
        def encode_state(tree, *args, **kwargs):
            out = orig(tree, *args, **kwargs)
            mode, self._capture = self._capture, None
            if mode is not None:
                leaves, manifest, _ = out
                paths = [tuple(e.path.split("/")) for e in manifest.entries]
                keep = set(paths) if mode == "full" else set(self.sample)
                move = ((lambda t: t.to("cpu", copy=True)) if mode == "full"
                        else (lambda t: t.clone()))

                def take():
                    return [(p, e.kind, *(None if x is None else move(x)
                                          for x in (e.codes, e.scales, e.raw)))
                            for p, e in zip(paths, leaves) if p in keep]
                items = self._timed_capture(take) if mode == "full" else take()
                if mode == "full":
                    self.joins.append((len(self.snapshots) - 1, items))
                else:
                    self.win_join["codes"] = items
            return out
        return encode_state

    def _before_event(self, ev):
        if ev.kind == "join":
            if self.phase == "setup":
                self._capture = "full"
            elif self.phase == "window" and self.window_joins <= self.join_pick:
                self.win_join = {"before": self._leaves(self.sample)}
                self._capture = "sample"
        elif ev.kind == "checkpoint" and self.phase == "window":
            self.win_push = self._leaves(self.sample)

    def _after_event(self, ev):
        if ev.kind == "join" and self.phase == "window":
            if self.window_joins <= self.join_pick:
                self.win_join["after"] = self._leaves(self.sample)
            self.window_joins += 1
        elif ev.kind == "checkpoint" and self.phase == "setup":
            def restored():
                tree, _ = self.trainer.replica_store.restore(OWNER)
                return len(self.snapshots) - 1, host_copy(tree)
            self.pushed = self._timed_capture(restored)


def _replay(trainer, rec, slot, mix):
    from repro_torch.core.engine import ChurnEvent

    if slot.event is None:
        for _ in range(slot.steps):
            trainer.step(rec.batch())
        return
    rec.t += 1.0
    trainer.replay_scenario([ChurnEvent(t=rec.t, **slot.event)], batch_fn=rec.batch,
                            steps_between=slot.steps, min_active=mix["min_active"])


def _metric_hooks(readers):
    """The spans, call records and profiler ranges the metrics ask for."""
    span_targets, call_targets, ranges = {}, {}, set()
    for mod in readers.values():
        span_targets.update(getattr(mod, "SPANS", {}))
        call_targets.update(getattr(mod, "CALLS", {}))
        ranges.update(getattr(mod, "RANGES", ()))
    return span_targets, call_targets, sorted(ranges)


def run(cat, cell: dict, seed: int, seconds: float, traced: bool, t0: float,
        readers: dict, device: str = "cuda"):
    """One run of a training cell. Returns the ``Run``, the numbers
    compared with their limits, the count of steps and events attempted,
    the device's memory peak over the window, and every reading."""
    from repro_torch.checkpoint import MemoryReplicaStore
    from repro_torch.core.sharding_alg import NeighborLink
    from repro_torch.elastic import ElasticTrainer
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer

    device = torch.device(device)
    cfg, mix = cat.config(cell["config"]), cat.traffic(cell["traffic"])
    limits = cat.limits(cell["config"])
    ref = cat.reference(cfg["family"])
    run = Run(cfg, mix, lambda rows: ref.train_flops(cfg, rows))
    if device.type == "cuda":
        from repro_torch.kernels import build

        build.load()

    arch = program_config(cfg)
    model = build_model(arch, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = C.nest(C.make_params(ref.specs(cfg), gen, device))
    data = ref.make_inputs(cfg, gen, mix["ring_rows"], device)
    state = {"params": params, "opt": make_optimizer(arch).init(params)}
    check_state(state, model.train_state_specs())
    run.state_numels = [t.numel() for _, t in C.flat_items(state)
                        if t.dtype == torch.float32 and t.numel()]
    del params

    trainer = ElasticTrainer(
        model, pool_size=mix["pool_size"], initial=mix["initial"],
        per_device_batch=mix["per_device_batch"], codec=mix["codec"],
        link_model=lambda i: NeighborLink(*traffic.link_seconds(mix, i)))
    trainer.attach_recovery(replica_store=MemoryReplicaStore(), owner=OWNER)
    trainer.init(state=state)
    del state
    rec = Recorder(trainer, data, run, device, traced, seed)
    trainer.step = rec.wrap_step(trainer.step)

    with spans.Patches() as patches:
        patches.wrap("repro_torch.elastic.trainer:TrainerBackend.handle", rec.wrap_handle)
        patches.wrap("repro_torch.elastic.trainer:encode_state", rec.wrap_encode)
        for slot in traffic.setup_slots(mix):
            _replay(trainer, rec, slot, mix)
        rec.sync()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        run.setup_s = time.perf_counter() - t0 - rec.capture_s

        span_targets, call_targets, ranges = _metric_hooks(readers)
        if traced:
            for name, target in span_targets.items():
                patches.wrap(target, spans.span(name, run.spans, rec.sync, traced))
            for name, (target, extract) in call_targets.items():
                patches.wrap(target, spans.record(name, run.calls, extract))
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            prof.start()
        rec.phase = "window"
        w0 = time.perf_counter()
        rec.deadline = w0 + seconds
        try:
            with spans.label(WINDOW.removeprefix("chaosbench."), traced):
                for slot in traffic.slots(mix, seed):
                    _replay(trainer, rec, slot, mix)
        except WindowClosed:
            pass
        rec.sync()
        run.window_s = time.perf_counter() - w0
        rec.phase, rec.deadline = "done", None
        if traced:
            prof.stop()
            run.trace = read_trace(prof.profiler.kineto_results.events(), ranges)
            run.breakdown = breakdown(run.trace)
            del prof
    del trainer.step
    info = {"memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                  if device.type == "cuda" else 0)}

    checks = {}
    if rec.win_push is not None:
        tree, _ = trainer.replica_store.restore(OWNER)
        got = dict(C.flat_items(tree))
        checks["push_mismatch"] = sum(judge.byte_mismatch(got[p], x)
                                      for p, x in rec.win_push.items())
        del tree, got
    del trainer, model, rec.trainer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    C.strict_fp32()
    params0 = C.make_params(ref.specs(cfg), torch.Generator(device=device).manual_seed(seed),
                            device)
    batches = [{k: v[s:s + n] for k, v in data.items()} for s, n in rec.step_rows[:3]]
    ref_out = C.train(ref, cfg, params0, batches)
    b1 = cfg["optimizer"]["b1"]
    first, third = rec.snapshots[0], rec.snapshots[2]
    prog = {"losses": rec.losses[:3],
            "grads": {p: (lambda p=p: first[("opt", "m") + p].to(device) / (1 - b1))
                      for p in params0},
            "grad_norms": {p: float(torch.linalg.vector_norm(first[("opt", "m") + p])) / (1 - b1)
                           for p in params0},
            "change_norms": {p: float(torch.linalg.vector_norm(
                third[("params",) + p].to(device) - params0[p])) for p in params0}}
    readings = judge.step_readings(prog, ref_out)
    checks.update((k, v) for k, v in readings.items() if k in limits)
    del params0, ref_out
    if rec.joins or rec.win_join:
        bad = sum(judge.codec_mismatch(items, rec.snapshots[i], device) for i, items in rec.joins)
        if rec.win_join:
            bad += judge.codec_mismatch(rec.win_join.get("codes", []), rec.win_join["before"],
                                        device)
            checks["join_state_mismatch"] = sum(
                judge.byte_mismatch(rec.win_join["after"][p], x)
                for p, x in rec.win_join["before"].items())
        checks["codec_mismatch"] = bad
    if rec.pushed is not None:
        i, got = rec.pushed
        want = rec.snapshots[i]
        bad = sum(judge.byte_mismatch(got[p], x) if p in got else x.numel() * x.element_size()
                  for p, x in want.items())
        checks["push_mismatch"] = checks.get("push_mismatch", 0) + bad
    compared = {k: {"value": v, "limit": limits[k]} for k, v in checks.items()}
    attempted = len(run.steps) + len(run.events)
    return run, compared, attempted, info, readings
