"""Training launcher of the port, from ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2 \
        [--steps 20] [--elastic] [--ckpt DIR] [--ckpt-every 10] [--device cpu]

Modes:
  * default: real training steps of the model's ``make_train_step`` on one
    global batch per step, synthetic data, async checkpointing.
  * --elastic: the loop under ``ElasticTrainer``, with one join at
    ``steps // 3`` and one leave at ``2 * steps // 3`` (the paper's
    §VI-B/E scenario).

The JAX launcher's flags keep their defaults and meanings. ``--device`` is
the port's own: CUDA unless given, and asking for CUDA where there is none
raises (``repro_torch.device.resolve_device``). The JAX launcher forces 8
host devices through ``XLA_FLAGS``; here ``ElasticTrainer`` holds a pool of
8 logical devices on the one device, so the elastic schedule (start on 4,
per-device batch ``global_batch // 8``) is the same. ``--lower-only`` runs
the dry run's cell of ``--arch`` at ``--shape`` on the single-pod mesh
(``launch.dryrun.run_cell``; full config, meta tensors, no device), prints
the record without its trace analysis and exits 0, as the JAX launcher
does.

Scale knobs live in the configs (``repro_torch/configs/<arch>.py``); the
default ``--reduced`` uses the same ``reduced()`` family transform as the
tests, so the launcher runs anywhere. ``--arch`` takes every config of
``repro_torch.configs`` (the dense family, RWKV-6, Zamba2, PaliGemma,
Arctic, Kimi-K2, Whisper); a name that no config has exits non-zero with
get_config's unknown-arch message. The elastic loop gives a vlm its
patches and an encdec model its frames with each step's tokens; the JAX
launcher's elastic loop passes the tokens alone, which PaliGemma's and
Whisper's losses cannot take (``KeyError: 'patches'``, ``'frames'``).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from repro_torch.checkpoint import AsyncCheckpointer
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.data.synthetic import TokenStream, make_train_batch, stub_inputs
from repro_torch.elastic import ElasticTrainer
from repro_torch.models import build_model

#: logical devices in the elastic pool: the JAX launcher's 8 host devices.
POOL_SIZE = 8


@dataclass
class TrainRun:
    """What one launcher loop did: the loss of every step, the active device
    count at every step (elastic mode only), the trainer's scale events
    (none in plain mode), the steps whose state was checkpointed, and the
    final training state."""
    losses: List[float] = field(default_factory=list)
    n_active: List[int] = field(default_factory=list)
    events: list = field(default_factory=list)
    ckpt_steps: List[int] = field(default_factory=list)
    state: Optional[dict] = None
    trainer: Optional[ElasticTrainer] = None


def train_plain(model, cell: ShapeCell, steps: int, *, state=None,
                ckpt: Optional[AsyncCheckpointer] = None,
                ckpt_every: int = 10) -> TrainRun:
    """``steps`` train steps on ``make_train_batch(cfg, cell, seed=i)``,
    from ``state`` (default: ``model.init_train_state()``, seeded 0); the
    state after step ``i`` goes to ``ckpt`` wherever ``i % ckpt_every ==
    0``."""
    if state is None:
        state = model.init_train_state()
    step = model.make_train_step()
    run = TrainRun()
    for i in range(steps):
        batch = make_train_batch(model.cfg, cell, seed=i)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        run.losses.append(float(m["loss"]))
        if i % 5 == 0 or i == steps - 1:
            print(f"step {i:4d} loss {run.losses[-1]:.4f} "
                  f"({(time.perf_counter() - t0) * 1e3:.0f} ms)")
        if ckpt is not None and i % ckpt_every == 0:
            ckpt.save(i, state)  # a host copy, before the next in-place step
            run.ckpt_steps.append(i)
    run.state = state
    return run


def train_elastic(model, cell: ShapeCell, steps: int, *, state=None,
                  ckpt: Optional[AsyncCheckpointer] = None,
                  ckpt_every: int = 10) -> TrainRun:
    """``steps`` steps under an ``ElasticTrainer`` of ``POOL_SIZE`` logical
    devices, starting on half of them with a per-device batch of
    ``cell.global_batch // POOL_SIZE``: a join before step ``steps // 3``
    and a leave before step ``2 * steps // 3``, where the pool allows;
    batches from one ``TokenStream``, with a vlm's patches or an encdec
    model's frames made as
    ``make_train_batch`` makes them (``stub_inputs``, seeded with the
    step); checkpoints as in :func:`train_plain`. ``state`` is installed
    in place of the seeded init."""
    trainer = ElasticTrainer(model, pool_size=POOL_SIZE,
                             initial=max(2, POOL_SIZE // 2),
                             per_device_batch=max(1, cell.global_batch // POOL_SIZE))
    trainer.init(state=state)
    stream = TokenStream(vocab=model.cfg.vocab, seq_len=cell.seq_len, seed=0)
    join_at, leave_at = steps // 3, 2 * steps // 3
    run = TrainRun(events=trainer.events, trainer=trainer)
    for i in range(steps):
        if i == join_at and len(trainer.active) < len(trainer.pool):
            ev = trainer.scale_out()
            print(f"[elastic] scale-out -> {len(trainer.active)} devices "
                  f"({ev.wall_s * 1e3:.0f} ms)")
        if i == leave_at and len(trainer.active) > 1:
            trainer.scale_in()
            print(f"[elastic] scale-in -> {len(trainer.active)} devices")
        toks = stream.batch(range(i * trainer.global_batch,
                                  (i + 1) * trainer.global_batch))
        m = trainer.step({"tokens": toks,
                          **stub_inputs(model.cfg, trainer.global_batch, seed=i)})
        run.losses.append(m["loss"])
        run.n_active.append(len(trainer.active))
        if i % 5 == 0 or i == steps - 1:
            print(f"step {i:4d} loss {m['loss']:.4f}")
        if ckpt is not None and i % ckpt_every == 0:
            ckpt.save(i, trainer.state)
            run.ckpt_steps.append(i)
    run.state = trainer.state
    return run


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="reduced config (the default)")
    ap.add_argument("--full-config", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--elastic", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--lower-only", action="store_true",
                    help="print the dry run's single-mesh record and exit")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    if args.lower_only:
        from repro_torch.launch import dryrun

        rec = dryrun.run_cell(args.arch, args.shape, "single")
        print({k: v for k, v in rec.items() if k != "trace_analysis"})
        return 0

    try:
        cfg = get_config(args.arch)
    except KeyError as e:
        print(f"train: {e.args[0]}", file=sys.stderr)
        return 2
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), learning_rate=args.lr)
        cell = ShapeCell("launch", args.seq, args.batch, "train")
    else:
        cell = SHAPES[args.shape]
    model = build_model(cfg, device=args.device)

    ckpt = AsyncCheckpointer(args.ckpt, keep=3) if args.ckpt else None
    try:
        if args.elastic:
            train_elastic(model, cell, args.steps, ckpt=ckpt,
                          ckpt_every=args.ckpt_every)
            return 0
        run = train_plain(model, cell, args.steps, ckpt=ckpt,
                          ckpt_every=args.ckpt_every)
    finally:
        if ckpt is not None:
            ckpt.close()
    ok = bool(np.isfinite(run.losses).all())
    print("TRAIN_OK" if ok else "TRAIN_FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
