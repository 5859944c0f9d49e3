"""Elastic training demo on the PyTorch port: stop-free scale-out and
scale-in on live tensors, the twin of ``examples/elastic_training.py``.

Start training on 4 logical devices, two nodes join one by one
(Poisson-style, as at the edge), then one leaves, without restarts or
checkpoints. Each membership change reshards the data pipeline (nodes
bring or take their data split) and reports the Chaos replication plan
used to ship the training state.

    PYTHONPATH=src python examples/torch_elastic_training.py [--device cpu]

The logical devices share one torch device: CUDA unless ``--device`` names
another (``cpu`` runs the kernels' plain versions).
"""
import argparse
import sys

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.sharding_alg import NeighborLink
from repro_torch.data import ShardedLoader, TokenStream
from repro_torch.elastic import ElasticTrainer
from repro_torch.models import build_model

SEQ = 64
PER_DEV_BATCH = 2


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = get_config("gpt2").reduced()
    model = build_model(cfg, device=args.device)
    stream = TokenStream(vocab=cfg.vocab, seq_len=SEQ, seed=0)
    loader = ShardedLoader(stream, n_examples=512, node_ids=[0],
                           batch_per_node=PER_DEV_BATCH)

    # Heterogeneous synthetic links: even devices fast, odd devices slower —
    # the shard scheduler derates the slow ones.
    def link_model(device_id: int) -> NeighborLink:
        fast = device_id % 2 == 0
        return NeighborLink(prop_s=0.002 if fast else 0.01,
                            trans_s_per_byte=1 / (500e6 / 8) if fast else 1 / (120e6 / 8),
                            sync_s=0.0)

    trainer = ElasticTrainer(model, initial=4, per_device_batch=PER_DEV_BATCH,
                             link_model=link_model,
                             on_reshard=lambda ids: loader.reshard(ids))
    trainer.init()
    print(f"devices: {len(trainer.pool)} logical devices on {model.device}; "
          f"starting on 4")

    def run_steps(n):
        for _ in range(n):
            toks = np.concatenate([loader.next_batch(i)
                                   for i in trainer.device_ids()])
            m = trainer.step({"tokens": toks})
        return m

    m = run_steps(10)
    print(f"[4 devices] step {trainer.step_count}: loss {m['loss']:.4f}")

    for join in range(2):  # two nodes join, one by one (paper: Poisson joins)
        ev = trainer.scale_out()
        ps = ev.plan_summary
        print(f"scale-out -> {len(trainer.active)} devices in {ev.wall_s*1e3:.1f} ms "
              f"(plan: {ps['n_shards']} shards of "
              f"{ps['shard_size']} B from {len(ps['bytes_per_source'])} neighbors, "
              f"predicted completion {ps['predicted_completion_s']*1e3:.1f} ms)")
        m = run_steps(8)
        print(f"[{len(trainer.active)} devices] step {trainer.step_count}: "
              f"loss {m['loss']:.4f}")

    ev = trainer.scale_in()
    print(f"scale-in -> {len(trainer.active)} devices in {ev.wall_s*1e3:.1f} ms")
    m = run_steps(8)
    print(f"[{len(trainer.active)} devices] step {trainer.step_count}: "
          f"loss {m['loss']:.4f}")

    print("straggler report:", trainer.straggler_report())
    losses_ok = m["loss"] < 8.0
    print("ELASTIC_DEMO_OK" if losses_ok else "ELASTIC_DEMO_FAILED")
    return 0 if losses_ok else 1


if __name__ == "__main__":
    sys.exit(main())
