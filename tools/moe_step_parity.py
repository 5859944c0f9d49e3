#!/usr/bin/env python3
"""The port's MoE training steps against the JAX package's over several
steps, on the CPU: Arctic's layer at a chosen width.

    PYTHONPATH=src python3 tools/moe_step_parity.py [--d-model 2048] [--steps 8]

Builds arctic-480b at ``--d-model`` (2 layers, 8 experts, top-2, heads of
128 at 8:1, experts and dense residual 1,536 wide, vocab 32,000, no remat,
adamw8bit at the config's learning rate) in both packages from the same
JAX-initialised state, and runs ``--steps`` train steps of each (JAX's
jitted) on the same batches of the synthetic ``TokenStream`` (the corpus
the card's main path trains on: 512 distinct tokens in Markov chains).
Prints each step's loss, aux loss and gradient norm from both. Like the
tests, it imports both packages: the CPU only (about 20 s a step at width
2,048 on 8 cores).
"""
import argparse
import dataclasses
import sys
import time

import jax
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.data.synthetic import TokenStream
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.convert import state_from_numpy
from repro_torch.models import build_model


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--d-model", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args()
    kw = dict(n_layers=2, d_model=args.d_model, n_heads=8, n_kv_heads=1, head_dim=128,
              d_ff=1536, moe_d_ff=1536, n_experts=8, remat=False)
    jcfg = dataclasses.replace(jax_get_config("arctic-480b"), **kw)
    cfg = dataclasses.replace(get_config("arctic-480b"), **kw)
    jmodel = jax_build_model(jcfg)
    jstate = jmodel.init_train_state(jax.random.PRNGKey(0))
    tstate = state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    jstep = jax.jit(jmodel.make_train_step())
    tstep = build_model(cfg, device="cpu").make_train_step()
    stream = TokenStream(cfg.vocab, args.seq, seed=0)
    print(f"arctic-480b at d_model {args.d_model}: {cfg.param_count()} params, "
          f"torch {torch.__version__}, jax {jax.__version__}")
    for i in range(args.steps):
        toks = stream.batch(range(args.batch * i, args.batch * (i + 1)))
        t0 = time.perf_counter()
        jstate, jm = jstep(jstate, {"tokens": toks})
        tstate, tm = tstep(tstate, {"tokens": toks})
        print(f"step {i + 1}: " + " | ".join(
            f"{name} loss {float(m['loss']):.4f} aux {float(m['aux_loss']):.4f} "
            f"grad_norm {float(m['grad_norm']):.3f}" for name, m in
            (("jax", jm), ("port", tm)))
            + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
