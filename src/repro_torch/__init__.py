"""PyTorch/CUDA port of the ``repro`` package (Chaos elastic training).

The port imports torch, numpy and the standard library only — never JAX
and never ``repro``. Module names mirror ``repro/`` so each counterpart is
easy to find. Entry points run on CUDA unless the caller passes
``device="cpu"``; the hand-written kernels live in ``csrc/`` and are built
at first use by ``repro_torch.kernels.build``.
"""
