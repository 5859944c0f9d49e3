"""Run one cell of the benchmark of ``repro_torch`` on the card.

    python3 chaosbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It exits non-zero and prints no result
without a CUDA device (or fewer than the cell asks for), without the
program (``src/repro_torch``) beside it, or when JAX or the JAX package
was loaded. The kernels build into ``build/repro_torch_kernels/`` inside
the checkout (the first run of a checkout builds them); other caches go to
``build/chaosbench/``.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: host threads: one process drives the card, and the host's other cores
#: are left to it.
THREADS = "2"


def main() -> int:
    caches = ROOT / "build" / "chaosbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(caches / sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = THREADS
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chaosbench: no program at {ROOT / 'src' / 'repro_torch'}", file=sys.stderr)
        return 2
    # The script's own folder leads ``sys.path``: put the checkout there
    # instead, so that this folder's modules load only as ``chaosbench.*``.
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
    from chaosbench import bench

    # Unimportable in a run, so that a stray import fails at once.
    for name in bench.BANNED:
        sys.modules[name] = None
    return bench.main(sys.argv[1:], T0)


if __name__ == "__main__":
    sys.exit(main())
