"""Build the port's CUDA kernels and load them with ``ctypes``.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all
started together, for ``sm_90a`` (Hopper), and the objects are linked into
one shared library with a plain C interface. The library lands in
``build/repro_torch_kernels/<hash>/`` at the root of the checkout, where
``<hash>`` covers every source and the flags: the build runs at first use
and again whenever a source changes. There is no fallback: a missing
``nvcc`` or a failed build raises.

Nothing here runs at import time — the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
LIB_NAME = "librepro_torch_kernels.so"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# No --use_fast_math: the codec must round exactly like the reference.
COMPILE_FLAGS = ARCH_FLAGS + ["-O3", "-std=c++17", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v"]

_P, _I64, _I32, _F32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
#: C entry points of the library and their argument types. Every pointer and
#: the stream go as ``c_void_p`` so that ctypes does not cut them to 32 bits.
SIGNATURES = {
    "repro_shard_encode": [_P, _I64, _P, _P, _I64, _P],
    # table, n_leaves, nb, codes, scales, stream.
    "repro_shard_encode_many": [_P, _I32, _I64, _P, _P, _P],
    "repro_shard_decode": [_P, _P, _I64, _P, _P],
    # table, n_leaves, nb, stream.
    "repro_shard_decode_many": [_P, _I32, _I64, _P],
    "repro_flash_attention_fwd": [_P, _P, _P, _P, _I32, _I32, _I32, _I32,
                                  _I32, _I32, _I32, _F32, _F32, _I32, _I32,
                                  _I32, _I32, _P],
    # r, k, v, lw, u, state (or null), out, final state; dtype, B, S, H, hd.
    "repro_wkv6_fwd": [_P] * 8 + [_I32] * 5 + [_P],
    # x, dt, A_log, Bm, Cm, state (or null), y, final state; dtype, B, S, H,
    # P, N.
    "repro_ssd_fwd": [_P] * 8 + [_I32] * 6 + [_P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: seconds the last build in this process took (0.0 when it was cached).
last_build_s = 0.0


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [shutil.which("nvcc")]
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the port's CUDA kernels are compiled "
                       "from repro_torch/csrc at first use")


def sources(csrc: Path = CSRC) -> list:
    return sorted(csrc.glob("*.cu"))


def source_hash(csrc: Path = CSRC) -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for path in sorted(csrc.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build(csrc: Path = CSRC) -> Path:
    """Compile (if needed) and return the path of the shared library built
    from ``csrc`` (this package's sources unless another checkout's are
    given, as a timing baseline)."""
    global last_build_s
    out_dir = BUILD_ROOT / source_hash(csrc)
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        last_build_s = 0.0
        return lib_path
    t0 = time.perf_counter()
    nvcc = nvcc_path()
    tmp = BUILD_ROOT / f"tmp-{out_dir.name}-{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    jobs = []
    for src in sources(csrc):
        obj = tmp / f"{src.stem}.o"
        log = tmp / f"{src.stem}.log"
        with open(log, "w") as fh:
            proc = subprocess.Popen(
                [nvcc, *COMPILE_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=fh, stderr=subprocess.STDOUT)
        jobs.append((src, obj, log, proc))
    failed = [src.name for src, _, _, proc in jobs if proc.wait() != 0]
    if failed:
        logs = "\n".join(log.read_text() for _, _, log, _ in jobs)
        raise RuntimeError(f"nvcc failed on {failed}:\n{logs}")
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp / LIB_NAME),
         *[str(obj) for _, obj, _, _ in jobs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    try:
        os.rename(tmp, out_dir)
    except OSError:  # another process finished the same build first
        shutil.rmtree(tmp, ignore_errors=True)
    last_build_s = time.perf_counter() - t0
    return lib_path


def build_log() -> str:
    """What ``nvcc -Xptxas -v`` said for each source of the current build:
    registers, shared memory and spills of every kernel."""
    out_dir = BUILD_ROOT / source_hash()
    return "\n".join(p.read_text() for p in sorted(out_dir.glob("*.log")))


def open_library(path: Path, names=None) -> ctypes.CDLL:
    """Load a built kernel library and declare its C entry points: all of
    ``SIGNATURES``, or only ``names`` (an earlier checkout's library, built
    as a timing baseline, lacks the entry points added since)."""
    lib = ctypes.CDLL(str(path))
    for name in SIGNATURES if names is None else names:
        fn = getattr(lib, name)
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = open_library(build())
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err:
        msg = _lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(tensor) -> int:
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream
