#!/usr/bin/env python3
"""Time layouts of the port's shard-decode kernel on one NVIDIA GPU.

    python3 tools/decode_layouts.py

Builds variants of ``src/repro_torch/csrc/shard_codec.cu`` (text edits of
the source, each built in its own directory under ``build/decode_layouts/``),
holds each bit for bit to the plain decode over GPT-2's fp32 leaf shapes
(random values, encoded by the many-leaf encode), and times each as one
many-leaf launch over them, in turns (every variant, then every variant
again in reverse order): the CUDA-event window and the profiler's device
time. Beside them, the write-only rate that ``Tensor.fill_`` reaches on an
fp32 buffer of as many elements. The variants:

* ``kept``: the source as it is;
* ``steps 2``, ``steps 4``, ``steps 8``: that many pairs of blocks a warp
  (the source has one);
* ``plain stores``: ``*p = v`` in place of the streaming ``__stcs``;
* ``16 consecutive values a lane``: a lane owns 16 consecutive codes of a
  block, so that its four 16-byte stores lie 64 bytes apart across the
  warp and a store instruction spans 2 KB.

It prints one line per variant and a JSON object of all times; the card's
name and power limit last. Needs ``nvcc`` and a CUDA device.
"""
import concurrent.futures
import importlib.util
import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

STORE = "__stcs(reinterpret_cast<float4*>(q), make_float4(v[0], v[1], v[2], v[3]));"
EDITS = {
    "kept": [],
    "steps 2": [("kDecodeSteps = 1;", "kDecodeSteps = 2;")],
    "steps 4": [("kDecodeSteps = 1;", "kDecodeSteps = 4;")],
    "steps 8": [("kDecodeSteps = 1;", "kDecodeSteps = 8;")],
    "plain stores": [(STORE, "*reinterpret_cast<float4*>(q) = "
                             "make_float4(v[0], v[1], v[2], v[3]);")],
    "16 consecutive values a lane": [
        ("kGroupStride = 4 * kLanesPerBlock;", "kGroupStride = 4;"),
        ("const long long e0 = blk * kBlock + 4 * sub;",
         "const long long e0 = blk * kBlock + 16 * sub;")],
}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def variant_sources():
    """name -> the edited shard_codec.cu."""
    from repro_torch.kernels import build

    src = (build.CSRC / "shard_codec.cu").read_text()
    out = {}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise ValueError(f"{name}: {old!r} is not in the source once")
            text = text.replace(old, new)
        out[name] = text
    return out


def main():
    if not torch.cuda.is_available():
        print("decode_layouts: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels import shard_codec as codec

    cs = _chip_smoke()
    dirs = {}
    for i, (name, text) in enumerate(variant_sources().items()):
        d = ROOT / "build" / "decode_layouts" / str(i)
        d.mkdir(parents=True, exist_ok=True)
        (d / "shard_codec.cu").write_text(text)
        dirs[name] = d
    main_lib = build.load()
    with concurrent.futures.ThreadPoolExecutor(len(dirs)) as ex:
        paths = {name: ex.submit(build.build, d) for name, d in dirs.items()}
        libs = {name: build.open_library(f.result(), names=["repro_shard_decode_many"])
                for name, f in paths.items()}

    gen = torch.Generator(device="cuda").manual_seed(0)
    leaves = [torch.randn(shape, generator=gen, device="cuda")
              for shape in cs.gpt2_fp32_shapes()]
    codes_list, scales_list = cs.leaf_rows(*codec.shard_encode_many_kernel(leaves))
    numels = [x.numel() for x in leaves]
    n, nb = sum(numels), sum(c.shape[0] for c in codes_list)
    del leaves

    def decode_with(lib):
        def fn():
            build._lib = lib  # the wrapper launches through the loaded library
            try:
                return codec.shard_decode_many_kernel(codes_list, scales_list, numels)
            finally:
                build._lib = main_lib
        return fn

    fns = {name: decode_with(lib) for name, lib in libs.items()}
    for name, fn in fns.items():
        for c, s, m, out in zip(codes_list, scales_list, numels, fn()):
            if not torch.equal(out, codec.shard_decode_plain(c, s, m)):
                raise AssertionError(f"{name}: differs from the plain decode")
    torch.cuda.synchronize()
    buf = torch.empty((n,), dtype=torch.float32, device="cuda")
    times = {name: {"ms": [], "device_ms": []} for name in fns}
    times["fill_"] = {"ms": [], "device_ms": []}
    order = list(fns) + ["fill_"]
    for turn in (order, order[::-1]):
        for name in turn:
            if name == "fill_":
                times[name]["ms"].append(cs.cuda_ms(lambda: buf.fill_(1.0), 10))
                continue
            times[name]["ms"].append(cs.cuda_ms(fns[name], 10))
            times[name]["device_ms"].append(cs.device_ms(fns[name], "shard_decode"))
    bound_ms = (nb * 256 + 4 * nb + 4 * n) / cs.PEAK_BYTES_PER_S * 1e3
    print(f"{len(numels)} leaves, {n} elements; bound {bound_ms:.4f} ms (bytes), "
          f"write-only bound {4 * n / cs.PEAK_BYTES_PER_S * 1e3:.4f} ms")
    for name, t in times.items():
        dev = " / ".join(cs._ms(d) for d in t["device_ms"]) or "not measured"
        print(f"{name:30s} window {t['ms'][0]:.4f} / {t['ms'][1]:.4f} ms, "
              f"device {dev}")
    print(json.dumps({"bound_ms": bound_ms, "times": times}))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
