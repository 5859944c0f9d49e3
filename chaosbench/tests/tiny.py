"""A checkout for the CPU tests: this benchmark folder copied under a
temporary root beside the program, with tiny configurations, mixes and
limits added as new files and cells of their own in its
``BENCHMARK.json``."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TINY_ARCH = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
                 d_ff=128, vocab=256)


def tiny_config(name: str) -> dict:
    cfg = json.loads((ROOT / "chaosbench" / "configs" / f"{name}.json").read_text())
    cfg["name"] = f"tiny-{name}"
    cfg["arch"].update(TINY_ARCH)
    if cfg["family"] == "encdec":
        cfg["arch"].update(enc_layers=2, enc_len=16)
        cfg["seq"] = 8
    else:
        cfg["seq"] = 32
    return cfg


def tiny_mix(name: str) -> dict:
    mix = json.loads((ROOT / "chaosbench" / "traffic" / f"{name}.json").read_text())
    mix["per_device_batch"] = 2
    mix["steps_per_slot"] = 2
    if mix.get("checkpoint_every_steps"):
        mix["checkpoint_every_steps"] = 8
    mix["ring_rows"] = 48
    return mix


#: limits of the tiny cells, set as the cells' own are: on the CPU, seeds
#: 1-8 of the three tiny cells read at most 7.0e-5 (loss), 0.0025 (change)
#: and 0.025 (gradient difference); at seeds 1-4 the fp8 control at least
#: 0.19 (difference), the bfloat16-state control 0.067 (change), half the
#: batch 0.0011 (loss) and 0.75 (difference). The gradient norms' gap has
#: no upper reading (fp8 at least 0.015 against 0.0052) and is not compared.
TINY_LIMITS = {"loss_gap": 2.5e-4, "change_gap": 0.012, "grad_diff": 0.06,
               "codec_mismatch": 0, "push_mismatch": 0, "join_state_mismatch": 0}


def make_checkout(tmp: Path, cells=(("gpt2", "churn_stress"), ("whisper-small", "churn_stress"),
                                    ("gpt2", "steady"))) -> Path:
    """A checkout at ``tmp`` with a tiny cell ``tiny-<config>.tiny-<mix>``
    for each of ``cells``; returns its benchmark folder."""
    bench_dir = tmp / "chaosbench"
    shutil.copytree(ROOT / "chaosbench", bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp / "src").symlink_to(ROOT / "src")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for config, mix in cells:
        cfg = tiny_config(config)
        if not any(c["name"] == cfg["name"] for c in bench["configs"]):
            (bench_dir / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
            (bench_dir / "limits" / f"{cfg['name']}.json").write_text(json.dumps(TINY_LIMITS))
            bench["configs"].append({"name": cfg["name"], "source": "tiny",
                                     "file": f"chaosbench/configs/{cfg['name']}.json",
                                     "reduced": [], "why": "CPU tests"})
        traffic = bench_dir / "traffic" / f"tiny-{mix}.json"
        traffic.write_text(json.dumps(tiny_mix(mix)))
        name = f"{cfg['name']}.tiny-{mix}"
        bench["workloads"].append({"name": name, "config": cfg["name"],
                                   "traffic": f"tiny-{mix}", "chips": 1, "why": "CPU tests"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench_dir
