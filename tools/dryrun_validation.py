#!/usr/bin/env python3
"""The dry run's reckoning held to what the cards measured.

Runs `repro_torch.launch.dryrun.dry_run` on the meta device (no card,
the CPU of any machine) on the exact configs, shapes, meshes and
`TrainConfig`s of the card runs that PERF.md records, and prints each
reckoned value beside the measured one and their ratio:

  - qwen3-8b bf16 train at a global (4, 2048), ZeRO-1: at (4, 1) with
    FSDP off and on (state and peak a card), (2, 2) with FSDP on and off
    (peak), (1, 4) (peak); measured by tools/dist_train_scaling.py on
    four NVIDIA H100 80GB HBM3 cards at 700 W (PERF.md: Z1, T1);
  - qwen3-8b decode_32k at (1, 4), batch 16 over 32,768 positions (cache
    and peak a card; tools/dist_serve_cells.py, S1);
  - the one-card `[train]` steps of chip_smoke.py at (4, 2048) (peak;
    C1, and M2 beside it).

The state a card is also held to tools/dist_train_scaling.py's
`reckoned_state_gb` of the same layout, to the byte. The measured
figures are constants here, each with the run it comes from; every
reckoned one is computed by this run.

    PYTHONPATH=src python3 tools/dryrun_validation.py
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tools"))

from dist_train_scaling import reckoned_state_gb  # noqa: E402
from repro_torch.configs import (ParallelConfig, TrainConfig,  # noqa: E402
                                 get_config)
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch.dryrun import dry_run  # noqa: E402

GB = 1e9
TRAIN = ShapeConfig("train", "train", 2048, 4)

# (mesh, fsdp): measured state GB (None: not printed by the run), peak GB
QWEN_TRAIN = [
    ((4, 1), False, 49.14, 56.46, "Z1"),
    ((4, 1), True, 28.31, 31.83, "Z1"),
    ((2, 2), True, None, 27.70, "Z1"),
    ((2, 2), False, None, 36.46, "Z1"),
    ((1, 4), False, None, 27.8, "T1"),
]
DECODE = dict(cache_gb=19.33, peak_gb=43.59, run="S1")
# chip_smoke.py [train] peak MB at (4, 2048): PERF.md's runs C1 and M2
ONE_CARD = {
    "mamba2-130m": (10132.7, 10132.7),
    "zamba2-1.2b": (52956.3, 52956.3),
    "gemma3-1b": (54828.8, 54828.8),
    "qwen2-vl-2b": (42236.7, 42236.7),
    "seamless-m4t-large-v2": (62646.6, 64040.0),
    "granite-moe-3b-a800m": (63056.8, 52532.8),
}


def ratio(got: float, want: float) -> str:
    return f"{got / want:.3f}"


def peak(r: dict) -> str:
    """The reckoned peak GB (arguments + temp) of a dry-run record."""
    return (f"{r['peak_bytes'] / GB:.2f} "
            f"({r['memory']['argument_bytes'] / GB:.2f} + "
            f"{r['memory']['temp_bytes'] / GB:.2f})")


def main() -> int:
    bad = 0
    qwen = get_config("qwen3-8b")
    print("| run | reckoned state GB | tool's state GB | measured state GB "
          "| reckoned peak GB (arguments + temp) | measured peak GB "
          "| peak ratio |")
    for mesh, fsdp, state, measured, run in QWEN_TRAIN:
        r = dry_run(qwen, TRAIN, mesh, TrainConfig(zero1=True),
                    ParallelConfig(fsdp=fsdp))
        tool = reckoned_state_gb("qwen3-8b", mesh, fsdp)
        same = r["state_bytes"] == round(tool * GB)
        bad += not same
        print(f"| qwen3-8b train {mesh} FSDP {'on' if fsdp else 'off'} "
              f"({run}) | {r['state_bytes'] / GB:.6f} | {tool:.6f} "
              f"({'equal' if same else 'DIFFERS'}) | "
              f"{state if state is not None else 'not printed'} | "
              f"{peak(r)} | {measured} | "
              f"{ratio(r['peak_bytes'] / GB, measured)} |")
    r = dry_run(qwen, ShapeConfig("decode_32k", "decode", 32768, 16),
                (1, 4))
    cache = r["arguments"]["cache"] / GB
    print(f"| qwen3-8b decode_32k (1, 4), batch 16 ({DECODE['run']}) | "
          f"cache {cache:.4f} | | cache {DECODE['cache_gb']} | {peak(r)} | "
          f"{DECODE['peak_gb']} | "
          f"{ratio(r['peak_bytes'] / GB, DECODE['peak_gb'])} |")
    for arch, (c1, m2) in ONE_CARD.items():
        r = dry_run(get_config(arch), TRAIN)
        mb = r["peak_bytes"] / 1e6
        print(f"| {arch} train (4, 2048), one card (C1; M2) | "
              f"{r['state_bytes'] / GB:.4f} | | | {peak(r)} | "
              f"{c1 / 1e3:.2f}; {m2 / 1e3:.2f} | {ratio(mb, c1)}; "
              f"{ratio(mb, m2)} |")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
