"""Sharded ultrasound serving over 1, 2, 4, ... cards.

At the paper's geometry, for B-mode dynamic per stage and fused, it
streams `serve_ultrasound_sharded` at 4 acquisitions a card (32
dispatches, 2 in flight) over the first 1, 2, 4, ... cards, up to every
card there is, and prints MB/s, FPS, each card's completion p50 / p99
and the speedup and scale efficiency against `serve_ultrasound_stream`
on the first card at batch 4. Each source holds a pinned batch tiled
from 4 distinct acquisitions (synthesis stays out of the windows; every
dispatch still copies the batch to the cards). Then `ShardedExecutor`
over every card on a batch of n + 1 against `BatchedExecutor` on the
first, bit for bit.

Needs CUDA cards and nvcc:

    python3 tools/sharded_scaling.py
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import (BatchedExecutor, ShardedExecutor,  # noqa: E402
                              paper_config)
from repro_torch.data import shared_rf  # noqa: E402
from repro_torch.launch.serve import (serve_ultrasound_sharded,  # noqa: E402
                                      serve_ultrasound_stream)

PER_CARD = 4
N_BATCHES = 32


class TiledSource:
    """One pinned (batch, ...) RF batch tiled from 4 acquisitions."""

    def __init__(self, cfg, batch):
        frames = [shared_rf(cfg, seed=s) for s in range(4)]
        rf = np.stack([frames[i % 4] for i in range(batch)])
        self.rf = torch.from_numpy(rf).pin_memory().numpy()

    def next(self):
        return self.rf


def main() -> None:
    n_all = torch.cuda.device_count()
    if n_all < 1:
        sys.exit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    counts = [n for n in (1, 2, 4, 8) if n <= n_all]
    for fusion in ("none", "fused"):
        cfg = paper_config(variant="dynamic", fusion=fusion)
        base = serve_ultrasound_stream(
            cfg, batch=PER_CARD, n_batches=N_BATCHES, depth=2,
            source=TiledSource(cfg, PER_CARD), device="cuda:0")
        print(f"fusion={fusion} one card (serve_ultrasound_stream, batch "
              f"{PER_CARD}): {base['sustained_mbps']:.1f} MB/s, "
              f"{base['fps']:.1f} FPS")
        for n in counts:
            st = serve_ultrasound_sharded(
                cfg, batch_per_device=PER_CARD, n_batches=N_BATCHES,
                depth=2, devices=[f"cuda:{i}" for i in range(n)],
                source=TiledSource(cfg, PER_CARD * n),
                baseline_fps=base["fps"])
            per = ", ".join(f"{d} {v['p50_s'] * 1e3:.3f}/"
                            f"{v['p99_s'] * 1e3:.3f} ms"
                            for d, v in st["per_device_latency"].items())
            print(f"fusion={fusion} {n} card(s): {st['sustained_mbps']:.1f}"
                  f" MB/s, {st['fps']:.1f} FPS, speedup_vs_single "
                  f"{st['speedup_vs_single']:.4f}, scale_efficiency "
                  f"{st['scale_efficiency']:.4f}; per card p50/p99: {per}")
        devices = [f"cuda:{i}" for i in range(n_all)]
        rf = TiledSource(cfg, n_all + 1).next()
        got = ShardedExecutor(cfg, devices=devices)(rf).cpu()
        want = BatchedExecutor(cfg, device="cuda:0")(rf).cpu()
        same = torch.equal(got, want)
        print(f"fusion={fusion} ShardedExecutor over {n_all} card(s), "
              f"batch {n_all + 1}: "
              + ("bit-equal to BatchedExecutor" if same else "DIFFERS"))
        if not same:
            sys.exit(1)


if __name__ == "__main__":
    main()
