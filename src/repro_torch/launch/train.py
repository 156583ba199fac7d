"""Fault-tolerant training loop and its CLI.

The port of the reference's ``repro.launch.train``: deterministic data
pipeline -> train step -> async checkpointing -> preemption and hang
handling -> restart from the latest checkpoint. Runs on the card unless
asked for the CPU (``--device cpu``), on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \
      --smoke --device cpu --steps 50 --batch 8 --seq 128 --ckpt-dir CKPT
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch import checkpoint as ckpt_lib
from repro_torch.configs import TrainConfig, get_config, get_smoke
from repro_torch.core.pipeline import resolve_device
from repro_torch.data.tokens import TokenDataset
from repro_torch.models import get_model
from repro_torch.models.api import family_module
from repro_torch.optim import adamw_init
from repro_torch.runtime.fault_tolerance import (
    HangWatchdog, PreemptionHandler, TransientError)
from repro_torch.train import steps as steps_lib


def train_loop(cfg, tcfg: TrainConfig, *, batch: int, seq: int,
               steps: int, ckpt_dir: Optional[str] = None,
               preemption: Optional[PreemptionHandler] = None,
               watchdog: Optional[HangWatchdog] = None,
               fail_at_step: Optional[int] = None,
               log_every: int = 10,
               metrics_out: Optional[list] = None,
               device=None) -> int:
    """Run (or resume from ``ckpt_dir``'s latest step) training to
    ``steps``. Returns the last completed step.

    On ``device`` (CUDA unless "cpu"; without a card the default
    raises), under `steps_lib.deterministic_algorithms`, so a run cut and
    resumed repeats the uncut run bit for bit. A failure inside the loop
    first waits for the checkpoint in flight, so the restart finds it."""
    dev = resolve_device(device)
    model = get_model(cfg, device=dev)
    data = TokenDataset(cfg, batch, seq, seed=tcfg.seed)
    train_step = steps_lib.make_train_step(model, tcfg)

    start_step = 0
    state = None
    if ckpt_dir:
        latest = ckpt_lib.latest_step(ckpt_dir)
        if latest is not None:
            spec = family_module(cfg).init_params(cfg, None,
                                                  torch.device("meta"))
            template = {"params": spec, "opt": adamw_init(spec)}
            state = ckpt_lib.restore(ckpt_dir, latest, template, device=dev)
            start_step = latest
    if state is None:
        state = steps_lib.init_train_state(model, tcfg.seed)

    saver = ckpt_lib.AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    step = start_step
    t_last = time.time()
    with steps_lib.deterministic_algorithms():
        try:
            for step in range(start_step + 1, steps + 1):
                batch_t = {k: torch.from_numpy(v).to(dev)
                           for k, v in data.batch_for_step(step).items()}
                state, metrics = train_step(state, batch_t)
                if fail_at_step is not None and step == fail_at_step:
                    raise TransientError(f"injected failure at step {step}")
                if watchdog is not None:
                    watchdog.heartbeat()
                if metrics_out is not None:
                    metrics_out.append(
                        {k: float(v) for k, v in metrics.items()})
                if step % log_every == 0 or step == steps:
                    dt = time.time() - t_last
                    t_last = time.time()
                    tok_s = batch * seq * log_every / max(dt, 1e-9)
                    print(f"step {step:6d} loss={float(metrics['loss']):.4f} "
                          f"gnorm={float(metrics['grad_norm']):.3f} "
                          f"tok/s={tok_s:,.0f}", flush=True)
                if saver and (step % tcfg.checkpoint_every == 0
                              or step == steps):
                    saver.save(step, state)
                if preemption is not None and preemption.preempted:
                    if saver:
                        saver.save(step, state)
                    print(f"preempted: checkpointed at step {step}",
                          flush=True)
                    return step
        finally:
            if saver:
                saver.wait()
    return step


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--hang-timeout", type=float, default=600.0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="default: cuda (fails without a CUDA device)")
    args = ap.parse_args()

    cfg = (get_smoke(args.arch) if args.smoke else get_config(args.arch))
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       warmup_steps=max(args.steps // 20, 1),
                       microbatches=args.microbatches,
                       checkpoint_every=args.ckpt_every)

    watchdog = HangWatchdog(args.hang_timeout).start()
    with PreemptionHandler() as pre:
        train_loop(cfg, tcfg, batch=args.batch, seq=args.seq,
                   steps=args.steps, ckpt_dir=args.ckpt_dir,
                   preemption=pre, watchdog=watchdog, device=args.device)
    watchdog.stop()


if __name__ == "__main__":
    main()
