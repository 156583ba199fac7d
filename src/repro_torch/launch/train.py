"""Fault-tolerant training loop and its CLI.

The port of the reference's ``repro.launch.train``: deterministic data
pipeline -> train step -> async checkpointing -> preemption and hang
handling -> restart from the latest checkpoint. Runs on the card unless
asked for the CPU (``--device cpu``), on one device, or over the ranks of
a ``torchrun`` on a mesh of (data = N / M, model = M) (``--data N`` ranks
in all, one card a rank, ``--model M`` of them splitting the model;
``--pod P`` makes it (pod = P, data = N / (P M), model = M), the batch
over ("pod", "data"); ``--batch`` is the global batch; ``--fsdp`` splits
the parameters over the data axes too, ``ParallelConfig.fsdp``):

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \
      --smoke --device cpu --steps 50 --batch 8 --seq 128 --ckpt-dir CKPT
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch gemma3-1b --steps 20 --batch 16 --seq 2048 --data 4
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch qwen3-8b --steps 20 --batch 4 --seq 2048 --data 4 --model 4
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch granite-moe-3b-a800m --steps 20 --batch 4 --seq 2048 \
      --data 4 --model 4           # 12 of its 48 experts a card
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch qwen3-8b --steps 20 --batch 4 --seq 2048 --data 4 --fsdp
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch qwen3-8b --steps 20 --batch 4 --seq 2048 --data 4 --pod 2 \
      --model 2                    # the mesh (pod 2, data 1, model 2)
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import checkpoint as ckpt_lib
from repro_torch.configs import (ParallelConfig, TrainConfig, get_config,
                                 get_smoke)
from repro_torch.core.pipeline import resolve_device
from repro_torch.data.tokens import TokenDataset
from repro_torch.launch.mesh import binding_for, make_mesh
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
               device=None, mesh=None,
               parallel: Optional[ParallelConfig] = None) -> int:
    """Run (or resume from ``ckpt_dir``'s latest step) training to
    ``steps``. Returns the last completed step.

    On ``device`` (CUDA unless "cpu"; without a card the default
    raises), under `steps_lib.deterministic_algorithms`, so a run cut and
    resumed repeats the uncut run bit for bit. A failure inside the loop
    first waits for the checkpoint in flight, so the restart finds it.

    With a ``mesh`` (`launch.mesh.make_mesh`; every rank calls this with
    the same arguments), the step across ranks on the rows of each
    rank's coordinate over the "batch" rule's axes ("data", or ("pod",
    "data"), pod-major) of the global ``batch`` (the ranks of "model"
    share them) and its pieces of the model: rank 0 picks the
    step to resume from and writes the checkpoints (whole, in the
    one-device layout, so a run resumes at any mesh), the ranks agree on
    preemption through one all-reduce of the flag a step over all of
    them, and only rank 0 prints."""
    dev = resolve_device(device)
    model = get_model(cfg, device=dev)
    data = TokenDataset(cfg, batch, seq, seed=tcfg.seed)
    train_step = steps_lib.make_train_step(model, tcfg, mesh, parallel)
    spec = family_module(cfg).init_params(cfg, None, torch.device("meta"))
    blocks = steps_lib.state_blocks(cfg, tcfg, mesh, parallel)
    axis = None
    if mesh is not None:
        binding = binding_for(mesh, parallel)
        axis = binding.axis_group(binding.rules["batch"])
    shardings = blocks if mesh is not None else None
    lead = axis is None or dist.get_rank() == 0

    start_step = 0
    state = None
    if ckpt_dir:
        latest = ckpt_lib.latest_step(ckpt_dir)
        if axis is not None:
            # rank 0's view (its last save has been waited for)
            box = [latest]
            dist.broadcast_object_list(box, src=0)
            latest = box[0]
        if latest is not None:
            template = {"params": spec, "opt": adamw_init(spec)}
            state = ckpt_lib.restore(ckpt_dir, latest, template, device=dev,
                                     shardings=shardings)
            start_step = latest
    if state is None:
        state = steps_lib.init_train_state(model, tcfg.seed, blocks)

    def rows(step):
        if axis is None:
            return data.batch_for_step(step)
        return data.rows_for_step(step, axis.index, axis.extent)

    def preempted() -> bool:
        flag = preemption is not None and preemption.preempted
        if axis is None:
            return flag
        t = torch.tensor([int(flag)], device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    saver = ckpt_lib.AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    step = start_step
    t_last = time.time()
    with steps_lib.deterministic_algorithms():
        try:
            for step in range(start_step + 1, steps + 1):
                batch_t = {k: torch.from_numpy(v).to(dev)
                           for k, v in rows(step).items()}
                state, metrics = train_step(state, batch_t)
                if fail_at_step is not None and step == fail_at_step:
                    raise TransientError(f"injected failure at step {step}")
                if watchdog is not None:
                    watchdog.heartbeat()
                if metrics_out is not None:
                    metrics_out.append(
                        {k: float(v) for k, v in metrics.items()})
                if lead and (step % log_every == 0 or step == steps):
                    dt = time.time() - t_last
                    t_last = time.time()
                    tok_s = batch * seq * log_every / max(dt, 1e-9)
                    print(f"step {step:6d} loss={float(metrics['loss']):.4f} "
                          f"gnorm={float(metrics['grad_norm']):.3f} "
                          f"tok/s={tok_s:,.0f}", flush=True)
                if saver and (step % tcfg.checkpoint_every == 0
                              or step == steps):
                    saver.save(step, state, shardings)
                if preempted():
                    if saver:
                        saver.save(step, state, shardings)
                    if lead:
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
    ap.add_argument("--data", type=int, default=1,
                    help="ranks in all (under torchrun, one card a rank; "
                    "--batch is the global batch)")
    ap.add_argument("--model", type=int, default=1,
                    help="of the --data ranks, how many split the model "
                    "(its heads, widths, vocabulary and experts): a mesh "
                    "of (data / model, model)")
    ap.add_argument("--pod", type=int, default=1,
                    help="of the --data ranks, how many pods: a mesh of "
                    "(pod, data / (pod x model), model), the batch over "
                    "(pod, data), as the reference's multi-pod rules")
    ap.add_argument("--fsdp", action="store_true",
                    help="split the parameters over the data axis too, "
                    "each layer gathered as it runs (ParallelConfig.fsdp)")
    args = ap.parse_args()

    cfg = (get_smoke(args.arch) if args.smoke else get_config(args.arch))
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       warmup_steps=max(args.steps // 20, 1),
                       microbatches=args.microbatches,
                       checkpoint_every=args.ckpt_every)

    mesh, device = None, args.device
    parallel = ParallelConfig(fsdp=args.fsdp)
    if args.data > 1:
        mesh, device = start_ranks(args.data, args.device, args.model,
                                   args.pod)
    elif args.model > 1:
        raise ValueError(f"--model {args.model} needs --data of at least "
                         "as many ranks")
    elif args.pod > 1:
        raise ValueError(f"--pod {args.pod} needs --data of at least as "
                         "many ranks")
    elif args.fsdp:
        raise ValueError("--fsdp needs --data of two or more ranks")
    watchdog = HangWatchdog(args.hang_timeout).start()
    try:
        with PreemptionHandler() as pre:
            train_loop(cfg, tcfg, batch=args.batch, seq=args.seq,
                       steps=args.steps, ckpt_dir=args.ckpt_dir,
                       preemption=pre, watchdog=watchdog, device=device,
                       mesh=mesh, parallel=parallel)
    finally:
        watchdog.stop()
        if mesh is not None:
            dist.destroy_process_group()


def start_ranks(n: int, device: str, model: int = 1, pod: int = 1):
    """The process group of a ``torchrun`` of ``n`` ranks (its
    environment: RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/PORT) and its
    mesh of (n / model, model) on ("data", "model"), or with ``pod`` > 1
    of (pod, n / (pod model), model) on ("pod", "data", "model"); NCCL
    with one card a rank (set before the group starts), gloo on the
    CPU. -> (mesh, this rank's device)."""
    if model < 1 or pod < 1 or n % (model * pod):
        raise ValueError(f"--model {model} x --pod {pod} does not divide "
                         f"--data {n}")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != n:
        raise ValueError(f"--data {n} under a world of {world} ranks "
                         "(start it with torchrun --nproc-per-node)")
    if device == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        resolve_device("cuda")
        torch.cuda.set_device(local)
        dist.init_process_group("nccl")
        dev = torch.device("cuda", local)
    else:
        dist.init_process_group("gloo")
        dev = "cpu"
    if pod > 1:
        return make_mesh((pod, n // (pod * model), model),
                         ("pod", "data", "model")), dev
    return make_mesh((n // model, model), ("data", "model")), dev


if __name__ == "__main__":
    main()
