"""Serving drivers of the PyTorch port, for both system halves.

LM half — slot-based batching, as the reference: B fixed slots, each
request batch prefills into its slots, then all slots decode in lockstep,
greedily (`serve_session`). zamba2-1.2b is the ported architecture:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \
      --smoke --requests 8 --batch 4 --prompt-len 32 --max-new 16 \
      [--device cpu]

Ultrasound half — `serve_ultrasound_stream` feeds RF batches from a
synthetic acquisition source through a `BatchedExecutor`, keeps up to
``depth`` batches in flight on the device's stream, and reports
sustained MB/s / FPS and the completion-interval latency distribution
with the reference's stats keys. Peak memory is
``torch.cuda.max_memory_allocated`` over the timed window; energy is not
measured (None).

  PYTHONPATH=src python -m repro_torch.launch.serve --ultrasound \\
      --batch 4 --batches 32 --depth 2 [--variant dynamic|cnn|sparse|auto] \\
      [--device cpu]

Both run on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import collections
import time

import numpy as np
import torch


def serve_session(cfg, *, requests: int, batch: int, prompt_len: int,
                  max_new: int, seed: int = 0, params=None, device=None):
    """Process ``requests`` prompts in slot batches of ``batch``.

    Prompts are ``synth_train_batch(cfg, bsz, prompt_len, seed + r0)``, as
    in the reference. ``params`` defaults to ``init_params(seed)`` (the
    port's draws; pass ``params_from_numpy`` of the reference's to serve
    the same weights). Returns (generated tokens (requests, max_new + 1)
    int32 array, stats dict): the reference's keys, plus the host-clock
    time of each slot batch's prefill (the first token included) and of
    each decode step, and the peak device memory (None on the CPU).
    """
    from repro_torch.data.batches import synth_train_batch
    from repro_torch.models import get_model
    from repro_torch.train import steps as steps_lib

    model = get_model(cfg, device=device)
    dev = model.device
    if params is None:
        params = model.init_params(seed)
    prefill_step = steps_lib.make_prefill_step(model)
    serve_step = steps_lib.make_serve_step(model)
    on_cuda = dev.type == "cuda"
    if on_cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    outs, prefill_s, decode_s = [], [], []
    t0 = time.perf_counter()
    max_len = prompt_len + max_new + 1
    for r0 in range(0, requests, batch):
        bsz = min(batch, requests - r0)
        prompt = synth_train_batch(cfg, bsz, prompt_len, seed=seed + r0,
                                   device=dev)
        t = time.perf_counter()
        tok_next, cache = prefill_step(params, prompt)
        tok = tok_next[:, None]
        # decoder-only: extend the prefilled cache to serving length
        cache = _grow_cache(cache, max_len)
        lengths = torch.full((bsz,), prompt_len, dtype=torch.int32,
                             device=dev)
        gen = [tok.cpu().numpy()]           # waits for the device
        prefill_s.append(time.perf_counter() - t)
        for _ in range(max_new):
            t = time.perf_counter()
            tok, cache, lengths = serve_step(params, tok, cache, lengths)
            gen.append(tok.cpu().numpy())
            decode_s.append(time.perf_counter() - t)
        outs.append(np.concatenate(gen, axis=1))

    wall = time.perf_counter() - t0
    toks = sum(o.size for o in outs)
    stats = {"wall_s": wall, "tokens": toks,
             "tok_per_s": toks / max(wall, 1e-9),
             "decode_steps": len(decode_s),
             "prefill_s": prefill_s, "decode_s": decode_s,
             "peak_memory_bytes": (int(torch.cuda.max_memory_allocated(dev))
                                   if on_cuda else None),
             "device": str(dev)}
    return np.concatenate(outs, axis=0)[:requests], stats


def _grow_cache(cache, max_len: int):
    """Pad the KV caches ``attn_k`` and ``attn_v``, (n_inv, B, S, Hkv,
    dh), with zeros along the sequence axis (dim 2) to ``max_len``. The
    SSM and conv states have no sequence axis and pass through."""
    out = dict(cache)
    for key in ("attn_k", "attn_v"):
        a = cache[key]
        if a.shape[2] < max_len:
            out[key] = torch.nn.functional.pad(
                a, (0, 0, 0, 0, 0, max_len - a.shape[2]))
    return out


class SyntheticAcquisitionSource:
    """Host-side RF batch source (stand-in for a probe front end).

    Pre-generates a pool of distinct (batch, n_l, n_c, n_f) acquisitions
    and cycles it, so generation stays out of the streaming window while
    every dispatch still uploads a host buffer. Frame seeds come from
    `seed_space`, as in the reference, so both packages stream the same
    bytes for the same seed.
    """

    def __init__(self, cfg, batch: int, *, pool: int = 4, seed: int = 0):
        from repro_torch.data import seed_space, synth_rf
        self.cfg = cfg
        self.batch = batch
        self._pool = [
            np.stack([synth_rf(
                cfg, seed=seed_space("source", seed, b * batch + i))
                for i in range(batch)])
            for b in range(pool)]
        self._i = 0

    def next(self) -> np.ndarray:
        rf = self._pool[self._i % len(self._pool)]
        self._i += 1
        return rf


def serve_ultrasound_stream(cfg, *, batch: int = 4, n_batches: int = 32,
                            depth: int = 2, pool: int = 4, seed: int = 0,
                            deadline_s=None, source=None, policy=None,
                            device=None) -> dict:
    """Stream RF batches through the stage-graph engine, `depth` in flight.

    The loop blocks on the oldest in-flight batch (a CUDA event recorded
    after its work) once `depth` are queued. Completion-to-completion
    intervals are the latency samples; the per-batch deadline budget is
    ``batch * deadline_s``. Returns the reference's stats dict.
    """
    from repro_torch.bench.harness import latency_stats
    from repro_torch.core.executor import BatchedExecutor

    if batch < 1 or n_batches < 1 or depth < 1:
        raise ValueError(
            f"batch, n_batches, depth must be >= 1 "
            f"(got {batch}, {n_batches}, {depth})")

    engine = BatchedExecutor(cfg, policy=policy, device=device)
    cfg = engine.cfg
    dev = engine.device
    on_cuda = dev.type == "cuda"
    if source is None:
        source = SyntheticAcquisitionSource(cfg, batch, pool=pool, seed=seed)

    def completion():
        if not on_cuda:
            return None            # CPU work is done when the call returns
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        return ev

    # warm-up (kernel build and first launch) outside the timed window
    engine(source.next())
    if on_cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    in_flight: collections.deque = collections.deque()
    intervals = []
    t0 = time.perf_counter()
    last = t0

    def retire():
        nonlocal last
        _, ev = in_flight.popleft()
        if ev is not None:
            ev.synchronize()
        now = time.perf_counter()
        intervals.append(now - last)
        last = now

    for _ in range(n_batches):
        out = engine(source.next())
        in_flight.append((out, completion()))
        while len(in_flight) >= depth:
            retire()
    while in_flight:
        retire()
    wall = time.perf_counter() - t0

    acqs = n_batches * batch
    budget = batch * deadline_s if deadline_s is not None else None
    return {
        "name": f"stream/{cfg.name}/{cfg.variant.value}/b{batch}",
        "batch": batch, "n_batches": n_batches, "depth": depth,
        "plan": engine.plan.json_dict(),
        "wall_s": wall,
        "acquisitions": acqs,
        "frames": acqs * cfg.n_f,
        "sustained_mbps": acqs * cfg.input_bytes / (wall * 1e6),
        "fps": acqs * cfg.n_f / wall,
        "acq_per_s": acqs / wall,
        "latency": latency_stats(intervals, budget_s=budget),
        "resources": {
            "peak_memory_bytes": (int(torch.cuda.max_memory_allocated(dev))
                                  if on_cuda else None),
            "memory_source": ("torch.cuda.max_memory_allocated"
                              if on_cuda else None),
            "energy_joules": None,
            "energy_source": None,
            "devices": 1,
            "duration_s": wall,
        },
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ultrasound", action="store_true",
                    help="stream RF through the batched stage-graph engine")
    ap.add_argument("--arch", default="zamba2-1.2b",
                    help="LM: architecture (ported: zamba2-1.2b)")
    ap.add_argument("--smoke", action="store_true",
                    help="LM: the reduced same-family config")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--batches", type=int, default=32,
                    help="RF batches to stream")
    ap.add_argument("--depth", type=int, default=2,
                    help="max batches in flight")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-acquisition frame budget")
    ap.add_argument("--plan", default=None, choices=["fixed", "heuristic"],
                    help="variant-resolution policy")
    ap.add_argument("--variant", default="dynamic",
                    choices=["dynamic", "cnn", "sparse", "auto"],
                    help="operator variant (auto = planner)")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default: cuda (fails without a CUDA device)")
    args = ap.parse_args()

    if not args.ultrasound:
        from repro_torch.configs import get_config, get_smoke
        cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
        _, stats = serve_session(
            cfg, requests=args.requests, batch=args.batch,
            prompt_len=args.prompt_len, max_new=args.max_new,
            device=args.device)
        peak = stats["peak_memory_bytes"]
        print(f"served {args.requests} requests on {stats['device']}: "
              f"{stats['tokens']} tokens in {stats['wall_s']:.2f}s = "
              f"{stats['tok_per_s']:,.0f} tok/s; prefill "
              f"{np.mean(stats['prefill_s']) * 1e3:.1f} ms per slot batch, "
              f"decode {np.mean(stats['decode_s']) * 1e3:.2f} ms per step; "
              + (f"peak_mem={peak / 1e6:.1f}MB" if peak is not None
                 else "peak_mem=not measured"))
        return
    if args.variant == "auto" and args.plan == "fixed":
        ap.error("--variant auto needs --plan heuristic")

    from repro_torch.core import Variant, tiny_config
    cfg = tiny_config(nz=32, nx=32, n_f=8, n_c=16,
                      variant=Variant(args.variant))
    deadline_s = (args.deadline_ms / 1e3
                  if args.deadline_ms is not None else None)
    stats = serve_ultrasound_stream(
        cfg, batch=args.batch, n_batches=args.batches, depth=args.depth,
        policy=args.plan, deadline_s=deadline_s, device=args.device)
    lat = stats["latency"]
    plan = stats["plan"]
    print(f"plan: policy={plan['policy']} backend={plan['backend']} "
          f"variant={plan['variant']} lowerings={plan['stage_lowerings']} "
          f"({plan['provenance']})")
    print(f"{stats['name']}: {stats['acquisitions']} acquisitions "
          f"({stats['frames']} frames) in {stats['wall_s']:.2f}s = "
          f"{stats['sustained_mbps']:.2f} MB/s, {stats['fps']:.1f} FPS; "
          f"p50={lat.p50_s * 1e3:.2f}ms p95={lat.p95_s * 1e3:.2f}ms "
          f"p99={lat.p99_s * 1e3:.2f}ms jitter={lat.jitter_s * 1e3:.2f}ms "
          f"miss_rate={lat.miss_rate:.3f}")
    peak = stats["resources"]["peak_memory_bytes"]
    print("resources: " + (f"peak_mem={peak / 1e6:.1f}MB "
                           f"({stats['resources']['memory_source']})"
                           if peak is not None else "peak_mem=not measured")
          + " energy=not measured")


if __name__ == "__main__":
    main()
