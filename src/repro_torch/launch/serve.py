"""Serving drivers of the PyTorch port, for both system halves.

LM half — slot-based batching, as the reference: B fixed slots, each
request batch prefills into its slots, then all slots decode in lockstep,
greedily (`serve_session`). Every architecture of the reference:
granite-moe-3b-a800m, deepseek-v2-236b (its 60 layers do not fit one
card: full width at fewer layers), zamba2-1.2b, qwen2-vl-2b (prompts
carry their patch embeddings and M-RoPE positions), qwen3-8b, gemma3-1b,
granite-3-8b, llama3-405b (smoke size only on one card), mamba2-130m and
seamless-m4t-large-v2:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \
      --smoke --requests 8 --batch 4 --prompt-len 32 --max-new 16 \
      [--device cpu]

Ultrasound half — `serve_ultrasound_stream` feeds RF batches from a
synthetic acquisition source (pinned host memory on the card) through a
`BatchedExecutor`: each batch is copied H2D anew on the executor's copy
stream (`place`) and launched after that copy's event
(`dispatch_staged`), so batch i+1's copy overlaps batch i's compute; up
to ``depth`` batches are in flight. It reports sustained MB/s / FPS,
the completion-interval latency distribution and the window's measured
resources (`repro_torch.bench.resources`: peak memory, NVML energy)
with the reference's stats keys.

  PYTHONPATH=src python -m repro_torch.launch.serve --ultrasound \
      --batch 4 --batches 32 --depth 2 [--variant dynamic|cnn|sparse|auto] \
      [--plan fixed|heuristic|autotune] [--device cpu]

``--devices N`` streams through `serve_ultrasound_sharded` instead: each
dispatch is N shards of ``--batch`` acquisitions, one a device, with
per-device in-flight queues and the scale efficiency against one device
(``--device cpu --devices 2``: two shards on the CPU).

``--multitenant`` serves N mixed-modality clients through the
dynamic-batching scheduler (`repro_torch.launch.scheduler`):

  PYTHONPATH=src python -m repro_torch.launch.serve --ultrasound \
      --multitenant --clients 4 --max-batch 4 --queue-delay-ms 5 \
      --frames 24 --in-flight 2 --drain async [--device cpu]

Everything runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import time

import numpy as np
import torch


def serve_session(cfg, *, requests: int, batch: int, prompt_len: int,
                  max_new: int, seed: int = 0, params=None, device=None):
    """Process ``requests`` prompts in slot batches of ``batch``.

    Prompts are ``synth_train_batch(cfg, bsz, prompt_len, seed + r0)``, as
    in the reference: a VLM prompt carries its patch embeddings and M-RoPE
    positions (its text sits at positions ``side + i``; decode goes on
    from ``prompt_len``, the reference's, ROADMAP C); for the enc-dec
    family ``prompt_len`` is the encoder's frame count, and its prefill
    hands back a decode-ready cache at position 1 (BOS consumed). An MoE's
    capacity depends on the slot batch, as in the reference.
    ``params`` defaults to ``init_params(seed)`` (the port's draws; pass
    ``params_from_numpy`` of the reference's to serve the same weights).
    Returns (generated tokens (requests, max_new + 1) int32 array, stats
    dict): the reference's keys, plus the host-clock time of each slot
    batch's prefill (the first token included) and of each decode step,
    and the peak device memory (None on the CPU).
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
        if cfg.family == "audio":
            # enc-dec prefill returns a decode-ready cache (BOS consumed)
            lengths = torch.ones((bsz,), dtype=torch.int32, device=dev)
        else:
            # decoder-only: extend the prefilled cache to serving length
            cache = _grow_cache(model, cache, max_len)
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


def _grow_cache(model, cache, max_len: int):
    """Pad every leaf's sequence axis with zeros to ``max_len``.

    The sequence axis is found from the family, as the reference's: its
    ``cache_specs(seq_sharded=True)`` names it "seq" (the transformer's
    k/v and zamba2's attn_k/attn_v, (L, B, S, hkv, dh)). Leaves without
    one (SSM and conv states) pass through untouched.
    """
    def grow(spec, a):
        if isinstance(spec, dict):
            return {k: grow(spec[k], a[k]) for k in a}
        if "seq" not in spec:
            return a
        i = spec.index("seq")
        if a.shape[i] >= max_len:
            return a
        pad = [0, 0] * (a.ndim - 1 - i) + [0, max_len - a.shape[i]]
        return torch.nn.functional.pad(a, pad)

    return grow(model.cache_specs(seq_sharded=True), cache)


class SyntheticAcquisitionSource:
    """Host-side RF batch source (stand-in for a probe front end).

    Pre-generates a pool of distinct (batch, n_l, n_c, n_f) acquisitions
    and cycles it, so generation stays out of the streaming window while
    every dispatch still uploads a host buffer. With ``pin_memory`` the
    pool lives in page-locked memory (numpy views of pinned tensors), so
    the upload is an asynchronous DMA; a source that serves the card
    should pin. Frame seeds come from `seed_space`, as in the reference,
    so both packages stream the same bytes for the same seed.
    """

    def __init__(self, cfg, batch: int, *, pool: int = 4, seed: int = 0,
                 pin_memory: bool = False):
        from repro_torch.data import seed_space, synth_rf
        self.cfg = cfg
        self.batch = batch
        self._pool = []
        for b in range(pool):
            rf = np.stack([synth_rf(
                cfg, seed=seed_space("source", seed, b * batch + i))
                for i in range(batch)])
            if pin_memory:
                t = torch.from_numpy(rf).pin_memory()
                rf = t.numpy()
            self._pool.append(rf)
        self._i = 0

    def next(self) -> np.ndarray:
        rf = self._pool[self._i % len(self._pool)]
        self._i += 1
        return rf


def serve_ultrasound_stream(cfg, *, batch: int = 4, n_batches: int = 32,
                            depth: int = 2, pool: int = 4, seed: int = 0,
                            deadline_s=None, source=None, plan=None,
                            policy=None, device=None) -> dict:
    """Stream RF batches through the stage-graph engine, `depth` in flight.

    Each batch is placed (H2D on the executor's copy stream, never
    cached on the device) and dispatched behind its copy event; the loop
    blocks on the oldest in-flight batch (a CUDA event recorded after
    its work) once `depth` are queued. Completion-to-completion
    intervals are the latency samples; the per-batch deadline budget is
    ``batch * deadline_s``. The resource meter is built before warm-up
    (the NVML idle baseline sees the board cold). Returns the
    reference's stats dict.
    """
    from repro_torch.bench.harness import latency_stats
    from repro_torch.bench.resources import ResourceMeter
    from repro_torch.core.executor import BatchedExecutor
    from repro_torch.core.pipeline import _resolve_plan, resolve_device

    if batch < 1 or n_batches < 1 or depth < 1:
        raise ValueError(
            f"batch, n_batches, depth must be >= 1 "
            f"(got {batch}, {n_batches}, {depth})")

    if plan is None:            # autotune probes the batch served here
        plan = _resolve_plan(cfg, None, policy, resolve_device(device).type,
                             batch=batch)
    engine = BatchedExecutor(cfg, plan=plan, device=device)
    cfg = engine.cfg
    dev = engine.device
    on_cuda = dev.type == "cuda"
    if source is None:
        source = SyntheticAcquisitionSource(cfg, batch, pool=pool, seed=seed,
                                            pin_memory=on_cuda)
    meter = ResourceMeter(dev)

    def dispatch():
        return engine.dispatch_staged(engine.place(source.next()), batch)

    def completion():
        if not on_cuda:
            return None            # CPU work is done when the call returns
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        return ev

    # warm-up (kernel build and first launch) outside the timed window
    dispatch()
    meter.start()
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
        meter.sample()

    for _ in range(n_batches):
        out = dispatch()
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
        "resources": meter.stop().json_dict(),
    }


def serve_ultrasound_sharded(cfg, *, batch_per_device: int = 4,
                             n_batches: int = 32, depth: int = 2,
                             pool: int = 4, seed: int = 0,
                             deadline_s=None, devices=None, source=None,
                             plan=None, policy=None,
                             baseline_fps=None) -> dict:
    """Stream RF through the `ShardedExecutor`, per-device in-flight queues.

    Every dispatch carries ``batch_per_device * n_devices`` acquisitions,
    split into contiguous shards, one a device (``devices=None``: every
    CUDA device). Each shard's output, with the event recorded after it
    on its shard's stream, goes onto that device's in-flight queue; once
    ``depth`` dispatches are queued the loop retires the oldest shard of
    each device, polling the events, so per-device completion intervals
    (and stragglers) are observable one by one.

    Scale efficiency: ``baseline_fps`` is the one-device sustained FPS at
    the same per-device batch (measured with `serve_ultrasound_stream` on
    the first device when not given);
    ``speedup_vs_single = fps / baseline_fps`` and ``scale_efficiency =
    speedup_vs_single / n_devices``, both None without a baseline.

    Returns the stats of `serve_ultrasound_stream` plus ``devices``,
    ``batch_per_device``, ``per_device_latency`` (keyed
    ``"<shard>:<device>"``, since a device may repeat),
    ``baseline_fps``, ``speedup_vs_single`` and ``scale_efficiency``;
    ``plan`` carries the device topology, ``resources`` the first
    device's peak memory and energy.
    """
    from repro_torch.bench.harness import latency_stats
    from repro_torch.bench.resources import ResourceMeter
    from repro_torch.core.executor import ShardedExecutor, resolve_devices
    from repro_torch.core.pipeline import _resolve_plan

    if batch_per_device < 1 or n_batches < 1 or depth < 1:
        raise ValueError(
            f"batch_per_device, n_batches, depth must be >= 1 "
            f"(got {batch_per_device}, {n_batches}, {depth})")

    if plan is None:            # autotune probes one device's shard
        kind = (resolve_devices(devices)[0].type if devices is not None
                else "cuda")
        plan = _resolve_plan(cfg, None, policy, kind,
                             batch=batch_per_device)
    engine = ShardedExecutor(cfg, devices=devices, plan=plan)
    cfg = engine.cfg
    n_dev = engine.n_devices
    batch = batch_per_device * n_dev
    on_cuda = engine.device.type == "cuda"
    # built before the baseline and the warm-up heat the board, so the
    # NVML idle baseline sees it cold
    meter = ResourceMeter(engine.device)

    if baseline_fps is None:
        # the same decisions, stamped with the one device it runs on
        baseline_plan = dataclasses.replace(engine.plan, devices=1,
                                            mesh_shape=None)
        baseline_fps = serve_ultrasound_stream(
            cfg, batch=batch_per_device, n_batches=n_batches, depth=depth,
            pool=pool, seed=seed, deadline_s=deadline_s,
            plan=baseline_plan, device=engine.device)["fps"]

    if source is None:
        source = SyntheticAcquisitionSource(cfg, batch, pool=pool, seed=seed,
                                            pin_memory=on_cuda)

    # warm-up (kernel build, first launch): one round trip, untimed
    engine.gather(engine.dispatch(source.next()))
    for d in set(engine.devices) if on_cuda else ():
        torch.cuda.synchronize(d)

    queues = [collections.deque() for _ in engine.devices]
    dev_intervals = [[] for _ in engine.devices]
    intervals = []                     # global: all shards of a dispatch

    meter.start()
    t0 = time.perf_counter()
    last_dev = [t0] * n_dev
    last_global = t0

    def drain_one():
        """Retire the oldest in-flight shard of every device, by polling
        their events: a straggler stretches its own interval only."""
        nonlocal last_global
        pending = {i: q.popleft() for i, q in enumerate(queues)}
        while pending:
            for i in list(pending):
                ev = pending[i].done_event
                if ev is None or ev.query():
                    now = time.perf_counter()
                    dev_intervals[i].append(now - last_dev[i])
                    last_dev[i] = now
                    del pending[i]
            if pending:
                time.sleep(1e-4)
        now = time.perf_counter()
        intervals.append(now - last_global)
        last_global = now
        meter.sample()

    for _ in range(n_batches):
        for i, shard in enumerate(engine.dispatch(source.next())):
            queues[i].append(shard)
        while len(queues[0]) >= depth:
            drain_one()
    while queues[0]:
        drain_one()
    wall = time.perf_counter() - t0

    acqs = n_batches * batch
    fps = acqs * cfg.n_f / wall
    budget = batch * deadline_s if deadline_s is not None else None
    speedup = fps / baseline_fps if baseline_fps else None
    return {
        "name": (f"stream/{cfg.name}/{cfg.variant.value}"
                 f"/b{batch_per_device}xd{n_dev}"),
        "devices": n_dev,
        "batch_per_device": batch_per_device,
        "batch": batch, "n_batches": n_batches, "depth": depth,
        "plan": engine.plan.json_dict(),
        "wall_s": wall,
        "acquisitions": acqs,
        "frames": acqs * cfg.n_f,
        "sustained_mbps": acqs * cfg.input_bytes / (wall * 1e6),
        "fps": fps,
        "acq_per_s": acqs / wall,
        "latency": latency_stats(intervals, budget_s=budget),
        "per_device_latency": {
            f"{i}:{d}": latency_stats(dev_intervals[i]).json_dict()
            for i, d in enumerate(engine.devices)},
        "baseline_fps": baseline_fps,
        "speedup_vs_single": speedup,
        "scale_efficiency": (speedup / n_dev
                             if speedup is not None else None),
        "resources": meter.stop().json_dict(),
    }


def _print_resources(res: dict) -> None:
    peak = res["peak_memory_bytes"]
    energy = res["energy_joules"]
    print("resources: "
          + (f"peak_mem={peak / 1e6:.1f}MB ({res['memory_source']})"
             if peak is not None else "peak_mem=not measured")
          + (f" energy={energy:.3f}J above idle "
             f"{res['idle_power_w']:.1f}W over {res['duration_s']:.2f}s "
             f"({res['energy_samples']} NVML samples)"
             if energy is not None else " energy=not measured"))


def _cli_devices(args, ap):
    """``--devices N`` as a device list (None: unset): the first N CUDA
    devices, or with ``--device cpu`` the CPU N times (N shards of one
    batch on the CPU)."""
    if args.devices is None:
        return None
    if args.devices < 1:
        ap.error(f"--devices must be >= 1 (got {args.devices})")
    if args.device == "cpu":
        return ["cpu"] * args.devices
    have = torch.cuda.device_count()
    if args.devices > have:
        ap.error(f"--devices {args.devices} > {have} CUDA devices "
                 "(--device cpu runs N shards on the CPU)")
    return [f"cuda:{i}" for i in range(args.devices)]


def _serve_multitenant_cli(args, ap) -> None:
    from repro_torch.core import Modality, Variant, tiny_config
    from repro_torch.launch.scheduler import (BatchPolicy,
                                              make_mixed_streams,
                                              serve_multitenant)
    if args.clients < 1:
        ap.error(f"--clients must be >= 1 (got {args.clients})")
    cfg = tiny_config(nz=32, nx=32, n_f=8, n_c=16,
                      variant=Variant(args.variant))
    streams = make_mixed_streams(
        args.clients, cfg, cfg.with_(modality=Modality.DOPPLER),
        n_frames=args.frames, deadline_ms=args.deadline_ms)
    stats = serve_multitenant(
        streams, policy=BatchPolicy(args.max_batch, args.queue_delay_ms),
        in_flight=args.in_flight, drain=args.drain,
        devices=_cli_devices(args, ap), plan_policy=args.plan,
        device=args.device)
    lat, qd = stats["latency"], stats["queue_delay"]
    occ, ifo = stats["occupancy"], stats["in_flight_occupancy"]
    print(f"{stats['name']}: {stats['acquisitions']} acquisitions "
          f"({stats['frames']} frames) from {stats['clients']} clients in "
          f"{stats['wall_s']:.2f}s = {stats['sustained_mbps']:.2f} MB/s, "
          f"{stats['fps']:.1f} FPS (warm-up {stats['warmup_s']:.2f}s "
          "ahead of window)")
    print(f"overlap: in_flight={stats['in_flight']} "
          f"mean_depth={ifo['mean_depth']:.2f} "
          f"device_busy={stats['device_busy_frac']:.2f} "
          f"overlap_frac={stats['overlap_frac']:.2f}")
    print(f"transfer: drain={stats['drain']} "
          f"stage_copy={stats['stage_copy_s'] * 1e3:.2f}ms "
          f"h2d={stats['h2d_s'] * 1e3:.2f}ms "
          f"d2h={stats['d2h_s'] * 1e3:.2f}ms "
          f"transfer_frac={stats['transfer_frac']:.3f}")
    print(f"latency: p50={lat['p50_s'] * 1e3:.2f}ms "
          f"p95={lat['p95_s'] * 1e3:.2f}ms p99={lat['p99_s'] * 1e3:.2f}ms; "
          f"queue delay p50={qd['p50_s'] * 1e3:.2f}ms "
          f"p95={qd['p95_s'] * 1e3:.2f}ms; "
          f"occupancy={occ['mean_occupancy']:.2f}/{occ['max_batch']} "
          f"(fill {occ['mean_fill']:.2f}); "
          f"miss_rate={stats['deadline_miss_rate']:.3f}")
    _print_resources(stats["resources"])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ultrasound", action="store_true",
                    help="stream RF through the batched stage-graph engine")
    ap.add_argument("--arch", default="zamba2-1.2b",
                    help="LM: architecture (granite-moe-3b-a800m, "
                    "deepseek-v2-236b, zamba2-1.2b, qwen2-vl-2b, qwen3-8b, "
                    "gemma3-1b, granite-3-8b, llama3-405b, mamba2-130m, "
                    "seamless-m4t-large-v2)")
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
    ap.add_argument("--devices", type=int, default=None,
                    help="ultrasound: shard each batch over N devices "
                         "(--batch becomes per-device; with "
                         "--multitenant, --max-batch must divide by N; "
                         "with --device cpu, N shards on the CPU)")
    ap.add_argument("--plan", default=None,
                    choices=["fixed", "heuristic", "autotune"],
                    help="variant-resolution policy")
    ap.add_argument("--variant", default="dynamic",
                    choices=["dynamic", "cnn", "sparse", "auto"],
                    help="operator variant (auto = planner)")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default: cuda (fails without a CUDA device)")
    ap.add_argument("--multitenant", action="store_true",
                    help="ultrasound: N mixed-modality clients through the "
                         "dynamic-batching scheduler")
    ap.add_argument("--clients", type=int, default=4,
                    help="multitenant: number of probe clients")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="multitenant: coalescing ceiling (padded "
                         "dispatch shape)")
    ap.add_argument("--queue-delay-ms", type=float, default=5.0,
                    help="multitenant: max wait of the oldest queued "
                         "frame before a partial batch flushes")
    ap.add_argument("--frames", type=int, default=24,
                    help="multitenant: acquisitions per client")
    ap.add_argument("--in-flight", type=int, default=2,
                    help="multitenant: dispatch-pipelining depth (1 = "
                         "synchronous launch-block-retire)")
    ap.add_argument("--drain", default="async", choices=["async", "block"],
                    help="multitenant: D2H retirement mode (async = "
                         "pinned copy on the copy stream at detection, "
                         "block = synchronous copy)")
    args = ap.parse_args()

    if not (args.ultrasound or args.multitenant):
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
        ap.error("--variant auto needs --plan heuristic or autotune")
    if args.multitenant:
        _serve_multitenant_cli(args, ap)
        return

    from repro_torch.core import Variant, tiny_config
    cfg = tiny_config(nz=32, nx=32, n_f=8, n_c=16,
                      variant=Variant(args.variant))
    deadline_s = (args.deadline_ms / 1e3
                  if args.deadline_ms is not None else None)
    devices = _cli_devices(args, ap)
    if devices is not None:
        stats = serve_ultrasound_sharded(
            cfg, batch_per_device=args.batch, n_batches=args.batches,
            depth=args.depth, policy=args.plan, devices=devices,
            deadline_s=deadline_s)
    else:
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
    if devices is not None:
        eff = stats["scale_efficiency"]
        print(f"sharded over {stats['devices']} device(s): baseline "
              f"{stats['baseline_fps']:.1f} FPS on one, speedup "
              f"{stats['speedup_vs_single']:.2f}x, scale efficiency "
              f"{eff:.2f}; per device p50 "
              + ", ".join(f"{d} {v['p50_s'] * 1e3:.2f}ms" for d, v in
                          stats["per_device_latency"].items()))
    _print_resources(stats["resources"])


if __name__ == "__main__":
    main()
