"""Run a function on n CPU ranks of a gloo process group (for the port's
data-parallel tests).

`run_ranks(fn, n, tmp_dir, *args)` spawns n processes; each starts the
group from a file under ``tmp_dir`` (no port, so it is safe under
pytest-xdist), builds the mesh of n on "data" and returns ``fn(mesh,
rank, *args)``; the parent gets the n results in rank order. This module
imports neither JAX nor the reference, so the ranks start quickly.
"""

import os
import traceback

import torch
import torch.multiprocessing as mp


def _rank_main(rank, n, tmp_dir, fn, args, threads):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    torch.set_num_threads(threads)
    out = os.path.join(tmp_dir, f"rank{rank}.pt")
    try:
        dist.init_process_group(
            "gloo", init_method="file://" + os.path.join(tmp_dir, "group"),
            rank=rank, world_size=n)
        try:
            mesh = make_mesh((n, 1), ("data", "model"))
            result = fn(mesh, rank, *args)
        finally:
            dist.destroy_process_group()
        torch.save({"ok": result}, out)
    except BaseException:
        torch.save({"error": traceback.format_exc()}, out)
        raise


def start_ranks(fn, n, tmp_dir, *args, threads=1):
    """Start `run_ranks`'s n processes; `join_ranks` of the returned
    handle waits for them and returns their results."""
    tmp_dir = str(tmp_dir)
    os.makedirs(tmp_dir, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n, tmp_dir, fn, args, threads))
             for r in range(n)]
    for p in procs:
        p.start()
    return procs, tmp_dir


def join_ranks(handle, timeout=600):
    procs, tmp_dir = handle
    for p in procs:
        p.join(timeout)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    results = []
    for r, p in enumerate(procs):
        path = os.path.join(tmp_dir, f"rank{r}.pt")
        got = torch.load(path, weights_only=False) if os.path.exists(
            path) else {"error": f"rank {r} wrote nothing "
                        f"(exit {p.exitcode})"}
        if "error" in got:
            raise RuntimeError(f"rank {r} of {len(procs)} failed:\n"
                               f"{got['error']}")
        results.append(got["ok"])
    return results


def run_ranks(fn, n, tmp_dir, *args, threads=1, timeout=600):
    """[fn(mesh, rank, *args) for each rank] (module doc); raises with the
    first failing rank's traceback."""
    return join_ranks(start_ranks(fn, n, tmp_dir, *args, threads=threads),
                      timeout)


# ---------------------------------------------------------------------------
# Rank bodies (fn of `run_ranks`)
# ---------------------------------------------------------------------------


def compress_rank(mesh, rank, per_rank):
    """`compressed_psum_mean` of this rank's numpy tree, without and with
    the residual: {"mean", "mean_r", "residual"} as numpy trees."""
    from repro_torch import tree
    from repro_torch.launch.mesh import binding_for
    from repro_torch.optim.compress import compressed_psum_mean
    from repro_torch.runtime.sharding import use_binding

    grads, residual = per_rank[rank]
    as_t = lambda t: tree.map_(torch.from_numpy, t)        # noqa: E731
    as_np = lambda t: tree.map_(lambda x: x.numpy(), t)     # noqa: E731
    with use_binding(binding_for(mesh)):
        mean, none = compressed_psum_mean(as_t(grads), "data")
        mean_r, new_r = compressed_psum_mean(as_t(grads), ("data",),
                                             as_t(residual))
    assert none is None
    return {"mean": as_np(mean), "mean_r": as_np(mean_r),
            "residual": as_np(new_r)}


TRAIN = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)


def _smoke(arch, overrides):
    from repro_torch.configs import get_smoke
    return get_smoke(arch, remat=True, **overrides)


def dp_run(mesh, arch, overrides, init, shape, steps, zero1=True,
           microbatches=1):
    """The data-parallel step for ``steps`` steps from the numpy
    parameters ``init`` on TokenDataset batches of the global ``shape``:
    [(metrics, whole state as numpy)] a step, on rank 0 (None
    elsewhere)."""
    from repro_torch import checkpoint, tree
    from repro_torch.configs import TrainConfig
    from repro_torch.data import TokenDataset
    from repro_torch.launch.mesh import binding_for
    from repro_torch.models import get_model, params_from_numpy
    from repro_torch.optim import adamw_init
    from repro_torch.train.steps import make_train_step, state_blocks

    cfg = _smoke(arch, overrides)
    model = get_model(cfg, device="cpu")
    tcfg = TrainConfig(zero1=zero1, microbatches=microbatches, **TRAIN)
    params = params_from_numpy(cfg, tree.map_(lambda a: a.copy(), init),
                               device="cpu")
    blocks = state_blocks(params, tcfg, mesh)
    state = {"params": params, "opt": adamw_init(params, blocks["opt"]["m"])}
    step_fn = make_train_step(model, tcfg, mesh)
    axis = binding_for(mesh).axis_group(("data",))
    data = TokenDataset(cfg, *shape, seed=0)
    out = []
    for i in range(1, steps + 1):
        rows = data.rows_for_step(i, axis.index, axis.extent)
        state, metrics = step_fn(
            state, {k: torch.from_numpy(v) for k, v in rows.items()})
        whole = checkpoint.host_tree(state, blocks)
        if whole is not None:
            out.append(({k: float(v) for k, v in metrics.items()},
                        {k: v.numpy() for k, v in whole.items()}))
    return out or None


def remat_thread_grads(mesh, arch, overrides, init, shape):
    """The loss's gradients (remat on) on this rank's rows of step 1's
    global batch under the mesh's binding, with the backward run on this
    thread and then on another one, as autograd's device thread runs it
    on the card: two lists of numpy arrays."""
    import threading

    from repro_torch import tree
    from repro_torch.data import TokenDataset
    from repro_torch.launch.mesh import binding_for
    from repro_torch.models import get_model, params_from_numpy
    from repro_torch.runtime.sharding import use_binding

    cfg = _smoke(arch, overrides)
    model = get_model(cfg, device="cpu")
    params = params_from_numpy(cfg, tree.map_(lambda a: a.copy(), init),
                               device="cpu")
    axis = binding_for(mesh).axis_group(("data",))
    rows = TokenDataset(cfg, *shape, seed=0).rows_for_step(
        1, axis.index, axis.extent)
    batch = {k: torch.from_numpy(v) for k, v in rows.items()}
    out = []
    with use_binding(binding_for(mesh)):
        for elsewhere in (False, True):
            live = tree.map_(lambda p: p.detach().requires_grad_(), params)
            loss = model.loss_fn(live, batch)[0]
            box = []

            def backward():
                try:
                    box.append(torch.autograd.grad(loss, tree.leaves(live)))
                except BaseException as exc:    # raised below
                    box.append(exc)
            if elsewhere:
                t = threading.Thread(target=backward)
                t.start()
                t.join()
            else:
                backward()
            if isinstance(box[0], BaseException):
                raise box[0]
            out.append([g.numpy() for g in box[0]])
    return out


def dp_rank(mesh, rank, cases, refusals=False):
    """`dp_run` of every case: {name: {"on", "off"?, "mb"?, "thread"?}} on
    rank 0, and with ``refusals`` `refusals_rank`'s list under
    "refusals"."""
    out = {"refusals": refusals_rank(mesh, rank)} if refusals else {}
    for name, c in cases.items():
        runs = {"on": dp_run(mesh, c["arch"], c["overrides"], c["init"],
                             c["shape"], c["steps"])}
        if c.get("zero1_off"):
            runs["off"] = dp_run(mesh, c["arch"], c["overrides"], c["init"],
                                 c["shape"], c["steps"], zero1=False)
        if c.get("microbatches"):
            runs["mb"] = dp_run(mesh, c["arch"], c["overrides"], c["init"],
                                c["shape"], 1, microbatches=2)
        if c.get("remat_thread"):
            runs["thread"] = remat_thread_grads(
                mesh, c["arch"], c["overrides"], c["init"], c["shape"])
        out[name] = runs
    return out if rank == 0 else None


LOOP_ARCH, LOOP_SHAPE = "gemma3-1b", (4, 16)


def loop_run(mesh, root, name, steps, fail_at_step=None):
    """``train_loop`` of LOOP_ARCH at LOOP_SHAPE to ``steps`` under
    `run_resilient` (a failure at ``fail_at_step`` on the first attempt),
    checkpoints every 2 steps in ``root/name``: its metrics a step."""
    from repro_torch.configs import TrainConfig
    from repro_torch.launch.train import train_loop
    from repro_torch.runtime.fault_tolerance import run_resilient

    cfg = _smoke(LOOP_ARCH, {})
    tcfg = TrainConfig(checkpoint_every=2, seed=3, **TRAIN)
    metrics, attempts = [], []

    def attempt():
        attempts.append(1)
        train_loop(cfg, tcfg, batch=LOOP_SHAPE[0], seq=LOOP_SHAPE[1],
                   steps=steps, log_every=100,
                   ckpt_dir=os.path.join(str(root), name),
                   metrics_out=metrics, device="cpu", mesh=mesh,
                   fail_at_step=fail_at_step if len(attempts) == 1
                   else None)

    restarts = run_resilient(attempt, max_restarts=2)
    return {"metrics": metrics, "restarts": restarts}


def restored_state(mesh, root, name, step):
    """The state `train_loop` would resume from ``root/name``'s step,
    split for this mesh and gathered whole again (numpy, rank 0)."""
    from repro_torch import checkpoint, tree
    from repro_torch.configs import TrainConfig
    from repro_torch.models.api import family_module
    from repro_torch.optim import adamw_init
    from repro_torch.train.steps import state_blocks

    cfg = _smoke(LOOP_ARCH, {})
    spec = family_module(cfg).init_params(cfg, None, torch.device("meta"))
    blocks = state_blocks(spec, TrainConfig(), mesh)
    state = checkpoint.restore(
        os.path.join(str(root), name), step,
        {"params": spec, "opt": adamw_init(spec)}, device="cpu",
        shardings=blocks)
    whole = checkpoint.host_tree(state, blocks)
    split = sum(b is not None for b in tree.leaves(blocks))
    return None if whole is None else (
        {k: v.numpy() for k, v in whole.items()}, split)


def loop_rank_2(mesh, rank, root):
    """World 2: an uncut 4-step run and a run cut at step 3 and resumed
    from its step-2 checkpoint."""
    uncut = loop_run(mesh, root, "uncut", 4)
    cut = loop_run(mesh, root, "cut", 4, fail_at_step=3)
    return {"uncut": uncut, "cut": cut} if rank == 0 else None


def loop_rank_resume(mesh, rank, root):
    """Another world: the world-2 run's step-2 checkpoint restored (split
    and gathered again), then resumed in a copy to step 4."""
    import shutil
    restored = restored_state(mesh, root, "uncut", 2)
    name = f"resumed{mesh.size()}"
    if rank == 0:
        src = os.path.join(str(root), "uncut")
        os.makedirs(os.path.join(str(root), name))
        shutil.copy(os.path.join(src, "step_00000002.npz"),
                    os.path.join(str(root), name))
        with open(os.path.join(str(root), name, "MANIFEST.json"), "w") as f:
            f.write('{"latest_step": 2}')
    import torch.distributed as dist
    dist.barrier()
    resumed = loop_run(mesh, root, name, 4)
    return {"restored": restored, "resumed": resumed} if rank == 0 else None


def refusals_rank(mesh, rank):
    """What `make_mesh` and `make_production_mesh` say to the layouts
    this port does not run (None where one did not raise)."""
    from repro_torch.configs import ParallelConfig
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    out = []
    for kwargs in (dict(shape=(1, 2)), dict(shape=(2, 1),
                                            parallel=ParallelConfig(
                                                fsdp=True)),
                   dict(shape=(1, 1, 2), axes=("pod", "data", "model")),
                   dict(parallel=ParallelConfig(pod_axis_role="pipeline"))):
        try:
            make_mesh(**kwargs)
            out.append(None)
        except NotImplementedError as exc:
            out.append(str(exc))
    try:
        make_production_mesh()
        out.append(None)
    except ValueError as exc:
        out.append(str(exc))
    return out
