"""Run a function on n CPU ranks of a gloo process group (for the port's
data-parallel tests).

`run_ranks(fn, n, tmp_dir, *args, shape=None)` spawns n processes; each
starts the group from a file under ``tmp_dir`` (no port, so it is safe
under pytest-xdist), builds the mesh of ``shape`` on ("data", "model"),
or on ("pod", "data", "model") for a shape of three (default (n, 1):
every rank on "data") and returns ``fn(mesh, rank,
*args)``; the parent gets the n results in rank order. This module
imports neither JAX nor the reference, so the ranks start quickly.
"""

import functools
import os
import pickle
import traceback

import torch
import torch.multiprocessing as mp


def _rank_main(rank, n, tmp_dir, threads, shape):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    torch.set_num_threads(threads)
    out = os.path.join(tmp_dir, f"rank{rank}.pt")
    try:
        with open(os.path.join(tmp_dir, "args.pkl"), "rb") as f:
            fn, args = pickle.load(f)
        dist.init_process_group(
            "gloo", init_method="file://" + os.path.join(tmp_dir, "group"),
            rank=rank, world_size=n)
        try:
            shape = tuple(shape or (n, 1))
            mesh = make_mesh(shape, _AXES[3 - len(shape):])
            result = fn(mesh, rank, *args)
        finally:
            dist.destroy_process_group()
        torch.save({"ok": result}, out)
    except BaseException:
        torch.save({"error": traceback.format_exc()}, out)
        raise


_AXES = ("pod", "data", "model")


def _batch_axis(mesh):
    """The ranks that split the batch: the "batch" rule's group
    ("data", or ("pod", "data") on a mesh with a "pod" axis)."""
    from repro_torch.launch.mesh import binding_for
    binding = binding_for(mesh)
    return binding.axis_group(binding.rules["batch"])


def start_ranks(fn, n, tmp_dir, *args, threads=1, shape=None):
    """Start `run_ranks`'s n processes; `join_ranks` of the returned
    handle waits for them and returns their results."""
    tmp_dir = str(tmp_dir)
    os.makedirs(tmp_dir, exist_ok=True)
    # the function and its arguments go through a file: a spawned
    # process's start waits until the child has read what it is handed,
    # which it reads only after importing what unpickling it needs
    with open(os.path.join(tmp_dir, "args.pkl"), "wb") as f:
        pickle.dump((fn, args), f)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n, tmp_dir, threads, shape))
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


def run_ranks(fn, n, tmp_dir, *args, threads=1, timeout=600, shape=None):
    """[fn(mesh, rank, *args) for each rank] (module doc); raises with the
    first failing rank's traceback."""
    return join_ranks(start_ranks(fn, n, tmp_dir, *args, threads=threads,
                                  shape=shape), timeout)


# ---------------------------------------------------------------------------
# Rank bodies (fn of `run_ranks`)
# ---------------------------------------------------------------------------


def compress_rank(mesh, rank, per_rank, axes=("data",)):
    """`compressed_psum_mean` over the mesh axes ``axes`` of this rank's
    numpy tree, without and with the residual: {"mean", "mean_r",
    "residual"} as numpy trees."""
    from repro_torch import tree
    from repro_torch.launch.mesh import binding_for
    from repro_torch.optim.compress import compressed_psum_mean
    from repro_torch.runtime.sharding import use_binding

    grads, residual = per_rank[rank]
    as_t = lambda t: tree.map_(torch.from_numpy, t)        # noqa: E731
    as_np = lambda t: tree.map_(lambda x: x.numpy(), t)     # noqa: E731
    with use_binding(binding_for(mesh)):
        mean, none = compressed_psum_mean(
            as_t(grads), axes[0] if len(axes) == 1 else axes)
        mean_r, new_r = compressed_psum_mean(as_t(grads), tuple(axes),
                                             as_t(residual))
    assert none is None
    return {"mean": as_np(mean), "mean_r": as_np(mean_r),
            "residual": as_np(new_r)}


TRAIN = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)


def _smoke(arch, overrides):
    from repro_torch.configs import get_smoke
    return get_smoke(arch, remat=True, **overrides)


def dp_run(mesh, arch, overrides, init, shape, steps, zero1=True,
           microbatches=1, fsdp=False):
    """The data-parallel step for ``steps`` steps from the numpy
    parameters ``init`` on TokenDataset batches of the global ``shape``
    (with ``fsdp``, under ``ParallelConfig(fsdp=True)``):
    [(metrics, whole state as numpy)] a step, on rank 0 (None
    elsewhere)."""
    from repro_torch import checkpoint, tree
    from repro_torch.configs import ParallelConfig, TrainConfig
    from repro_torch.data import TokenDataset
    from repro_torch.models import get_model, params_from_numpy
    from repro_torch.optim import adamw_init
    from repro_torch.train.steps import (make_train_step, moment_blocks,
                                         state_blocks)

    cfg = _smoke(arch, overrides)
    model = get_model(cfg, device="cpu")
    tcfg = TrainConfig(zero1=zero1, microbatches=microbatches, **TRAIN)
    parallel = ParallelConfig(fsdp=fsdp)
    blocks = state_blocks(cfg, tcfg, mesh, parallel)
    params = params_from_numpy(cfg, tree.map_(lambda a: a.copy(), init),
                               device="cpu", shards=blocks["params"])
    state = {"params": params, "opt": adamw_init(params,
                                                 moment_blocks(blocks))}
    step_fn = make_train_step(model, tcfg, mesh, parallel)
    axis = _batch_axis(mesh)
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
    axis = _batch_axis(mesh)
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


def loop_run(mesh, root, name, steps, fail_at_step=None, arch=LOOP_ARCH,
             overrides=None, parallel=None):
    """``train_loop`` of ``arch`` (``overrides`` on its smoke config) at
    LOOP_SHAPE to ``steps`` under `run_resilient` (a failure at
    ``fail_at_step`` on the first attempt) and ``parallel``, checkpoints
    every 2 steps in ``root/name``: its metrics a step."""
    from repro_torch.configs import TrainConfig
    from repro_torch.launch.train import train_loop
    from repro_torch.runtime.fault_tolerance import run_resilient

    cfg = _smoke(arch, overrides or {})
    tcfg = TrainConfig(checkpoint_every=2, seed=3, **TRAIN)
    metrics, attempts = [], []

    def attempt():
        attempts.append(1)
        train_loop(cfg, tcfg, batch=LOOP_SHAPE[0], seq=LOOP_SHAPE[1],
                   steps=steps, log_every=100,
                   ckpt_dir=os.path.join(str(root), name),
                   metrics_out=metrics, device="cpu", mesh=mesh,
                   parallel=parallel,
                   fail_at_step=fail_at_step if len(attempts) == 1
                   else None)

    restarts = run_resilient(attempt, max_restarts=2)
    return {"metrics": metrics, "restarts": restarts}


def restored_state(mesh, root, name, step, arch=LOOP_ARCH, overrides=None,
                   parallel=None):
    """The state `train_loop` would resume from ``root/name``'s step,
    split for this mesh (under ``parallel``) and gathered whole again
    (numpy, rank 0), and the number of leaves split."""
    from repro_torch import checkpoint, tree
    from repro_torch.configs import TrainConfig
    from repro_torch.models.api import family_module
    from repro_torch.optim import adamw_init
    from repro_torch.train.steps import state_blocks

    cfg = _smoke(arch, overrides or {})
    spec = family_module(cfg).init_params(cfg, None, torch.device("meta"))
    blocks = state_blocks(cfg, TrainConfig(), mesh, parallel)
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
    this port does not run (None where one did not raise) or, where one
    builds, the mesh's axes and its binding's "batch" and "fsdp" rules
    (a pipeline "pod" binds as data); then the axes of the (data 1,
    model 2) and (data 2, model 1) meshes that `make_mesh` builds."""
    from repro_torch.configs import ParallelConfig
    from repro_torch.launch.mesh import (binding_for, make_mesh,
                                         make_production_mesh, mesh_axes)
    out = []
    pod = (2, 1, 1), ("pod", "data", "model")
    for shape, axes, parallel in (
            ((1, 2), ("data", "expert"), None), pod + (None,),
            pod + (ParallelConfig(pod_axis_role="pipeline"),)):
        try:
            built = make_mesh(shape, axes)
            rules = binding_for(built, parallel).rules
            out.append((mesh_axes(built), rules["batch"], rules["fsdp"]))
        except NotImplementedError as exc:
            out.append(str(exc))
    try:
        make_production_mesh()
        out.append(None)
    except ValueError as exc:
        out.append(str(exc))
    out.append(mesh_axes(make_mesh((1, 2), ("data", "model"))))
    out.append(mesh_axes(make_mesh((2, 1), ("data", "model"))))
    return out


# ---------------------------------------------------------------------------
# Tensor parallelism (tests/test_torch_tp.py)
# ---------------------------------------------------------------------------


def _mesh_of(mesh, shape):
    """``mesh`` where it has ``shape``, else a new mesh of ``shape`` over
    the same ranks (on ("pod", "data", "model") for a shape of three)."""
    from repro_torch.launch.mesh import make_mesh
    if tuple(mesh.mesh.shape) == tuple(shape):
        return mesh
    return make_mesh(shape, _AXES[3 - len(shape):])


def _smoke_params(cfg, seed=0):
    from repro_torch.models import get_model
    return get_model(cfg, device="cpu").init_params(seed)


def tp_forward(mesh, seed=0):
    """The forward-only cases on this rank's pieces under the mesh's
    binding (``mesh`` None: on one device), each from the whole smoke
    parameters of ``seed`` (the same on every rank) and inputs drawn by
    numpy from ``seed``: {"mlp", "embed", "xent", "xent_masked", "attn",
    "ssm"} as numpy."""
    import numpy as np

    from repro_torch import tree
    from repro_torch.configs import TrainConfig
    from repro_torch.launch.mesh import binding_for
    from repro_torch.models import attention, common, ssm
    from repro_torch.runtime.sharding import use_binding
    from repro_torch.train.steps import state_blocks

    rng = np.random.default_rng(seed)
    out = {}

    def local(cfg):
        whole = _smoke_params(cfg, seed)
        shards = state_blocks(cfg, TrainConfig(), mesh)["params"]
        return tree.map_(lambda p, s: p if s is None else
                         s.take(p).contiguous(), whole, shards)

    x = torch.from_numpy(rng.standard_normal((2, 16, 64)).astype(np.float32))
    with use_binding(None if mesh is None else binding_for(mesh)):
        gemma = _smoke("gemma3-1b", {})
        p = local(gemma)
        lp = common.layer(p["layers"], 0)
        out["mlp"] = common.mlp_apply(lp["mlp"], x, gemma.d_ff)
        pos = common.positions_of(x[..., 0])
        out["attn"] = attention.gqa_attention(lp["attn"], gemma, x, pos)

        qwen = _smoke("qwen3-8b", {})
        p = local(qwen)
        tokens = torch.from_numpy(rng.integers(0, qwen.vocab_size, (2, 16)))
        labels = torch.from_numpy(rng.integers(0, qwen.vocab_size, (2, 16)))
        mask = torch.from_numpy((rng.random((2, 16)) < 0.7).astype(
            np.int32))
        out["embed"] = common.embed_tokens(p["embed"], tokens, qwen)
        logits = common.logits_from_hidden(p["embed"], qwen, x)
        split = common.vocab_split(p["embed"], qwen)
        out["xent"] = common.softmax_xent(logits, labels, split=split)
        out["xent_masked"] = common.softmax_xent(logits, labels, mask,
                                                 split=split)

        mamba = _smoke("mamba2-130m", {})
        p = local(mamba)
        out["ssm"] = ssm.ssm_apply(common.layer(p["layers"], 0)["ssm"],
                                   mamba, x)
    return {k: v.detach().numpy() for k, v in out.items()}


def _tool():
    """tools/dist_train_scaling.py as a module."""
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "..", "tools"))
    import dist_train_scaling
    return dist_train_scaling


def tp_fault(mesh, fault, arch, init, shape, overrides=None):
    """`dp_run` of one step with ``fault`` (tools/dist_train_scaling.py's
    `fault_in`): "kv_unsummed" (the "model" sum of the attention's
    shared wk / wv gradients left out), "local_norm" (the SSM's gated
    norm over the rank's width only), "experts_input_uncopied" or
    "combine_weights_uncopied" (the experts' input or the combine
    weights without their backward "model" sum), "whole_summed" (a
    whole leaf's gradient summed over "model") or "rows_unsummed" (the
    ``attn_batch`` fallback's "model" sum left out)."""
    with _tool().fault_in(fault):
        return dp_run(mesh, arch, overrides or {}, init, shape, 1)


def tp_rank(mesh, rank, shapes, cases, extras=()):
    """For each mesh shape of ``shapes`` (over this group): `dp_run` of
    every case of ``cases`` ({name: {"arch", "overrides", "init",
    "shape", "steps"}})
    and, where ``extras`` names them, "forward" (`tp_forward`) and
    "faults" (`tp_fault` of gemma3 and mamba2 at the mesh). Rank 0:
    {shape: {name: result}}."""
    out = {}
    for shape in shapes:
        m = _mesh_of(mesh, shape)
        got = {name: dp_run(m, c["arch"], c["overrides"], c["init"],
                            c["shape"], c["steps"])
               for name, c in cases.items()}
        if "forward" in extras:
            got["forward"] = tp_forward(m)
        if "faults" in extras:
            for fault, name in (("kv_unsummed", "gemma3"),
                                ("local_norm", "mamba2")):
                c = cases[name]
                got[fault] = tp_fault(m, fault, c["arch"], c["init"],
                                      c["shape"])
        out[tuple(shape)] = got
    return out if rank == 0 else None


TP_LOOP = "tp_uncut"


def tp_loop_rank(mesh, rank, root):
    """At (1, 2): an uncut 4-step `train_loop` of LOOP_ARCH and one cut
    by a failure at step 3 and resumed from its step-2 checkpoint; then
    at (2, 1), on the same ranks, the uncut run's step-2 checkpoint
    restored (split and gathered again) and resumed in a copy to step 4.
    """
    import shutil

    import torch.distributed as dist
    uncut = loop_run(mesh, root, TP_LOOP, 4)
    cut = loop_run(mesh, root, "tp_cut", 4, fail_at_step=3)
    dp = _mesh_of(mesh, (2, 1))
    restored = restored_state(dp, root, TP_LOOP, 2)
    name = "tp_resumed21"
    if rank == 0:
        os.makedirs(os.path.join(str(root), name))
        shutil.copy(os.path.join(str(root), TP_LOOP, "step_00000002.npz"),
                    os.path.join(str(root), name))
        with open(os.path.join(str(root), name, "MANIFEST.json"), "w") as f:
            f.write('{"latest_step": 2}')
    dist.barrier()
    resumed = loop_run(dp, root, name, 4)
    return (dict(uncut=uncut, cut=cut, restored=restored, resumed=resumed)
            if rank == 0 else None)


# ---------------------------------------------------------------------------
# The experts over "model" (tests/test_torch_ep.py)
# ---------------------------------------------------------------------------


EP_FAULTS = ("experts_input_uncopied", "combine_weights_uncopied")


def ep_rank(mesh, rank, shapes, cases, faults=None):
    """For each mesh shape of ``shapes`` (over this group): `dp_run` of
    every case of ``cases`` ({name: {"arch", "overrides", "init",
    "shape", "steps", "meshes"}}) whose "meshes" name it, with whether
    every rank of "model" routed each token alike (the tool's
    `routes_agree`); with ``faults`` (mesh shape, case name), at that
    mesh one step of that case under each of EP_FAULTS. Rank 0: {shape:
    {name: (runs, routes agree), fault: runs}}."""
    tool = _tool()
    out = {}
    for shape in shapes:
        m = _mesh_of(mesh, shape)
        got = {}
        for name, c in cases.items():
            if tuple(shape) not in c["meshes"]:
                continue
            with tool.routes_recorded() as seen:
                runs = dp_run(m, c["arch"], c["overrides"], c["init"],
                              c["shape"], c["steps"])
            got[name] = (runs, tool.routes_agree(seen, m))
        if faults is not None and faults[0] == tuple(shape):
            c = cases[faults[1]]
            for fault in EP_FAULTS:
                got[fault] = tp_fault(m, fault, c["arch"], c["init"],
                                      c["shape"], c["overrides"])
        out[tuple(shape)] = got
    return out if rank == 0 else None


EP_LOOP = "ep_uncut"


def ep_loop_rank(mesh, rank, root, arch, overrides):
    """World 4: an uncut 4-step `train_loop` of ``arch`` at (1, 4); then
    at (2, 2) its step-2 checkpoint restored (split and gathered again)
    and resumed in a copy to step 4."""
    import shutil

    import torch.distributed as dist
    ep = _mesh_of(mesh, (1, 4))
    uncut = loop_run(ep, root, EP_LOOP, 4, arch=arch, overrides=overrides)
    dp = _mesh_of(mesh, (2, 2))
    restored = restored_state(dp, root, EP_LOOP, 2, arch, overrides)
    name = "ep_resumed22"
    if rank == 0:
        os.makedirs(os.path.join(str(root), name))
        shutil.copy(os.path.join(str(root), EP_LOOP, "step_00000002.npz"),
                    os.path.join(str(root), name))
        with open(os.path.join(str(root), name, "MANIFEST.json"), "w") as f:
            f.write('{"latest_step": 2}')
    dist.barrier()
    resumed = loop_run(dp, root, name, 4, arch=arch, overrides=overrides)
    return (dict(uncut=uncut, restored=restored, resumed=resumed)
            if rank == 0 else None)


# ---------------------------------------------------------------------------
# FSDP (tests/test_torch_fsdp.py)
# ---------------------------------------------------------------------------


FSDP_FAULTS = ("fsdp_unsummed", "fsdp_cached")
FSDP_LOOP = "fsdp_uncut"


def fsdp_rank(mesh, rank, shapes, cases, extras=None):
    """For each mesh shape of ``shapes`` (over this group): `dp_run`
    with FSDP of every case of ``cases`` ({name: {"arch", "overrides",
    "init", "shapes": {mesh shape: global batch}, "steps"}}) that names
    the mesh. ``extras`` ({mesh shape: {kind: (case, arg)}}) adds at that
    mesh, on that case: "mb" (2 microbatches, at the global batch
    ``arg``), "faults" (one run a fault of FSDP_FAULTS, the tool's
    `fault_in`, at ``arg``), "plain" (FSDP on and off at ``arg``, on a
    mesh of "data" extent 1, where they agree bit for bit), "save" (a
    4-step `train_loop` with FSDP saving at step 2 in the directory
    ``arg``) and "resume" (that save restored with FSDP, split and
    gathered again, and resumed to step 4). Rank 0: {shape: {name:
    result}}."""
    from repro_torch.configs import ParallelConfig
    fsdp = ParallelConfig(fsdp=True)
    out = {}
    for shape in shapes:
        m = _mesh_of(mesh, shape)
        got = {}
        for name, c in cases.items():
            if tuple(shape) in c["shapes"]:
                got[name] = dp_run(m, c["arch"], c["overrides"], c["init"],
                                   c["shapes"][tuple(shape)], c["steps"],
                                   fsdp=True)
        for kind, (name, arg) in (extras or {}).get(tuple(shape),
                                                    {}).items():
            c = cases[name]
            run = functools.partial(dp_run, m, c["arch"], c["overrides"],
                                    c["init"], arg, c["steps"])
            if kind == "mb":
                got["mb"] = run(microbatches=2, fsdp=True)
            elif kind == "plain":
                got["fsdp_on"], got["fsdp_off"] = run(fsdp=True), run()
            elif kind == "faults":
                for fault in FSDP_FAULTS:
                    with _tool().fault_in(fault):
                        got[fault] = run(fsdp=True)
            elif kind == "save":
                got["uncut"] = loop_run(m, arg, FSDP_LOOP, 4, arch=c["arch"],
                                        overrides=c["overrides"],
                                        parallel=fsdp)
            else:
                got.update(_fsdp_resume(m, rank, arg, c))
        out[tuple(shape)] = got
    return out if rank == 0 else None


def _fsdp_resume(mesh, rank, root, c):
    """The FSDP loop's step-2 save restored on ``mesh`` with FSDP (split
    and gathered again), then resumed in a copy to step 4."""
    import shutil

    import torch.distributed as dist

    from repro_torch.configs import ParallelConfig
    fsdp = ParallelConfig(fsdp=True)
    restored = restored_state(mesh, root, FSDP_LOOP, 2, c["arch"],
                              c["overrides"], fsdp)
    name = "fsdp_resumed"
    if rank == 0:
        os.makedirs(os.path.join(str(root), name))
        shutil.copy(os.path.join(str(root), FSDP_LOOP, "step_00000002.npz"),
                    os.path.join(str(root), name))
        with open(os.path.join(str(root), name, "MANIFEST.json"), "w") as f:
            f.write('{"latest_step": 2}')
    dist.barrier()
    resumed = loop_run(mesh, root, name, 4, arch=c["arch"],
                       overrides=c["overrides"], parallel=fsdp)
    return {"restored": restored, "resumed": resumed}


# ---------------------------------------------------------------------------
# The serving cells (tests/test_torch_serve_mesh.py)
# ---------------------------------------------------------------------------


def serve_tool():
    """tools/dist_serve_cells.py as a module."""
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "..", "tools"))
    import dist_serve_cells
    return dist_serve_cells


def serve_rank(mesh, rank, shapes, faults_at=None):
    """For each mesh shape of ``shapes`` (over this group), the tool's
    f32 checks of the serving cells (`f32_rank`: every family's smoke,
    batch 1 with "seq" over ("data", "model") at (2, 2)), with its
    faults at the mesh ``faults_at`` only, each with rank 0's logits
    and tokens. Rank 0: {shape: [reading]}."""
    tool = serve_tool()
    out = {tuple(shape): tool.f32_rank(_mesh_of(mesh, shape), "cpu",
                                       faults=tuple(shape) == faults_at,
                                       keep_logits=True)
           for shape in shapes}
    return out if rank == 0 else None


# ---------------------------------------------------------------------------
# Blocks that "model" does not divide (tests/test_torch_attn_fallback.py)
# ---------------------------------------------------------------------------


FALLBACK_FAULTS = ("whole_summed", "rows_unsummed")


def fallback_rank(mesh, rank, shapes, cases, faults=None, serve=None):
    """For each mesh shape of ``shapes`` (over this group): `dp_run` of
    every case of ``cases`` ({name: {"arch", "overrides", "init",
    "shape", "steps", "meshes"}}) whose "meshes" name it; with
    ``faults`` ({fault: (mesh shape, case name)}) one step of that case
    under the fault (tools/dist_train_scaling.py's `fault_in`) at that
    mesh; with ``serve`` ({mesh shape: [(name, arch, overrides,
    batch)]}) the serving tool's f32 check of each at that mesh, worst
    over the ranks, with rank 0's logits (`f32_case`). Rank 0: {shape:
    {name: runs, fault: runs, ("serve", name): reading}}."""
    tool = serve_tool()
    out = {}
    for shape in shapes:
        m = _mesh_of(mesh, shape)
        got = {name: dp_run(m, c["arch"], c["overrides"], c["init"],
                            c["shape"], c["steps"])
               for name, c in cases.items() if tuple(shape) in c["meshes"]}
        for fault, (at, name) in (faults or {}).items():
            if tuple(at) == tuple(shape):
                c = cases[name]
                got[fault] = tp_fault(m, fault, c["arch"], c["init"],
                                      c["shape"], c["overrides"])
        for name, arch, over, batch in (serve or {}).get(tuple(shape), ()):
            r = tool.f32_case(m, name, arch, over, batch, None, "cpu",
                              keep_logits=True)
            r["ok"] = tool.case_ok(tool._worst_over_ranks(r))
            got[("serve", name)] = r
        out[tuple(shape)] = got
    return out if rank == 0 else None


# ---------------------------------------------------------------------------
# The "pod" axis (tests/test_torch_pod.py)
# ---------------------------------------------------------------------------


POD_MESHES = ((2, 2, 1), (2, 1, 2), (4, 1), (2, 2))
POD_LOOP = "pod_uncut"


def pod_rank(mesh, rank, cases, root, per_rank):
    """World 4, on each mesh of POD_MESHES in order (over this group):
    `dp_run` with FSDP of every case of ``cases`` ({name: {"arch",
    "overrides", "init", "shape", "steps"}}); at (2, 2, 1) also one step
    of "gemma3" with the gradients summed over "data" alone
    (tools/dist_train_scaling.py's fault ``pod_unsummed``), the int8
    mean of ``per_rank`` over ("pod", "data") (`compress_rank`), and a
    4-step `train_loop` with FSDP saving at step 2 in ``root``; at
    (4, 1) that save restored with FSDP (`restored_state`); on each mesh
    with a "pod" axis the serving tool's f32 checks (`f32_rank`, its
    fault where "model" >= 2). Every rank: {"compress": its int8 means},
    rank 0 also {"meshes": {shape: {name: result}}}."""
    from repro_torch.configs import ParallelConfig
    fsdp = ParallelConfig(fsdp=True)
    out, mine = {}, None
    for shape in POD_MESHES:
        m = _mesh_of(mesh, shape)
        got = {name: dp_run(m, c["arch"], c["overrides"], c["init"],
                            c["shape"], c["steps"], fsdp=True)
               for name, c in cases.items()}
        if shape == (2, 2, 1):
            c = cases["gemma3"]
            with _tool().fault_in("pod_unsummed"):
                got["pod_unsummed"] = dp_run(m, c["arch"], c["overrides"],
                                             c["init"], c["shape"], 1,
                                             fsdp=True)
            mine = compress_rank(m, rank, per_rank, ("pod", "data"))
            got["uncut"] = loop_run(m, root, POD_LOOP, 4, parallel=fsdp)
        if shape == (4, 1):
            got["restored"] = restored_state(m, root, POD_LOOP, 2,
                                             parallel=fsdp)
        if len(shape) == 3:
            got["serve"] = serve_tool().f32_rank(m, "cpu")
        out[shape] = got
    return ({"meshes": out, "compress": mine} if rank == 0
            else {"compress": mine})
