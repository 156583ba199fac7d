"""Meshes of ranks and their logical-axis bindings.

The port of the reference's ``repro.launch.mesh``. A mesh is a
``torch.distributed`` ``DeviceMesh`` with named axes over the ranks of
the default process group (NCCL on the card, gloo on the CPU), one rank
per device; the caller starts the group (``torchrun``, or
``init_process_group`` with an address, world size and rank).

Production: single pod (data=16, model=16), 256 ranks; multi-pod
(pod=2, data=16, model=16), 512 ranks.

The port runs a mesh (data = d, model = m), d x m = world, or (pod = p,
data = d, model = m), p x d x m = world: "data" splits the batch (with
"pod", the batch over ("pod", "data"), pod-major: the reference's
``MULTI_POD_RULES``), "model" the heads, the MLP's width, the SSM's
heads, the vocabulary (Megatron tensor parallelism, `models.common`,
`runtime.param_sharding.tp_pieces`) and the experts (the "expert" rule,
`models.moe`), each block where its heads or width divide; a block
they do not divide runs whole on every rank, as the reference's
divisibility-safe resolve leaves it, or, under ``attn_batch_fallback``,
the attention on each rank's block of the rows split again over "model"
(`runtime.param_sharding.tp_layout`, `models.attention`). Under
``ParallelConfig.fsdp`` the "fsdp" rule's axes ("data", or ("pod",
"data")) also split the parameters whose rule marks "fsdp"
(`runtime.param_sharding.fsdp_blocks`, gathered a layer at a time:
`train.steps`). The "pod" axis is data whatever
``ParallelConfig.pod_axis_role`` says: the reference's `binding_for`
binds ``MULTI_POD_RULES`` on any mesh with a "pod" axis and no module
of the reference reads the role. `make_mesh` raises
`NotImplementedError` for a wide axis that no rule binds, so nothing is
replicated where the reference would split it, and makes the process
groups over each set of several wide axes once
(`runtime.sharding.make_axis_groups`).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from repro_torch.configs.base import ParallelConfig
from repro_torch.runtime import sharding as shlib

_AXES = ("pod", "data", "model")     # the axes the rules bind


def make_mesh(shape: Sequence[int] = None,
              axes: Sequence[str] = ("data", "model"), *,
              device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` (default: every rank on "data")
    with ``axes`` as its dimension names, over the default process
    group, with its groups over several wide axes (``mesh.axis_groups``,
    `runtime.sharding.make_axis_groups`; every rank calls this alike).
    ``device_type`` defaults to "cuda" where the group's backend
    is NCCL alone, else "cpu" (the mesh's groups serve the tensors of
    every device their backend takes either way). No choice of
    `ParallelConfig` changes the mesh (a "pipeline" pod binds as data,
    module doc)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    axes = tuple(axes)
    world = dist.get_world_size()
    if shape is None:
        shape = tuple(world if a == "data" else 1 for a in axes)
    shape = tuple(int(n) for n in shape)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} for axes {axes}")
    for a, n in zip(axes, shape):
        if a not in _AXES and n > 1:
            raise NotImplementedError(
                f'a "{a}" axis of {n}: no sharding rule binds it')
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(f"mesh {dict(zip(axes, shape))} over {world} "
                         "ranks")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = init_device_mesh(device_type, shape, mesh_dim_names=axes)
    mesh.axis_groups = shlib.make_axis_groups(mesh)
    return mesh


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    import torch.distributed as dist
    want = 512 if multi_pod else 256
    if not dist.is_initialized() or dist.get_world_size() != want:
        raise ValueError(f"the production mesh {shape} needs {want} ranks")
    return make_mesh(shape, axes)


def mesh_axes(mesh) -> Tuple[Tuple[str, int], ...]:
    """((name, extent), ...) of a mesh."""
    return tuple(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def binding_for(mesh, parallel: Optional[ParallelConfig] = None,
                ) -> shlib.Binding:
    parallel = parallel or ParallelConfig()
    axis_sizes = {a: int(n) for a, n in mesh_axes(mesh)}
    rules = (shlib.MULTI_POD_RULES if "pod" in axis_sizes
             else shlib.SINGLE_POD_RULES)
    return shlib.Binding(rules, axis_sizes, fsdp=parallel.fsdp, mesh=mesh)
