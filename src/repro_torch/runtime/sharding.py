"""Logical-axis sharding: models name *logical* axes; the launcher binds
them to the axes of a mesh of ranks.

The port of the reference's ``repro.runtime.sharding``: the same rules,
the same `Binding`, `current_binding` / `use_binding` and `resolve`.
`resolve` returns a plain spec, a tuple with one entry per dimension: a
mesh-axis name, a tuple of names, or ``None`` (replicated), the
counterpart of a ``PartitionSpec``.

Resolution is divisibility-safe: a logical axis whose physical extent
does not divide the array dimension is dropped (replicated), and a mesh
axis already claimed by an earlier dimension is dropped from later ones.

The port runs its collectives explicitly (`torch.distributed`), so a
binding also carries the mesh (`launch.mesh.make_mesh`): `batch_axis`
gives the process group, extent and index of the ranks that split the
batch (the "batch" rule: "data", or ("pod", "data") on a mesh with a
"pod" axis, pod-major), and `model_axis` those of the ranks that split the heads,
the MLP's width, the vocabulary and the experts ("model");
`model_axis_over` gives them to a block only where they divide its
heads or width (else the block is whole on every rank, as `resolve`
drops an axis that does not divide). `shard` and
`shard_pin` are the identity: each rank already holds its own block of
every tensor. Under FSDP (``ParallelConfig.fsdp``) a binding also
carries the parameters' FSDP layout (`fsdp_layout`), read by the layer
bodies that gather their weights. A decode step whose KV cache is split
along its sequence marks its binding ``seq_sharded``; `seq_axis` then
gives the ranks of the "seq" rule, over which decode attention combines
its partial softmaxes (`models.attention`).

The active binding is the process's, not the thread's (the reference
keeps it per thread): the mesh is one per process, and on the card
autograd runs the backward on a thread of its own, where a layer body
under `models.common.remat` is recomputed and must see the binding its
forward saw (MoE's capacity, ranks and group size, the loss's token
count, the FSDP layout its gathers read).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

Logical = Union[str, None, Tuple[str, ...]]
Spec = Tuple[Union[str, None, Tuple[str, ...]], ...]

_active: list = [None]   # the process's binding (module doc)

# Default logical -> physical bindings.
SINGLE_POD_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("data",),
    "model": ("model",),
    "expert": ("model",),
    "vocab": ("model",),
    "seq": ("data",),      # long-context KV sharding (decode)
    "kv_heads": ("model",),
    "fsdp": ("data",),     # only consulted when ParallelConfig.fsdp
    # fallback batch sharding over the whole mesh (attention whose head
    # count does not divide the model axis)
    "attn_batch": ("data", "model"),
}

MULTI_POD_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "model": ("model",),
    "expert": ("model",),
    "vocab": ("model",),
    "seq": ("data",),
    "kv_heads": ("model",),
    "fsdp": ("pod", "data"),
    "attn_batch": ("pod", "data", "model"),
}


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """The ranks that share one block of a tensor split over mesh axes:
    their process group (None where there is none to run), their number
    and this rank's index among them."""
    group: object
    extent: int
    index: int
    axes: Tuple[str, ...] = ()    # the wide mesh axes it spans


class Binding:
    """Active logical->physical binding plus mesh axis sizes (and, in the
    port, the mesh whose process groups run the collectives)."""

    def __init__(self, rules: Dict[str, Tuple[str, ...]],
                 axis_sizes: Dict[str, int], fsdp: bool = False,
                 mesh=None):
        self.rules = dict(rules)
        self.axis_sizes = dict(axis_sizes)
        # When False, "fsdp" axes are stripped from *parameter* specs
        # (ZeRO-1 moments still use them — see param_sharding.py).
        self.fsdp_params = fsdp
        self.mesh = mesh
        # the port's: {leaf path: (dim counted from the end, AxisGroup)}
        # of each parameter this rank holds as its FSDP block, set by the
        # train step (`fsdp_layout`)
        self.fsdp_layout: Dict[str, Tuple[int, "AxisGroup"]] = {}
        # the port's: set by a decode step whose cache is split along its
        # sequence over the "seq" rule's axes (`seq_axis`)
        self.seq_sharded = False

    def extent(self, phys: Tuple[str, ...]) -> int:
        n = 1
        for a in phys:
            n *= self.axis_sizes.get(a, 1)
        return n

    def axis_group(self, phys: Tuple[str, ...]) -> AxisGroup:
        """The ranks over the mesh axes ``phys`` that share this rank's
        coordinates on every other axis: their process group, their
        number, and this rank's index among them, its row-major
        coordinate over the wide ones in the mesh's order (how a dim
        laid over ("pod", "data") is split: pod-major). One wide axis:
        the mesh's group of that axis; every wide axis of the mesh: the
        world group; any other set of two or more: the group that
        `make_axis_groups` made for them when the mesh was made
        (`launch.mesh.make_mesh`). At extent 1 the group is the mesh's
        own one-rank group of a single named axis, else None. A mesh of
        no ranks (a layout reckoned on the meta device, whose axes have
        no groups) gives None for a group of several axes. Axes named in
        another order than the mesh's raise: no rule names one."""
        wide = tuple(a for a in phys if self.axis_sizes.get(a, 1) > 1)
        if not wide:
            if (self.mesh is not None and len(phys) == 1
                    and phys[0] in self.mesh.mesh_dim_names):
                return AxisGroup(self.mesh.get_group(phys[0]), 1, 0)
            return AxisGroup(None, 1, 0)
        if self.mesh is None:
            raise NotImplementedError(
                f"collectives over mesh axes {list(wide)} without a mesh")
        if len(wide) == 1:
            return AxisGroup(self.mesh.get_group(wide[0]),
                             self.axis_sizes[wide[0]],
                             self.mesh.get_local_rank(wide[0]), wide)
        names = tuple(self.mesh.mesh_dim_names)
        if tuple(a for a in names if a in wide) != wide:
            raise NotImplementedError(
                f"a group over mesh axes {list(wide)} in another order "
                f"than the mesh's {list(names)}")
        index = 0
        for a in wide:
            index = index * self.axis_sizes[a] + self.mesh.get_local_rank(a)
        whole = tuple(a for a in names if self.axis_sizes.get(a, 1) > 1)
        if wide == whole:
            import torch.distributed as dist
            group = dist.group.WORLD
        else:
            groups = getattr(self.mesh, "axis_groups", None)
            if groups is not None:
                group = groups[wide]
            elif self.mesh.get_group(wide[0]) is None:
                group = None                    # a mesh of no ranks
            else:
                raise ValueError(
                    f"no group over mesh axes {list(wide)}: make the mesh "
                    "with launch.mesh.make_mesh")
        return AxisGroup(group, self.extent(wide), index, wide)


def make_axis_groups(mesh) -> Dict[Tuple[str, ...], object]:
    """The process groups of ``mesh`` (a ``DeviceMesh``) over each set of
    two or more of its wide axes that is not all of them (on a mesh of
    (pod, data, model) with every axis wide: ("pod", "data"), ("pod",
    "model") and ("data", "model")): {axes in the mesh's order: this
    rank's group over them}. ``dist.new_group`` is collective, so every
    rank makes every group, in one order, once a mesh, never inside a
    step. A group's ranks are those of the mesh that share one
    coordinate on the other axes; ``new_group`` orders them by global
    rank, which on the mesh's row-major layout is their row-major
    coordinate over the group's axes, `Binding.axis_group`'s index."""
    import itertools

    import torch.distributed as dist
    names = tuple(mesh.mesh_dim_names)
    layout = mesh.mesh
    wide = [i for i, n in enumerate(layout.shape) if n > 1]
    me = dist.get_rank()
    out = {}
    for k in range(2, len(wide)):
        for dims in itertools.combinations(wide, k):
            rest = [i for i in range(layout.dim()) if i not in dims]
            size = 1
            for i in dims:
                size *= layout.shape[i]
            for row in layout.permute(*rest, *dims).reshape(
                    -1, size).tolist():
                group = dist.new_group(ranks=row)
                if me in row:
                    out[tuple(names[i] for i in dims)] = group
    return out


def current_binding() -> Optional[Binding]:
    return _active[0]


@contextlib.contextmanager
def use_binding(binding: Optional[Binding]):
    prev = _active[0]
    _active[0] = binding
    try:
        yield
    finally:
        _active[0] = prev


def batch_axis() -> Optional[AxisGroup]:
    """The ranks that split the batch under the active binding, or None
    without a binding or where they are one rank: then every statistic
    over the batch is local, as on one device."""
    binding = current_binding()
    if binding is None:
        return None
    axis = binding.axis_group(binding.rules.get("batch", ()))
    return axis if axis.extent > 1 else None


def model_axis() -> Optional[AxisGroup]:
    """The ranks that split the model (heads, the MLP's width, the
    vocabulary: the "model" rule) under the active binding, or None
    without a binding or where they are one rank: then every layer runs
    whole, as on one device."""
    binding = current_binding()
    if binding is None:
        return None
    axis = binding.axis_group(binding.rules.get("model", ()))
    return axis if axis.extent > 1 else None


def model_axis_over(n: int) -> Optional[AxisGroup]:
    """`model_axis` where its extent divides ``n`` (a block's heads or
    width), else None: the block is whole on every rank, as the
    reference's divisibility-safe `resolve` leaves a dim that "model"
    does not divide (`runtime.param_sharding.tp_layout`)."""
    axis = model_axis()
    return axis if axis is not None and n % axis.extent == 0 else None


def seq_axis() -> Optional[AxisGroup]:
    """The ranks over which the decode KV cache is split along its
    sequence (the "seq" rule) under the active binding, where it is
    marked ``seq_sharded`` and they are more than one rank; else None:
    every rank holds the whole sequence."""
    binding = current_binding()
    if binding is None or not binding.seq_sharded:
        return None
    axis = binding.axis_group(binding.rules.get("seq", ()))
    return axis if axis.extent > 1 else None


def fsdp_layout() -> Dict[str, Tuple[int, AxisGroup]]:
    """{leaf path: (dim counted from the end, the ranks of the "fsdp"
    rule: "data", or ("pod", "data"))} of the parameters this rank holds
    as FSDP blocks under the active binding
    (`runtime.param_sharding.fsdp_blocks`, set by
    `train.steps.make_train_step`); empty without a binding, with fsdp
    off or at an extent of 1. Counted from the end, a dim names
    the same axis in a stacked leaf and in one layer of it
    (`models.common.fsdp_gather`)."""
    binding = current_binding()
    return binding.fsdp_layout if binding is not None else {}


def _phys_for(binding: Binding, ax: Logical) -> Tuple[str, ...]:
    if ax is None:
        return ()
    if isinstance(ax, tuple):
        return sum((binding.rules.get(a, ()) for a in ax), ())
    return binding.rules.get(ax, ())


def resolve(shape: Optional[Sequence[int]], *logical: Logical) -> Spec:
    """Logical axis names -> spec under the active binding (``()``
    without one, as ``P()``).

    If `shape` is given, axes that don't divide are dropped (replicated).
    A mesh axis already claimed by an earlier dim is dropped from later
    dims (lets rules say ("expert", None, "model"): EP takes the model
    axis when the expert count divides, TP over the ffn dim otherwise).
    """
    binding = current_binding()
    if binding is None:
        return ()
    spec = []
    used: set = set()
    for i, ax in enumerate(logical):
        phys = _phys_for(binding, ax)
        phys = tuple(a for a in phys if a not in used)
        if phys and shape is not None:
            if shape[i] % binding.extent(phys) != 0:
                phys = ()
        used.update(phys)
        if not phys:
            spec.append(None)
        elif len(phys) == 1:
            spec.append(phys[0])
        else:
            spec.append(phys)
    return tuple(spec)


def shard(x, *logical: Logical):
    """The identity: each rank already holds its block of ``x`` (the
    reference constrains a global array's layout here)."""
    binding = current_binding()
    if binding is not None:
        assert len(logical) == x.ndim, (logical, x.shape)
    return x


def shard_pin(x, **dims: Logical):
    """The identity, as `shard` (the reference pins the given dims)."""
    return x
