"""Parameter specs from path-based rules, and the blocks they give a rank.

The port of the reference's ``repro.runtime.param_sharding``, on the
port's parameter trees (nested dicts with the reference's names; a tree
built on the ``meta`` device serves, since only shapes are read). Rules
are expressed in *logical* axes (`runtime.sharding`) and resolved
divisibility-safely against the bound mesh. Stacked layer dims (leading
axes of the stacked layout) are detected by rank mismatch and get a
leading None.

TP (model axis) follows the Megatron pattern: column-parallel in
(wq/wk/wv/wi_*), row-parallel out (wo/out_proj). EP shards the expert
axis. FSDP adds the data axis onto a free dim of every matrix; ZeRO-1
applies the same to the Adam moments only.

`Block` and `zero1_blocks` are the port's: the block of a leaf that this
rank holds under a spec (the reference lets the partitioner place it).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

from repro_torch import tree as tree_lib
from repro_torch.runtime import sharding as shlib

# leaf-name -> logical axes (by trailing dims; leading stack dims -> None)
_RULES: Dict[str, Tuple] = {
    # embeddings
    "embedding": ("vocab", None),
    "lm_head": (None, "vocab"),
    # attention / mlp matrices (column-parallel)
    "wq": ("fsdp", "model"),
    "wk": ("fsdp", "model"),
    "wv": ("fsdp", "model"),
    "wi_gate": ("fsdp", "model"),
    "wi_up": ("fsdp", "model"),
    # row-parallel
    "wo": ("model", "fsdp"),
    "out_proj": ("model", "fsdp"),
    # MLA
    "wq_a": ("fsdp", None),
    "wq_b": ("fsdp", "model"),
    "wkv_a": ("fsdp", None),
    "wk_b": ("fsdp", "model"),
    "wv_b": ("fsdp", "model"),
    # MoE (expert-parallel; note wi_*/wo 3-D variants below)
    "router": (None, None),
    # SSM
    "in_proj": ("fsdp", "model"),
    "conv_w": (None, "model"),
    "conv_b": ("model",),
    "a_log": (None,),
    "dt_bias": (None,),
    "d_skip": (None,),
    # norms
    "scale": (None,),
}

# EP takes the model axis when the (padded) expert count divides it; the
# trailing "model" falls back to TP over the ffn dim otherwise (resolve()
# drops duplicate mesh axes).
_MOE_RULES: Dict[str, Tuple] = {
    "wi_gate": ("expert", "fsdp", "model"),
    "wi_up": ("expert", "fsdp", "model"),
    "wo": ("expert", "model", "fsdp"),
}


def _leaf_rule(path: Sequence[str], ndim: int) -> Tuple:
    """``path``: the leaf's key names from the root."""
    names = list(path)
    leaf = names[-1]
    in_moe = any(n == "moe" for n in names) and leaf in _MOE_RULES
    rule = _MOE_RULES[leaf] if in_moe else _RULES.get(leaf)
    if rule is None:
        rule = tuple(None for _ in range(ndim))
    # leading stacked-layer dims
    while len(rule) < ndim:
        rule = (None,) + rule
    assert len(rule) == ndim, (names, rule, ndim)
    return rule


def logical_param_axes(params_shape: Dict) -> Dict:
    """Tree of logical-axis tuples matching the parameter tree."""
    paths = dict(tree_lib.items(params_shape))
    return tree_lib.unflatten(params_shape, [
        _leaf_rule(path.split("/"), len(leaf.shape))
        for path, leaf in paths.items()])


def specs_from_logical(logical_tree: Dict, shapes_tree: Dict, *,
                       keep_fsdp: bool = None) -> Dict:
    """Resolve logical tuples to specs (divisibility-safe).

    "fsdp" axes are honored only when the binding has fsdp_params (params)
    or keep_fsdp=True is forced (ZeRO-1 moments).
    """
    binding = shlib.current_binding()
    fsdp_ok = keep_fsdp if keep_fsdp is not None else (
        binding.fsdp_params if binding else False)

    def resolve_leaf(ax, leaf):
        if not fsdp_ok:
            ax = tuple(None if a == "fsdp" else a for a in ax)
        return shlib.resolve(leaf.shape, *ax)

    return tree_lib.map_(resolve_leaf, logical_tree, shapes_tree)


def param_pspecs(params_shape: Dict) -> Dict:
    return specs_from_logical(logical_param_axes(params_shape),
                              params_shape)


def zero1_moment_axes(logical_tree: Dict, shapes_tree: Dict) -> Dict:
    """ZeRO-1: Adam moments get the fsdp (data) axis on a free dim."""
    def add_fsdp(ax, leaf):
        if "fsdp" in ax:
            return ax
        binding = shlib.current_binding()
        ext = binding.extent(binding.rules.get("fsdp", ())) if binding else 0
        out = list(ax)
        for i, a in enumerate(out):
            if a is None and ext and leaf.shape[i] % ext == 0:
                out[i] = "fsdp"
                break
        return tuple(out)

    return tree_lib.map_(add_fsdp, logical_tree, shapes_tree)


# ---------------------------------------------------------------------------
# The port's: blocks held by this rank
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Block:
    """This rank's block of a leaf split ``axis.extent`` ways along
    ``dim`` in equal contiguous parts, the ``axis.index``-th of them."""
    dim: int
    axis: shlib.AxisGroup

    def size(self, full: int) -> int:
        return full // self.axis.extent

    def take(self, full):
        """The rank's block of the whole leaf ``full``: a view."""
        k = self.size(full.shape[self.dim])
        return full.narrow(self.dim, self.axis.index * k, k)

    def shape(self, full_shape) -> Tuple[int, ...]:
        out = list(full_shape)
        out[self.dim] = self.size(out[self.dim])
        return tuple(out)

    def full_shape(self, block_shape) -> Tuple[int, ...]:
        out = list(block_shape)
        out[self.dim] *= self.axis.extent
        return tuple(out)


def block_of(spec, binding: shlib.Binding):
    """The `Block` a resolved spec gives this rank, or None where every
    rank holds the whole leaf. A spec split over more than one dim, or
    over axes other than ZeRO-1's, is not run by this port yet."""
    split = [(i, (e,) if isinstance(e, str) else e)
             for i, e in enumerate(spec) if e is not None
             and binding.extent((e,) if isinstance(e, str) else e) > 1]
    if not split:
        return None
    if len(split) > 1:
        raise NotImplementedError(
            f"a leaf split along dims {[i for i, _ in split]} "
            "(ROADMAP A.4)")
    dim, phys = split[0]
    return Block(dim, binding.axis_group(phys))


def zero1_blocks(params_shape: Dict, zero1: bool = True) -> Dict:
    """Tree (of the parameters' structure) of the `Block` of each Adam
    moment that this rank holds under the active binding, None where it
    holds the whole moment: with ``zero1``, the reference's
    ``specs_from_logical(zero1_moment_axes(...), keep_fsdp=True)``;
    without, the parameters' own specs. Parameters themselves are whole
    on every rank (`launch.mesh.make_mesh` refuses fsdp)."""
    binding = shlib.current_binding()
    if binding is None:
        return tree_lib.map_(lambda _: None, params_shape)
    logical = logical_param_axes(params_shape)
    for path, spec in tree_lib.items(
            specs_from_logical(logical, params_shape)):
        if block_of(spec, binding) is not None:
            raise NotImplementedError(
                f"parameter {path} split as {spec} (ROADMAP A.4)")
    if zero1:
        specs = specs_from_logical(
            zero1_moment_axes(logical, params_shape), params_shape,
            keep_fsdp=True)
    else:
        specs = specs_from_logical(logical, params_shape)
    return tree_lib.map_(lambda s: block_of(s, binding), specs)
