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

The rest is the port's (the reference lets the partitioner place each
block): `tp_pieces` gives the `Piece` of each leaf that a rank holds over
"model", `fsdp_blocks` the FSDP `Block` of each parameter over "data"
(of the piece; ``ParallelConfig.fsdp``), `zero1_blocks` the ZeRO-1
`Block` of each moment over "data" (of the piece; "data" here and below
means the axes of the "fsdp" rule: ("pod", "data") on a mesh with a
"pod" axis, a leaf split over both or whole over both, as the
reference's resolve drops both where pod x data does not divide), and
`Shard` the two
together, the layout of a train state's leaf (`train.steps.state_blocks`,
`checkpoint`). A piece keeps
the reference's spec where that cuts at head or segment boundaries
(wq, wo, wi_*, out_proj, MLA's wq_b / wk_b / wv_b, embedding / lm_head
where "model" divides the vocabulary, and the experts: along the expert
dim where "model" divides the padded count, else along their width,
`_MOE_RULES`), and takes a layout of its own where a contiguous split
would cut through a head or a segment: wk / wv with fewer KV heads than
ranks (gemma3-1b's one KV head of 256 columns), the SSM's in_proj [z |
x | B | C | dt] and conv [x | B | C] (z, x, dt by head, B and C whole),
its gated norm, a_log, dt_bias and d_skip by head; and where the rule
would name the wrong dim: the shared experts' SwiGLU, whose (L, d, f)
leaves the 3-D expert rule would split along the layers, takes the
dense MLP's column / row split.
A block whose heads or width "model" does not divide is whole on every
rank (`tp_layout`): the reference's divisibility-safe resolve, taken
block by block. The port's pieces are head-aligned, so a block is split
wholly or held whole: the query heads (with them every leaf of the
attention block), the SSM's heads (in_proj, conv, the norms, out_proj),
the MLP's d_ff, the experts' width where the padded expert count does
not divide either, and the shared experts' width. Under a split
attention block, KV heads that neither divide nor are divided by "model"
are whole on every rank, each rank reading those of its query heads.
The parts that several ranks hold (a shared KV head, KV heads whole
under split query heads, B and C, the per-head q_norm / k_norm scales)
each use in part: their gradients are partial and are summed over
"model" (`Piece.shared`). The leaves of an attention block under the
``attn_batch`` fallback are whole too, and their gradients partial
where the fallback split the rows (`Piece.rows`). Leaves whole on every
rank otherwise (a block "model" does not divide, the norms on the
replicated residual stream, MLA's q_norm and kv_norm before its split,
the router, a vocabulary "model" does not divide) get the whole
gradient on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

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
# The port's: the pieces and blocks held by this rank
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


@dataclasses.dataclass(frozen=True)
class Segment:
    """``length`` entries of a leaf's dim from ``start``, cut into
    ``parts`` equal parts: rank r of the m ranks of "model" holds part
    r * parts // m. At ``parts`` = m each rank holds its own part; below
    m, m / parts ranks hold the same one and each uses it in part (a KV
    head shared by their query heads, the SSM's B and C columns)."""
    start: int
    length: int
    parts: int


@dataclasses.dataclass(frozen=True)
class Piece:
    """This rank's piece of a leaf over "model": along ``dim``, its part
    of each of ``segments`` (which tile the dim), concatenated in order.
    ``axis``: the "model" ranks (`runtime.sharding.model_axis`).
    ``rows``: a leaf of an ``attn_batch`` fallback block (one segment,
    the whole leaf): each rank's gradient is of its rows of the batch
    where the fallback split them, and only then partial."""
    dim: int
    segments: Tuple[Segment, ...]
    axis: shlib.AxisGroup
    rows: bool = False

    def spans(self, index: Optional[int] = None) -> List[Tuple[int, int]]:
        """(start in the whole leaf, length) of each part that rank
        ``index`` (default: this rank) holds, in its piece's order."""
        r = self.axis.index if index is None else index
        m = self.axis.extent
        return [(s.start + (r * s.parts // m) * (s.length // s.parts),
                 s.length // s.parts) for s in self.segments]

    def shared(self) -> List[Tuple[Segment, int, int]]:
        """(segment, offset in the piece, length) of each part that
        other ranks hold too: its gradients are partial on each of them
        and summed over "model" (`train.steps`)."""
        out, off = [], 0
        for s, (_, n) in zip(self.segments, self.spans()):
            if s.parts < self.axis.extent:
                out.append((s, off, n))
            off += n
        return out

    def counted(self) -> List[Tuple[int, int]]:
        """(offset in the piece, length) of the parts that this rank
        counts in a sum over "model" of a statistic of the whole leaf
        (`optim.adamw.global_norm`): its own parts, and a shared part on
        the first of the ranks that hold it."""
        out, off = [], 0
        m, r = self.axis.extent, self.axis.index
        for s, (_, n) in zip(self.segments, self.spans()):
            if r % (m // s.parts) == 0:
                out.append((off, n))
            off += n
        return out

    def size(self) -> int:
        return sum(n for _, n in self.spans())

    def take(self, full):
        """The rank's piece of the whole leaf ``full``: a view where it
        is one part, else a new tensor."""
        parts = [full.narrow(self.dim, a, n) for a, n in self.spans()]
        return parts[0] if len(parts) == 1 else torch.cat(parts, self.dim)

    def place(self, full, piece, index: int) -> None:
        """Write rank ``index``'s ``piece`` into its place in ``full``."""
        off = 0
        for a, n in self.spans(index):
            full.narrow(self.dim, a, n).copy_(piece.narrow(self.dim, off, n))
            off += n

    def shape(self, full_shape) -> Tuple[int, ...]:
        out = list(full_shape)
        out[self.dim] = self.size()
        return tuple(out)

    def full_shape(self, piece_shape) -> Tuple[int, ...]:
        out = list(piece_shape)
        out[self.dim] = sum(s.length for s in self.segments)
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class Shard:
    """What this rank holds of a whole leaf: its `Piece` over "model"
    (None: the whole leaf) and, of that piece, its `Block` over "data"
    (a moment's ZeRO-1 block, or an FSDP block; None: the whole
    piece)."""
    piece: Optional[Piece] = None
    block: Optional[Block] = None

    def take(self, full):
        t = full if self.piece is None else self.piece.take(full)
        return t if self.block is None else self.block.take(t)


def tp_layout(cfg, extent: int) -> Dict[str, str]:
    """How "model" of ``extent`` lays out each block of ``cfg`` in this
    port: the reference's divisibility-safe resolve, taken block by
    block (module doc). {block: mode}:

      "attn": "split" (the query heads divide), "whole" (every head on
          every rank, as one device runs it), or "rows" (whole, and
          where ``attn_batch_fallback`` is set the rows split over
          "model" wherever they divide: `models.attention`); MLA is
          "split" or "whole" (the reference has no fallback for it);
      "kv": GQA's KV heads under a split "attn": "split" (m divides
          them), "shared" (they divide m: one a rank, m / n ranks
          sharing it) or "all" (neither: every KV head on every rank,
          each rank reading those of its query heads);
      "mlp", "ssm", "shared" (the shared experts' width): "split" or
          "whole";
      "experts": "experts" (along the padded expert dim), "width" (every
          expert on 1 / m of its width) or "whole".

    At an extent of 1 every block is "split" into one piece: whole."""
    m = max(extent, 1)

    def split(n):
        return "split" if n % m == 0 else "whole"

    out = {}
    if cfg.n_heads:
        heads = split(cfg.n_heads)
        if heads == "whole" and cfg.attn_batch_fallback and not \
                cfg.use_mla:
            heads = "rows"
        out["attn"] = heads
        hkv = cfg.n_kv_heads
        out["kv"] = ("split" if hkv % m == 0 else "shared" if m % hkv == 0
                     else "all")
    out["mlp"] = split(cfg.d_ff)
    if cfg.family in ("ssm", "hybrid"):
        out["ssm"] = split(cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim)
    if cfg.n_experts:
        out["experts"] = ("experts" if cfg.n_experts_eff % m == 0 else
                          "width" if cfg.moe_d_ff % m == 0 else "whole")
        out["shared"] = split(cfg.moe_d_ff * max(cfg.n_shared_experts, 1))
    return out


_ATTN = ("attn", "self_attn", "cross_attn")


def _tp_segments(names: Sequence[str], shape, cfg, m: int, spec,
                 layout: Dict[str, str]):
    """(dim, segments, rows) of a leaf's piece over "model" of ``m``, or
    None (whole on every rank, its gradient whole on each). The
    reference's spec where it cuts at head or segment boundaries; the
    port's own head-aligned layout where a contiguous split would cut
    through a head or a segment; a block that "model" does not divide
    (``layout``, `tp_layout`) whole. ``rows``: the leaf of an
    ``attn_batch`` fallback block, whole on every rank, whose gradient
    is summed over "model" where the fallback split the rows."""
    leaf, last = names[-1], len(shape) - 1
    parent = names[-2] if len(names) > 1 else ""
    whole = (last, (Segment(0, shape[last], 1),), False)
    if "ssm" in names:
        if layout["ssm"] == "whole":
            return None
        d_inner = cfg.ssm_expand * cfg.d_model
        nh, ns = d_inner // cfg.ssm_head_dim, cfg.ssm_state
        # in_proj [z | x | B | C | dt]; conv [x | B | C]: z, x, dt by
        # head, B and C whole (one group, shared by every head)
        if leaf == "in_proj":
            return last, (Segment(0, d_inner, m),
                          Segment(d_inner, d_inner, m),
                          Segment(2 * d_inner, ns, 1),
                          Segment(2 * d_inner + ns, ns, 1),
                          Segment(2 * d_inner + 2 * ns, nh, m)), False
        if leaf in ("conv_w", "conv_b"):
            return last, _conv_segments(cfg, m), False
        if leaf in ("a_log", "dt_bias", "d_skip"):
            return last, (Segment(0, nh, m),), False
        if parent == "norm":                      # gated norm over d_inner
            return last, (Segment(0, d_inner, m),), False
    if any(n in _ATTN for n in names[:-1]):
        if layout["attn"] == "whole":
            return None
        if layout["attn"] == "rows":
            return whole[:2] + (True,)
        if leaf in ("wk", "wv") and layout["kv"] != "split":
            n = cfg.n_kv_heads
            # "shared": each rank holds the KV head its query heads read
            # (m / n ranks share it); "all": every rank holds every KV
            # head and reads those of its query heads
            parts = n if layout["kv"] == "shared" else 1
            return last, (Segment(0, n * cfg.head_dim, parts),), False
        if parent in ("q_norm", "k_norm") and not cfg.use_mla:
            # one scale a head dim, applied to every rank's heads (MLA's
            # q_norm is over q_lora_rank, before the split: whole)
            return whole
    if "mlp" in names and layout["mlp"] == "whole":
        return None
    if "shared" in names and leaf in _MOE_RULES:
        # the shared experts' SwiGLU: the dense MLP's column / row split
        # (the reference's expert rule would name their layer dim)
        if layout["shared"] == "whole":
            return None
        dim = last - 1 if leaf == "wo" else last
        return dim, (Segment(0, shape[dim], m),), False
    dims = [i for i, e in enumerate(spec)
            if e == "model" or (isinstance(e, tuple) and "model" in e)]
    if not dims:
        return None
    return dims[0], (Segment(0, shape[dims[0]], m),), False


def tp_pieces(params_shape: Dict, cfg) -> Dict:
    """Tree (of the parameters' structure) of the `Piece` of each leaf
    that this rank holds over "model" under the active binding, None
    where it holds the whole leaf (every leaf without a binding, or at a
    "model" extent of 1, and every leaf of a block that "model" does not
    divide: `tp_layout`)."""
    axis = shlib.model_axis()
    if axis is None:
        return tree_lib.map_(lambda _: None, params_shape)
    layout = tp_layout(cfg, axis.extent)
    specs = dict(tree_lib.items(param_pspecs(params_shape)))
    out = []
    for path, leaf in tree_lib.items(params_shape):
        seg = _tp_segments(path.split("/"), tuple(leaf.shape), cfg,
                           axis.extent, specs[path], layout)
        out.append(None if seg is None else
                   Piece(seg[0], seg[1], axis, rows=seg[2]))
    return tree_lib.unflatten(params_shape, out)


def _blocks_over_data(specs: Dict, params_shape: Dict, pieces: Dict,
                      binding) -> Dict:
    """Tree of the `Block` that ``specs`` give each leaf over the axes of
    its entry other than "model" (the "fsdp" rule's: "data", or ("pod",
    "data")), of its piece over "model" where ``pieces`` gives one:
    along the dim whose entry names them, over their group
    (`runtime.sharding.Binding.axis_group`), where the piece's extent
    there divides; None where no entry names them or it does not
    divide. The rules name "fsdp" on one dim of a leaf, and `resolve`
    gives a mesh axis to one dim only, so no leaf is split along two
    (every config's layout on the (2, 16, 16) mesh, in the tests)."""
    def block(spec, leaf, piece):
        split = []
        for i, e in enumerate(spec):
            phys = tuple(a for a in ((e,) if isinstance(e, str) else
                                     (e or ())) if a != "model")
            if phys and binding.extent(phys) > 1:
                split.append((i, phys))
        if not split:
            return None
        assert len(split) == 1, (spec, split)
        dim, phys = split[0]
        local = (piece.size() if piece is not None and piece.dim == dim
                 else leaf.shape[dim])
        if local % binding.extent(phys):
            return None
        return Block(dim, binding.axis_group(phys))

    if pieces is None:
        pieces = tree_lib.map_(lambda _: None, params_shape)
    return tree_lib.map_(block, specs, params_shape, pieces)


def fsdp_blocks(params_shape: Dict, pieces: Optional[Dict] = None
                ) -> Dict:
    """Tree (of the parameters' structure) of the FSDP `Block` over
    "data" of each parameter that this rank holds under the active
    binding, of its piece over "model" where ``pieces`` (`tp_pieces`)
    gives one; None where it holds the whole parameter (of its piece).
    Under a binding with ``fsdp_params`` the block lies along the dim
    where the reference's `param_pspecs` names "data": the dim the
    leaf's rule marks "fsdp" (wq / wk / wv / wi_* / in_proj on their
    input dim, wo / out_proj on their output dim, MLA's projections, the
    experts' d), where the whole leaf's and the piece's extents there
    divide, as `runtime.sharding.resolve` leaves them. The embeddings,
    the norms, the router and the SSM's conv and per-head leaves have no
    "fsdp": whole over "data". Without a binding, with fsdp off, or at a
    "data" extent of 1: every parameter whole. A piece never lies on
    the "fsdp" dim (it lies on the dim its rule names "model" or
    "expert", or the one `_tp_segments` picks: the SSM's and a shared KV
    head's last dim, the shared experts' width), so the block keeps the
    piece's layout along the piece's dim, where
    `train.steps.sum_shared_grads` and `optim.adamw.global_norm` read
    it."""
    binding = shlib.current_binding()
    if binding is None or not binding.fsdp_params:
        return tree_lib.map_(lambda _: None, params_shape)
    return _blocks_over_data(param_pspecs(params_shape), params_shape,
                             pieces, binding)


def zero1_blocks(params_shape: Dict, zero1: bool = True,
                 pieces: Optional[Dict] = None) -> Dict:
    """Tree (of the parameters' structure) of the `Block` over "data" of
    each Adam moment that this rank holds under the active binding, of
    its piece over "model" where ``pieces`` (`tp_pieces`) gives one;
    None where it holds the whole moment (of its piece). With ``zero1``
    the block lies along the dim where the reference's
    ``specs_from_logical(zero1_moment_axes(...), keep_fsdp=True)`` names
    "data", where the piece's extent there divides: a leaf whose rule
    marks "fsdp" keeps that dim, so its moment's block is its FSDP
    block (`fsdp_blocks`); the others take a free dim. Without, every
    moment is whole, as its parameter is over "data" (with FSDP,
    `train.steps.state_blocks` gives the moments of the FSDP leaves
    their parameters' blocks)."""
    binding = shlib.current_binding()
    if binding is None or not zero1:
        return tree_lib.map_(lambda _: None, params_shape)
    specs = specs_from_logical(
        zero1_moment_axes(logical_param_axes(params_shape), params_shape),
        params_shape, keep_fsdp=True)
    return _blocks_over_data(specs, params_shape, pieces, binding)


# ---------------------------------------------------------------------------
# The port's: the layout of a cache or a batch, and the decode relayout
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Parts:
    """What this rank holds of a whole tensor laid out by the logical
    axes ``logical`` (one a dim): ``spec``, their resolved spec (the
    reference's ``PartitionSpec`` entries, extent-1 axes included), and
    along each dim that a wider axis splits, this rank's `Block` (or,
    for the SSM's conv state over "model", its `Piece`), in ``parts``.
    No parts: the whole tensor on every rank."""
    logical: Tuple
    spec: Tuple
    parts: Tuple = ()

    def take(self, full):
        """The rank's part of ``full``: a view where every part is one
        contiguous block, else a new tensor."""
        for p in self.parts:
            full = p.take(full)
        return full

    def part_on(self, name: str):
        """The part along the dim that ``logical`` names ``name``, or
        None."""
        if name not in self.logical:
            return None
        dim = self.logical.index(name)
        return next((p for p in self.parts if p.dim == dim), None)


def _conv_segments(cfg, m: int) -> Tuple[Segment, ...]:
    """The SSM conv state's last dim [x | B | C] as conv_w's piece cuts
    it: x by head, B and C whole (`_tp_segments`)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    ns = cfg.ssm_state
    return (Segment(0, d_inner, m), Segment(d_inner, ns, 1),
            Segment(d_inner + ns, ns, 1))


def _is_logical(x) -> bool:
    return isinstance(x, tuple) and all(
        a is None or isinstance(a, (str, tuple)) for a in x)


def layout_of(logical: Tuple, shape, cfg=None, conv: bool = False
              ) -> Parts:
    """The `Parts` that the active binding gives a whole tensor of
    ``shape`` whose dims the logical axes ``logical`` name: each dim's
    spec by `runtime.sharding.resolve` (divisibility-safe, a mesh axis
    claimed once), and a `Block` over the ranks of each entry wider than
    one rank; with ``conv`` (the SSM's conv state of a block whose heads
    "model" divides, ``cfg`` given) its "model" dim as conv_w's piece,
    whatever that dim's length (the piece is cut by head). Without a
    binding: the whole."""
    binding = shlib.current_binding()
    rshape = list(shape)
    if conv and "model" in logical:
        rshape[logical.index("model")] = 0        # every extent divides 0
    spec = shlib.resolve(tuple(rshape), *logical)
    if binding is None:
        return Parts(tuple(logical), spec)
    parts = []
    for dim, entry in enumerate(spec):
        phys = (entry,) if isinstance(entry, str) else tuple(entry or ())
        if binding.extent(phys) <= 1:
            continue
        axis = binding.axis_group(phys)
        if conv and phys == ("model",):
            parts.append(Piece(dim, _conv_segments(cfg, axis.extent),
                               axis))
        else:
            parts.append(Block(dim, axis))
    return Parts(tuple(logical), spec, tuple(parts))


def cache_layout(model, cache_shapes, seq_sharded: bool = False) -> Dict:
    """Tree (of the cache's structure) of the `Parts` that this rank
    holds of each leaf of a whole cache of ``cache_shapes`` (tensors or
    ``meta`` tensors) under the active binding: the reference's
    ``_cache_shardings``, from ``model.cache_specs(seq_sharded=...)``
    through `runtime.sharding.resolve`. The prefill cell's layout
    (``seq_sharded`` False), which a decode cell without
    ``seq_shard_decode`` keeps: the batch over the "batch" rule's axes
    ("data", or ("pod", "data")), the KV heads over "model" where it
    divides them (else every KV head on every rank), the SSM's states
    over "model" by head; the decode cell's with ``seq_shard_decode``:
    the sequence over the "seq" rule's axes, which take "model" from
    the KV heads (then whole). The SSM's states
    are whole on every rank where "model" does not divide its heads (the
    block is whole, `tp_layout`), whatever their widths. Raises
    `NotImplementedError` where the "seq" ranks do not divide a
    sequence that ``seq_sharded`` splits: the reference would replicate
    such a leaf, and the port's decode step runs on the rank's part."""
    cfg = model.cfg
    binding = shlib.current_binding()
    m = binding.extent(binding.rules.get("model", ())) if binding else 1
    ssm_whole = (m > 1 and cfg.family in ("ssm", "hybrid")
                 and tp_layout(cfg, m)["ssm"] == "whole")

    def leaf(logical, t, path):
        ssm = path.endswith("conv") or path.endswith("ssm")
        if ssm and ssm_whole:
            logical = tuple(None if a == "model" else a for a in logical)
        out = layout_of(logical, t.shape, cfg,
                        conv=path.endswith("conv"))
        if binding is not None and seq_sharded and "seq" in logical:
            dim = logical.index("seq")
            want = tuple(a for a in binding.rules.get("seq", ())
                         if a not in _claimed(out, dim))
            if binding.extent(want) > 1 and out.part_on("seq") is None:
                raise NotImplementedError(
                    f"cache {path}: {t.shape[dim]} positions do not "
                    f"split over {want}")
        return out

    def walk(spec, shapes, path):
        if _is_logical(spec):
            return leaf(spec, shapes, path)
        return {k: walk(spec[k], shapes[k], f"{path}/{k}")
                for k in shapes}
    return walk(model.cache_specs(seq_sharded=seq_sharded), cache_shapes,
                "")


def _claimed(parts: Parts, dim: int) -> set:
    """The mesh axes that dims before ``dim`` claim in ``parts.spec``."""
    out = set()
    for entry in parts.spec[:dim]:
        out.update((entry,) if isinstance(entry, str) else (entry or ()))
    return out


def take_parts(whole: Dict, layouts: Dict) -> Dict:
    """This rank's part of each leaf of the whole tree ``whole`` (a
    cache, a batch, parameters) by ``layouts`` (a tree of `Parts`,
    `Shard` or None: the whole leaf), each in storage of its own."""
    return tree_lib.map_(
        lambda t, lay: t if lay is None else lay.take(t).clone(
            memory_format=torch.contiguous_format), whole, layouts)


def gather_parts(local: Dict, layouts: Dict) -> Dict:
    """The whole tree of which every rank holds the `Parts` ``layouts``
    (``local`` here), each leaf gathered (`gather_whole`)."""
    return tree_lib.map_(gather_whole, local, layouts)


def gather_whole(local, parts: Parts):
    """The whole tensor of which every rank holds its `Parts` ``parts``
    (``local`` here): each part gathered over its ranks, last first."""
    from repro_torch.runtime import collectives
    for p in reversed(parts.parts):
        if isinstance(p, Piece):
            local = collectives.gather_piece(local, p)
        else:
            every = collectives.gathered(local.contiguous(), p.axis)
            local = torch.cat(list(every), dim=p.dim)
    return local


def relayout(cache: Dict, src: Dict, dst: Dict) -> Dict:
    """``cache`` (this rank's parts of it in the layout ``src``, the
    prefill cell's: `cache_layout` without ``seq_sharded``) in the
    layout ``dst`` (the decode cell's), leaf by leaf. A leaf whose
    sequence ``dst`` splits over ranks that include "model" while
    ``src`` splits its KV heads over "model" takes one all-to-all over
    "model" (a layer at a time): each rank sends each rank its heads of
    that rank's block of positions and receives every rank's heads of
    its own (at batch 1 over ("data", "model"), of its "data"
    coordinate's positions). A
    leaf whose KV heads are whole in ``src`` (gemma3-1b's one, or a
    count "model" does not divide) keeps the positions of its block; a
    leaf whose parts agree (the SSM's states, or every leaf where the
    "seq" ranks are one) comes back as it is."""
    def move(local, s: Parts, d: Parts):
        if s.parts == d.parts:
            return local
        seq = d.part_on("seq")
        heads, heads_d = s.part_on("kv_heads"), d.part_on("kv_heads")
        if seq is not None and s.part_on("seq") is None:
            if heads is not None and heads_d is None and (
                    "model" in seq.axis.axes):
                return _seq_all_to_all(local, seq, heads)
            if heads == heads_d:
                return seq.take(local).contiguous()
        raise NotImplementedError(f"relayout of {s.spec} into {d.spec}")

    return tree_lib.map_(move, cache, src, dst)


def _seq_all_to_all(local, seq: Block, heads: Block):
    """The rank's `Block` ``seq`` of positions, every KV head, from each
    "model" rank's `Block` ``heads`` of the heads, every position (of
    the coarse block of its coordinate on the "seq" group's other axes
    where the group spans more than "model", as ("data", "model") at
    batch 1: "model" is the group's last axis, so its index is that
    coordinate times m plus the "model" one): one all-to-all over
    "model" a layer (the leaf's leading dim), so the buffers stay one
    layer's."""
    import torch.distributed as dist
    m = heads.axis.extent
    n = seq.axis.extent
    k = local.shape[seq.dim] // n
    if tuple(seq.axis.axes) != ("model",):      # the coarse block
        local = local.narrow(seq.dim, (seq.axis.index // m) * m * k, m * k)
    shape = list(local.shape)
    shape[seq.dim], shape[heads.dim] = k, shape[heads.dim] * m
    out = local.new_empty(shape)
    sd, hd = seq.dim - 1, heads.dim - 1     # dims of one layer
    for i in range(local.shape[0]):
        send = local[i].unflatten(sd, (m, k)).movedim(sd, 0).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=heads.axis.group)
        # recv[j]: rank j's heads of this rank's positions, in rank order
        out[i] = recv.movedim(0, hd).flatten(hd, hd + 1)
    return out
