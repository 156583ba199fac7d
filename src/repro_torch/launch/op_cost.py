"""Operation counts of eager PyTorch code, per rank: FLOPs, bytes,
collective bytes and the peak of live bytes.

The counterpart of the reference's ``launch/hlo_cost.py``, which reads
them off a compiled module's HLO text. The port has no compiled
program, so `counting` is a ``TorchDispatchMode`` that costs every ATen
op a block runs, by the reference's conventions (``hlo_cost.py``'s
module doc):

  * a matmul-like op (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``addbmm``,
    ``mv``, ``dot``: what ``einsum``, ``matmul`` and ``linear`` dispatch
    to): 2 * prod(result) * prod(contracted) FLOPs, and these alone in
    `Cost.matmul_flops`;
  * an elementwise op: its result's element count; a reduction: its
    operand's;
  * ``bytes``: operands plus result at every op. Eager PyTorch fuses
    nothing, so every op is a boundary (the reference's ``bytes`` counts
    at XLA:CPU's fusion boundaries);
  * ``bytes_min``: matmul, reduction, collective, copy and slice traffic
    only, the reference's fused-ideal bound;
  * views, reshapes, ``empty``, ``arange`` and the like are free;
  * gather, index and scatter ops touch only their window (a gather's
    result, a scatter's update) and add their elements to
    ``gather_elems``.

Collectives are tallied by kind at their ``torch.distributed`` calls
(`tallied`), each by its **result** bytes, the reference's wire-bytes
proxy: an all-reduce counts its tensor once, an all-gather its gathered
output, a reduce-scatter its block. Python's loops over layers run every
layer, so the cost is loop-aware by construction: nothing stands for the
reference's trip counts.

The peak of live bytes is the counterpart of ``memory_analysis()``'s
temp bytes: the mode follows each new storage an op creates (a storage
none of the op's inputs holds) from its creation until it is freed.
Views share their base's storage and in-place ops allocate nothing; the
tensors that autograd and ``torch.utils.checkpoint`` save stay alive
until they are released. On the ``meta`` device nothing is allocated,
so a step at full size is costed on any host.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Dict, Iterator, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "broadcast")

# torch.distributed's collectives by name: their kind (the result is
# the first argument, a tensor or a list of them)
_CALLS = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_single": "all-gather",
    "all_gather": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_single": "reduce-scatter",
    "reduce_scatter": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "all_to_all": "all-to-all",
    "broadcast": "broadcast",
}

# matmul-like ops: the operand whose last dim is contracted
_MATMUL = {"mm": 0, "bmm": 0, "mv": 0, "dot": 0, "addmm": 1,
           "baddbmm": 1, "addbmm": 1}
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "argmax",
           "argmin", "prod", "var", "std", "var_mean", "std_mean",
           "logsumexp", "norm", "linalg_vector_norm", "any", "all",
           "_softmax", "_log_softmax", "_softmax_backward_data",
           "_log_softmax_backward_data", "topk", "sort"}
_COPY = {"copy_", "clone", "cat"}
_GATHER = {"gather", "index_select", "embedding", "index", "take",
           "narrow_copy"}
# scatter-like ops: the argument that is the update (the window)
_SCATTER = {"scatter": 3, "scatter_": 3, "scatter_add": 3,
            "scatter_add_": 3, "scatter_reduce": 3, "scatter_reduce_": 3,
            "index_put": 2, "index_put_": 2, "_index_put_impl_": 2,
            "index_add": 3, "index_add_": 3, "index_copy": 3,
            "index_copy_": 3, "slice_scatter": 1, "select_scatter": 1,
            "embedding_dense_backward": 0, "slice_backward": 0,
            "select_backward": 0, "masked_scatter": 2}
# free besides the views (and the ops that return no tensor)
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "arange", "scalar_tensor", "lift_fresh",
         "lift_fresh_copy", "_unsafe_view"}


@dataclasses.dataclass
class Cost:
    """The reference's `hlo_cost.Cost` fields (``bytes``: every op's
    operands and result; ``bytes_min``: matmul / reduction / collective /
    copy / slice traffic only), with ``matmul_flops`` (the matmul-like
    ops' FLOPs alone), ``calls`` (collective calls by kind) and
    ``temp_bytes`` (the largest sum of bytes alive, of the storages the
    block created)."""

    flops: float = 0.0
    matmul_flops: float = 0.0
    bytes: float = 0.0
    bytes_min: float = 0.0
    gather_elems: float = 0.0
    coll: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in KINDS})
    calls: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {k: 0 for k in KINDS})
    temp_bytes: int = 0

    @property
    def coll_bytes(self) -> float:
        return sum(self.coll.values())

    @property
    def coll_calls(self) -> int:
        return sum(self.calls.values())


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tensors_of(x) -> List[torch.Tensor]:
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


@contextlib.contextmanager
def tallied(cost: Cost = None) -> Iterator[Cost]:
    """Each ``torch.distributed`` collective called in the block (as
    ``dist.<name>``, the way the port calls them) tallied into ``cost``
    (a new `Cost` by default, yielded): one call and its result bytes by
    kind, the result bytes also into ``bytes`` and ``bytes_min``. Costs
    nothing else, so a timed step may run inside it."""
    import torch.distributed as dist
    cost = Cost() if cost is None else cost
    kept = {n: getattr(dist, n) for n in _CALLS if hasattr(dist, n)}

    def counted(name, fn):
        kind = _CALLS[name]

        def call(*args, **kwargs):
            result = args[0] if args else next(iter(kwargs.values()))
            n = sum(_nbytes(t) for t in tensors_of(result))
            cost.calls[kind] += 1
            cost.coll[kind] += n
            cost.bytes += n
            cost.bytes_min += n
            return fn(*args, **kwargs)
        return call
    for name, fn in kept.items():
        setattr(dist, name, counted(name, fn))
    try:
        yield cost
    finally:
        for name, fn in kept.items():
            setattr(dist, name, fn)


def _contracted(name: str, args) -> int:
    lhs = args[_MATMUL[name]]
    return lhs.shape[-1] if lhs.dim() else 1


class _Counting(TorchDispatchMode):
    def __init__(self, cost: Cost):
        super().__init__()
        self.cost = cost
        self.live: Dict[int, int] = {}
        self.now = 0

    def _free(self, key: int) -> None:
        self.now -= self.live.pop(key, 0)

    def _track(self, outs: List[torch.Tensor], ins: List[torch.Tensor]
               ) -> None:
        held = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in held or key in self.live:
                continue
            self.live[key] = st.nbytes()
            self.now += self.live[key]
            weakref.finalize(st, self._free, key)
        self.cost.temp_bytes = max(self.cost.temp_bytes, self.now)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins, outs = tensors_of((args, kwargs)), tensors_of(out)
        self._track(outs, ins)
        name = func.overloadpacket.__name__
        if (func.namespace != "aten" or func.is_view or name in _FREE
                or not outs):
            return out
        c = self.cost
        n_out = sum(t.numel() for t in outs)
        b_out = sum(_nbytes(t) for t in outs)
        b_in = sum(_nbytes(t) for t in ins)
        if name in _MATMUL:
            f = 2.0 * outs[0].numel() * _contracted(name, args)
            c.flops += f
            c.matmul_flops += f
            c.bytes += b_in + b_out
            c.bytes_min += b_in + b_out
        elif name in _GATHER:
            c.flops += n_out
            c.gather_elems += n_out
            c.bytes += 2.0 * b_out
            c.bytes_min += 2.0 * b_out
        elif name in _SCATTER:
            i = _SCATTER[name]
            window = tensors_of(args[i:i + 1]) or outs
            c.flops += sum(t.numel() for t in window)
            c.bytes += 2.0 * sum(_nbytes(t) for t in window)
            c.bytes_min += 2.0 * sum(_nbytes(t) for t in window)
        elif name in _REDUCE:
            op0 = ins[0]
            c.flops += op0.numel()
            c.bytes += b_in + b_out
            c.bytes_min += _nbytes(op0) + b_out
        else:
            c.flops += n_out
            c.bytes += b_in + b_out
            if name in _COPY:
                c.bytes_min += 2.0 * b_out
        return out


@contextlib.contextmanager
def counting() -> Iterator[Cost]:
    """The `Cost` of the block (yielded, filled as it runs): every ATen
    op it dispatches, its ``torch.distributed`` collectives (`tallied`)
    and the peak of the bytes its new storages hold alive."""
    cost = Cost()
    with tallied(cost), _Counting(cost):
        yield cost

