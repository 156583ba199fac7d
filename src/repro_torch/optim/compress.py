"""Gradient compression: an int8 all-reduce over the data axes.

The port of the reference's ``repro.optim.compress``: per-tensor
symmetric int8 quantization before the sum over ranks, dequantization
after. 4x fewer bytes on the wire for the data-parallel all-reduce at
the cost of one extra max-reduce (the scale) and bounded quantization
noise (the residual is returned so callers can carry it: error
feedback).

Usage, on every rank of the mesh bound by `runtime.sharding.use_binding`,
over the data axes (("pod", "data") on a mesh with a "pod" axis, as the
reference's usage names them; their group is `runtime.sharding.Binding.
axis_group`'s):

    grads, residual = compressed_psum_mean(grads, ("pod", "data"), residual)

Like the reference's ``TrainConfig.grad_compression``, nothing in the
train step calls it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import tree as tree_lib
from repro_torch.runtime import sharding as shlib


def compressed_psum_mean(grads: Dict, axis_names,
                         residual: Optional[Dict] = None
                         ) -> Tuple[Dict, Optional[Dict]]:
    """Quantize -> sum over ranks -> dequantize -> mean over `axis_names`
    (mesh axes of the active binding).

    The quantization scale is agreed across ranks first (one scalar
    all-reduce MAX per tensor), so every rank's int8 payload shares one
    codebook and the summed reconstruction is exact up to rounding:
    per-element error <= scale/2 after the mean. The reference's order
    of operations: scale = max|g + r| / 127 + 1e-12, then its MAX over
    ranks; q = clamp(round(g / scale), ±127) as int8 (round half to
    even in both); the int32 sum of q over ranks; mean = sum * scale / n;
    new residual = (g + r) - q * scale.

    grads: tree of this rank's gradients (any float dtype; f32 math).
    residual: optional error-feedback tree of the same structure.
    Returns (mean_grads f32, new_residual or None).
    """
    binding = shlib.current_binding()
    if binding is None:
        raise ValueError("compressed_psum_mean needs a mesh binding "
                         "(runtime.sharding.use_binding)")
    names = (tuple(axis_names) if isinstance(axis_names, (tuple, list))
             else (axis_names,))
    axis = binding.axis_group(names)
    n = axis.extent

    def reduce(t, op):
        if axis.group is not None:
            dist.all_reduce(t, op=op, group=axis.group)
        return t

    def one(g, r):
        gf = g.float()
        if r is not None:
            gf = gf + r
        # divisors as tensors on gf's device: a Python number would make
        # CUDA multiply by its rounded reciprocal, the CPU divide
        local_scale = gf.abs().max() / gf.new_tensor(127.0) + 1e-12
        scale = reduce(local_scale, dist.ReduceOp.MAX)
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        deq = q.float() * scale
        new_r = gf - deq if r is not None else None
        # int8 on the wire: the sum of int32-accumulated quantized values
        summed = reduce(q.to(torch.int32), dist.ReduceOp.SUM)
        mean = summed.float() * scale / gf.new_tensor(float(n))
        return mean, new_r

    flat_g = tree_lib.leaves(grads)
    flat_r = (tree_lib.leaves(residual) if residual is not None
              else [None] * len(flat_g))
    out = [one(g, r) for g, r in zip(flat_g, flat_r)]
    mean = tree_lib.unflatten(grads, [o[0] for o in out])
    new_res = (tree_lib.unflatten(grads, [o[1] for o in out])
               if residual is not None else None)
    return mean, new_res
