"""Carry a JAX parameter pytree to the port's parameters.

`params_from_numpy(cfg, tree, device)` takes the reference's parameter
tree with numpy leaves (``jax.tree.map(np.asarray, params)``) and returns
the port's nested dict of tensors. The two trees have the same keys and
shapes, the stacked ``layers/*``, ``enc_layers/*`` and ``dec_layers/*``
leading axes, ``shared_attn``, the ``q_norm``/``k_norm`` leaves, the
``moe/*`` leaves (an f32 router in every dtype, experts (E_eff, d, f)
with the dead padding, ``shared``) and MLA's ``attn/*`` leaves
included; every key, shape and dtype is checked against the port's own
layout, and a bf16 leaf (numpy's ml_dtypes bfloat16) keeps its bits.
Under tensor parallelism it takes each rank's piece of the whole leaves
(``shards``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pipeline import resolve_device
from repro_torch.models.api import family_module


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:       # jax hands out read-only buffers
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _carry(spec, tree, device, path: str, shards):
    if isinstance(spec, dict):
        if not isinstance(tree, dict) or set(tree) != set(spec):
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"params{path}: keys {got}, expected "
                             f"{sorted(spec)}")
        return {k: _carry(spec[k], tree[k], device, f"{path}/{k}",
                          None if shards is None else shards[k])
                for k in spec}
    t = _tensor(np.asarray(tree), "cpu")
    if tuple(t.shape) != tuple(spec.shape) or t.dtype != spec.dtype:
        raise ValueError(f"params{path}: {tuple(t.shape)} {t.dtype}, "
                         f"expected {tuple(spec.shape)} {spec.dtype}")
    if shards is not None:
        t = shards.take(t)
    return t.to(device, memory_format=torch.contiguous_format)


def params_from_numpy(cfg: ModelConfig, tree: Dict, device=None,
                      shards: Dict = None) -> Dict:
    """The port's parameters from the reference's (numpy leaves); with
    ``shards`` (a tree of `runtime.param_sharding.Shard` or None, e.g.
    ``train.steps.state_blocks(...)["params"]``), this rank's piece of
    each leaf."""
    mod = family_module(cfg)
    dev = resolve_device(device)
    # the port's layout: shapes and dtypes only, nothing allocated
    spec = mod.init_params(cfg, None, torch.device("meta"))
    return _carry(spec, tree, dev, "", shards)

