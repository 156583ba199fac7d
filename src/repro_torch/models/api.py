"""Uniform model API of the port, after the reference's ``models.api``.

`get_model(cfg, device=None)` returns a `Model` whose methods close over
the config and the device:
  init_params(seed)                 -> params (nested dict of tensors)
  loss_fn(params, batch)            -> (scalar loss, metrics)
  forward(params, batch)            -> (hidden, aux)
  prefill(params, batch)            -> (logits, cache)
  init_cache(batch, max_len, ...)   -> cache (enc-dec: also enc_len)
  decode_step(params, tokens, cache, lengths) -> (logits, cache)
  cache_specs(seq_sharded=...)      -> logical axes of the cache's leaves

The device is CUDA unless the caller passes ``device="cpu"`` (or
``device="meta"``, which the dry run names: `launch.dryrun`); without a
card the default raises. Every family of the reference is ported: the
transformer serves dense, MoE (with MLA) and the VLM, beside ssm
(mamba2), hybrid (zamba2) and audio (enc-dec).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pipeline import resolve_device
from repro_torch.models import encdec, hybrid, mamba_lm, transformer

_FAMILY_MODULES = {
    "dense": transformer,
    "moe": transformer,
    "vlm": transformer,
    "ssm": mamba_lm,
    "hybrid": hybrid,
    "audio": encdec,
}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    init_params: Callable
    loss_fn: Callable
    forward: Callable
    prefill: Callable
    init_cache: Callable
    decode_step: Callable
    cache_specs: Callable


def family_module(cfg: ModelConfig):
    """The module that implements ``cfg.family``; raises for a family
    the reference does not have either."""
    if cfg.family not in _FAMILY_MODULES:
        raise NotImplementedError(
            f"model family {cfg.family!r} ({cfg.name}) has no module "
            f"(ported: {sorted(_FAMILY_MODULES)})")
    return _FAMILY_MODULES[cfg.family]


def get_model(cfg: ModelConfig, device=None) -> Model:
    mod = family_module(cfg)
    named = None if device is None else torch.device(device)
    # "meta" only where a caller names it: the dry run's shapes without
    # storage (`launch.dryrun`); else CUDA, or the CPU where asked
    dev = named if named is not None and named.type == "meta" \
        else resolve_device(device)

    def init_params(seed: int = 0):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return mod.init_params(cfg, gen, dev)

    def with_cfg(fn):
        def wrapped(params, *args, **kwargs):
            return fn(params, cfg, *args, **kwargs)
        return wrapped

    return Model(
        cfg=cfg, device=dev,
        init_params=init_params,
        loss_fn=with_cfg(mod.loss_fn),
        forward=with_cfg(mod.forward),
        prefill=with_cfg(mod.prefill),
        init_cache=functools.partial(mod.init_cache, cfg, device=dev),
        decode_step=with_cfg(mod.decode_step),
        cache_specs=functools.partial(mod.cache_specs, cfg),
    )
