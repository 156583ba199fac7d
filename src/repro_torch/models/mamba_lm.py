"""mamba2-130m: an attention-free SSM language model.

The port of the reference's ``repro.models.mamba_lm``, on the port's
Mamba2 block (`models.ssm`). Per-layer parameters are stacked on a
leading layer axis, as in the reference; the trunk runs as a Python loop
over the layers, each layer's body under `common.remat` where the
reference checkpoints it (under FSDP gathering its layer's blocks first:
`common.fsdp_gather`). `forward` and `loss_fn` take the CUDA ``ssd_scan``
kernel where the config sets ``use_ssd_kernel``; `prefill` never does,
because it asks every layer for its final state, which the kernel does
not return (as the reference, ROADMAP C).

There is no gather anywhere in this model, so the paper's variants do
not apply to it. `decode_step` writes the new conv and SSM states into
the stacked cache in place and returns it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common, ssm
from repro_torch.models.common import dtype_of


def init_params(cfg: ModelConfig, gen: torch.Generator, device) -> Dict:
    dtype = dtype_of(cfg.param_dtype)
    lead = (cfg.n_layers,)
    return {
        "embed": common.embed_params(cfg, dtype, gen, device),
        "layers": {
            "ln": common.rmsnorm_params(cfg.d_model, dtype, device, lead),
            "ssm": ssm.ssm_params(cfg, dtype, gen, device, lead)},
        "final_norm": common.rmsnorm_params(cfg.d_model, dtype, device),
    }


def forward(params: Dict, cfg: ModelConfig, batch: Dict
            ) -> Tuple[torch.Tensor, Dict]:
    h = common.embed_tokens(params["embed"], batch["tokens"], cfg)

    def body(hcur, lp):
        lp = common.fsdp_gather(lp, "layers")
        return hcur + ssm.ssm_apply(lp["ssm"], cfg,
                                    common.rmsnorm(lp["ln"], hcur))

    body = common.remat(cfg, body)
    for lp in common.unstacked(params["layers"], cfg.n_layers):
        h = body(h, lp)
    return common.rmsnorm(params["final_norm"], h), {}


def loss_fn(params: Dict, cfg: ModelConfig, batch: Dict):
    h, _ = forward(params, cfg, batch)
    logits = common.logits_from_hidden(params["embed"], cfg, h)
    xent = common.softmax_xent(
        logits, batch["labels"], batch.get("loss_mask"),
        split=common.vocab_split(params["embed"], cfg))
    return xent, {"xent": xent}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> Dict:
    """Per-layer {"conv", "ssm"} states stacked on a leading layer axis;
    ``max_len`` is unused (the state has no sequence axis)."""
    del max_len
    return ssm.ssm_init_cache(cfg, batch, dtype_of(cfg.compute_dtype),
                              device, (cfg.n_layers,))


def cache_specs(cfg: ModelConfig, *, seq_sharded: bool = False) -> Dict:
    """Logical axes of the cache's leaves, as the reference's: no leaf
    has a sequence axis."""
    del seq_sharded
    return {"conv": (None, "batch", None, "model"),
            "ssm": (None, "batch", "model", None, None)}


def prefill(params: Dict, cfg: ModelConfig, batch: Dict):
    """-> (last-position logits (B, 1, V) f32, streaming cache)."""
    h = common.embed_tokens(params["embed"], batch["tokens"], cfg)

    def body(hcur, lp):
        lp = common.fsdp_gather(lp, "layers")
        out, state = ssm.ssm_apply(lp["ssm"], cfg,
                                   common.rmsnorm(lp["ln"], hcur),
                                   return_state=True)
        return hcur + out, state

    body = common.remat(cfg, body)
    convs, states = [], []
    for lp in common.unstacked(params["layers"], cfg.n_layers):
        h, state = body(h, lp)
        convs.append(state["conv"])
        states.append(state["ssm"])
    h = common.rmsnorm(params["final_norm"], h)
    logits = common.logits_from_hidden(params["embed"], cfg, h[:, -1:])
    return logits, {"conv": torch.stack(convs), "ssm": torch.stack(states)}


def decode_step(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Dict, lengths: torch.Tensor):
    """One token per slot; ``lengths`` is unused (the SSM state has no
    position) but kept for the API. Writes the new states into ``cache``
    in place and returns (logits (B, 1, V) f32, cache)."""
    del lengths
    h = common.embed_tokens(params["embed"], tokens, cfg)
    for i in range(cfg.n_layers):
        lp = common.fsdp_gather(common.layer(params["layers"], i), "layers")
        out, new = ssm.ssm_decode(lp["ssm"], cfg,
                                  common.rmsnorm(lp["ln"], h),
                                  common.layer(cache, i))
        h = h + out
        cache["conv"][i] = new["conv"]
        cache["ssm"][i] = new["ssm"]
    h = common.rmsnorm(params["final_norm"], h)
    return common.logits_from_hidden(params["embed"], cfg, h), cache
