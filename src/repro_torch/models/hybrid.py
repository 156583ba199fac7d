"""zamba2-1.2b: a Mamba2 trunk and one *shared* attention block.

The port of the reference's ``repro.models.hybrid``. One set of attention
weights runs after every ``shared_attn_every`` Mamba2 layers (6 times
over zamba2-1.2b's 38 layers); each invocation keeps its own KV cache
slot. Per-layer parameters are stacked on a leading layer axis, as in
the reference, and the trunk runs as a Python loop over the layers, each
Mamba2 layer under `common.remat` (the reference checkpoints those, not
the shared block).

`decode_step` updates the cache in place and returns it: the Mamba2
states and the KV rows are written into the stacked tensors the caller
passed (the reference builds a new cache each step; the old one is
never read again by serving).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common, ssm
from repro_torch.models.common import dtype_of


def _segments(cfg: ModelConfig) -> List[Tuple[int, int]]:
    """[(start, end)) mamba-layer segments; shared attn runs between them."""
    step = cfg.shared_attn_every or cfg.n_layers
    bounds = list(range(0, cfg.n_layers, step)) + [cfg.n_layers]
    return list(zip(bounds[:-1], bounds[1:]))


def n_attn_invocations(cfg: ModelConfig) -> int:
    return len(_segments(cfg)) - 1


def init_params(cfg: ModelConfig, gen: torch.Generator, device) -> Dict:
    dtype = dtype_of(cfg.param_dtype)
    lead = (cfg.n_layers,)
    layers = {"ln": common.rmsnorm_params(cfg.d_model, dtype, device, lead),
              "ssm": ssm.ssm_params(cfg, dtype, gen, device, lead)}
    shared = {
        "ln1": common.rmsnorm_params(cfg.d_model, dtype, device),
        "attn": attention.attn_params(cfg, dtype, gen, device),
        "ln2": common.rmsnorm_params(cfg.d_model, dtype, device),
        "mlp": common.mlp_params(cfg.d_model, cfg.d_ff, dtype, gen, device),
    }
    return {
        "embed": common.embed_params(cfg, dtype, gen, device),
        "layers": layers,
        "shared_attn": shared,
        "final_norm": common.rmsnorm_params(cfg.d_model, dtype, device),
    }


def _mamba_layer(cfg: ModelConfig, collect_state: bool = False):
    """One Mamba2 layer's residual body, under `common.remat` (the
    reference checkpoints each scanned layer); with ``collect_state`` it
    also returns the layer's streaming state."""
    def body(hcur, lp):
        lp = common.fsdp_gather(lp, "layers")
        res = ssm.ssm_apply(lp["ssm"], cfg, common.rmsnorm(lp["ln"], hcur),
                            return_state=collect_state)
        if collect_state:
            return hcur + res[0], res[1]
        return hcur + res

    return common.remat(cfg, body)


def _shared_attn_block(cfg: ModelConfig, shared: Dict, h, positions,
                       return_kv: bool = False):
    """The shared block at one of its uses; under FSDP its blocks are
    gathered at each use, and autograd adds the uses' reduce-scattered
    gradients."""
    shared = common.fsdp_gather(shared, "shared_attn")
    a_in = common.rmsnorm(shared["ln1"], h)
    res = attention.gqa_attention(shared["attn"], cfg, a_in, positions,
                                  return_kv=return_kv)
    a_out, kv = res if return_kv else (res, None)
    h = h + a_out
    h = h + common.mlp_apply(shared["mlp"],
                             common.rmsnorm(shared["ln2"], h), cfg.d_ff)
    return (h, kv) if return_kv else h


def forward(params: Dict, cfg: ModelConfig, batch: Dict
            ) -> Tuple[torch.Tensor, Dict]:
    h = common.embed_tokens(params["embed"], batch["tokens"], cfg)
    positions = common.positions_of(batch["tokens"])
    segs = _segments(cfg)
    layers = common.unstacked(params["layers"], cfg.n_layers)
    body = _mamba_layer(cfg)
    for i, (st, en) in enumerate(segs):
        for lp in layers[st:en]:
            h = body(h, lp)
        if i < len(segs) - 1:
            h = _shared_attn_block(cfg, params["shared_attn"], h, positions)
    return common.rmsnorm(params["final_norm"], h), {}


def loss_fn(params: Dict, cfg: ModelConfig, batch: Dict):
    h, _ = forward(params, cfg, batch)
    logits = common.logits_from_hidden(params["embed"], cfg, h)
    xent = common.softmax_xent(
        logits, batch["labels"], batch.get("loss_mask"),
        split=common.vocab_split(params["embed"], cfg))
    return xent, {"xent": xent}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> Dict:
    dtype = dtype_of(cfg.compute_dtype)
    n_inv = n_attn_invocations(cfg)
    hkv, dh = cfg.n_kv_heads, cfg.head_dim
    return {
        "mamba": ssm.ssm_init_cache(cfg, batch, dtype, device,
                                    (cfg.n_layers,)),
        "attn_k": torch.zeros((n_inv, batch, max_len, hkv, dh), dtype=dtype,
                              device=device),
        "attn_v": torch.zeros((n_inv, batch, max_len, hkv, dh), dtype=dtype,
                              device=device),
    }


def cache_specs(cfg: ModelConfig, *, seq_sharded: bool = False) -> Dict:
    """Logical axes of the cache's leaves, as the reference's; with
    ``seq_sharded`` the sequence axis is named "seq" (`_grow_cache`)."""
    seq_ax = "seq" if seq_sharded else None
    return {
        "mamba": {"conv": (None, "batch", None, "model"),
                  "ssm": (None, "batch", "model", None, None)},
        "attn_k": (None, "batch", seq_ax, "kv_heads", None),
        "attn_v": (None, "batch", seq_ax, "kv_heads", None),
    }


def prefill(params: Dict, cfg: ModelConfig, batch: Dict):
    h = common.embed_tokens(params["embed"], batch["tokens"], cfg)
    positions = common.positions_of(batch["tokens"])
    segs = _segments(cfg)
    layers = common.unstacked(params["layers"], cfg.n_layers)
    body = _mamba_layer(cfg, collect_state=True)
    convs, states, attn_ks, attn_vs = [], [], [], []
    for i, (st, en) in enumerate(segs):
        for lp in layers[st:en]:
            h, st_l = body(h, lp)
            convs.append(st_l["conv"])
            states.append(st_l["ssm"])
        if i < len(segs) - 1:
            h, (k, v) = _shared_attn_block(cfg, params["shared_attn"], h,
                                           positions, return_kv=True)
            attn_ks.append(k)
            attn_vs.append(v)
    h = common.rmsnorm(params["final_norm"], h)
    logits = common.logits_from_hidden(params["embed"], cfg, h[:, -1:])
    cache = {
        "mamba": {"conv": torch.stack(convs), "ssm": torch.stack(states)},
        "attn_k": torch.stack(attn_ks),
        "attn_v": torch.stack(attn_vs),
    }
    return logits, cache


def decode_step(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Dict, lengths: torch.Tensor):
    """One token per slot; writes the new states and KV rows into
    ``cache`` in place and returns (logits (B, 1, V) f32, cache). Under
    a mesh on the rank's heads and parts of the cache, each layer's FSDP
    blocks gathered first (the shared block's at each use)."""
    h = common.embed_tokens(params["embed"], tokens, cfg)
    mamba = cache["mamba"]
    segs = _segments(cfg)
    for i, (st, en) in enumerate(segs):
        for li in range(st, en):
            lp = common.fsdp_gather(common.layer(params["layers"], li),
                                    "layers")
            out, new = ssm.ssm_decode(
                lp["ssm"], cfg, common.rmsnorm(lp["ln"], h),
                {"conv": mamba["conv"][li], "ssm": mamba["ssm"][li]})
            h = h + out
            mamba["conv"][li] = new["conv"]
            mamba["ssm"][li] = new["ssm"]
        if i < len(segs) - 1:
            shared = common.fsdp_gather(params["shared_attn"],
                                        "shared_attn")
            a_in = common.rmsnorm(shared["ln1"], h)
            k_i, v_i = cache["attn_k"][i], cache["attn_v"][i]
            a_out, kv = attention.gqa_decode(
                shared["attn"], cfg, a_in, {"k": k_i, "v": v_i}, lengths)
            h = h + a_out
            h = h + common.mlp_apply(shared["mlp"],
                                     common.rmsnorm(shared["ln2"], h),
                                     cfg.d_ff)
            for dst, src in ((k_i, kv["k"]), (v_i, kv["v"])):
                if src is not dst:            # the CNN variant's new tensor
                    dst.copy_(src)
    h = common.rmsnorm(params["final_norm"], h)
    return common.logits_from_hidden(params["embed"], cfg, h), cache
