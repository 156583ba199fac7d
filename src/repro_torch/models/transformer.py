"""Decoder-only transformer LM: dense, MoE (incl. MLA) and VLM backbones.

Covers qwen3-8b, granite-3-8b, llama3-405b, gemma3-1b (5:1
local:global), qwen2-vl-2b (M-RoPE and the vision-embedding stub),
granite-moe-3b-a800m and deepseek-v2-236b (MLA + 160-expert MoE): the
port of the reference's ``repro.models.transformer``. Per-layer
parameters are stacked on a leading layer axis, as in the reference;
the trunk runs as a Python loop over the layers, each layer's body under
`common.remat` where the reference checkpoints it; under FSDP the body
first gathers its layer's blocks (`common.fsdp_gather`), the MoE's
experts and MLA's projections with the rest. The layer's kind
(gemma3's local or global) is a 0-d tensor on the device, and so are
its window (``torch.where(is_local, sliding_window, 0)``, the
reference's traced ``jnp.where``) and its rope base: nothing about a
layer is read back to the host.

Because the window is a tensor, `gqa_attention` never takes the flash
kernel here, even with ``use_flash_kernel`` set: the reference's
condition wants a Python int 0, and its scanned layers pass a traced
array (ROADMAP C). The port keeps that condition.

A layer takes MLA (`attention.mla_attention`, `mla_decode`) under
``use_mla`` and an MoE block (`models.moe`, dispatch by ``moe_variant``)
where the config has experts; `forward` averages the MoE losses over
the layers (zeros for a dense model, as the reference's).
`decode_step` writes each layer's token into the stacked cache in place
(the V2 blend builds new tensors, copied back) and returns it; it runs on
the rank's heads, experts and vocabulary slice under a "model" axis,
gathers each layer's FSDP blocks first, and attends over the rank's
block of positions where the decode cache is split along its sequence
(`models.attention`).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common, moe
from repro_torch.models.common import dtype_of


def init_params(cfg: ModelConfig, gen: torch.Generator, device) -> Dict:
    dtype = dtype_of(cfg.param_dtype)
    lead = (cfg.n_layers,)
    layers = {
        "ln1": common.rmsnorm_params(cfg.d_model, dtype, device, lead),
        "ln2": common.rmsnorm_params(cfg.d_model, dtype, device, lead),
        "attn": (attention.mla_params if cfg.use_mla
                 else attention.attn_params)(cfg, dtype, gen, device, lead),
    }
    if cfg.n_experts:
        layers["moe"] = moe.moe_params(cfg, dtype, gen, device, lead)
    else:
        layers["mlp"] = common.mlp_params(cfg.d_model, cfg.d_ff, dtype, gen,
                                          device, lead)
    return {
        "embed": common.embed_params(cfg, dtype, gen, device),
        "layers": layers,
        "final_norm": common.rmsnorm_params(cfg.d_model, dtype, device),
    }


def layer_kinds(cfg: ModelConfig) -> np.ndarray:
    """Per-layer is_local flags (gemma3's N:1 pattern; all-global else)."""
    if cfg.local_global_pattern > 0:
        period = cfg.local_global_pattern + 1
        return (np.arange(cfg.n_layers) % period
                != cfg.local_global_pattern).astype(np.int32)
    return np.zeros((cfg.n_layers,), dtype=np.int32)


def _kinds(cfg: ModelConfig, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(is_local (L,) bool, window (L,) int32), `layer_kinds` made on
    ``device`` (no host copy): row i is layer i's 0-d kind and window."""
    ids = torch.arange(cfg.n_layers, device=device)
    period = cfg.local_global_pattern + 1
    is_local = ((ids % period != cfg.local_global_pattern)
                if cfg.local_global_pattern > 0 else ids < 0)
    window = torch.where(is_local, cfg.sliding_window, 0).to(torch.int32)
    return is_local, window


def _embed_scale(cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """gemma-style sqrt(d) embedding scale (dense, vocab past 200k), in
    the embedding's dtype as the reference's."""
    if cfg.family == "dense" and cfg.vocab_size > 200_000:
        return h * torch.tensor(np.sqrt(cfg.d_model), dtype=h.dtype)
    return h


def embed_inputs(params: Dict, cfg: ModelConfig, batch: Dict
                 ) -> torch.Tensor:
    """Token embeddings; with a frontend (the VLM's stub) the batch's
    precomputed ``embeds`` replace them where ``embed_mask`` is 1."""
    h = common.embed_tokens(params["embed"], batch["tokens"], cfg)
    if cfg.frontend != "none" and "embeds" in batch:
        m = batch["embed_mask"][..., None].to(h.dtype)
        h = h * (1.0 - m) + batch["embeds"].to(h.dtype) * m
    return _embed_scale(cfg, h)


def _positions(cfg: ModelConfig, batch: Dict) -> torch.Tensor:
    """The batch's ``positions`` where it has them, else 0..S-1 per row,
    broadcast to (B, 3, S) under M-RoPE."""
    if "positions" in batch:
        return batch["positions"]
    pos = common.positions_of(batch["tokens"])
    if cfg.mrope_sections:
        pos = pos[:, None, :].expand(-1, 3, -1)
    return pos


def _ffn(lp: Dict, cfg: ModelConfig, x: torch.Tensor):
    """(the layer's MLP or MoE output, its MoE losses or None)."""
    if cfg.n_experts:
        return moe.moe_apply(lp["moe"], cfg, x)
    return common.mlp_apply(lp["mlp"], x, cfg.d_ff), None


def _block(lp: Dict, cfg: ModelConfig, h, positions, is_local, window,
           return_kv: bool = False):
    a_in = common.rmsnorm(lp["ln1"], h)
    if cfg.use_mla:
        res = attention.mla_attention(lp["attn"], cfg, a_in, positions,
                                      return_kv=return_kv)
    else:
        res = attention.gqa_attention(lp["attn"], cfg, a_in, positions,
                                      window=window, is_local=is_local,
                                      return_kv=return_kv)
    a_out, kv = res if return_kv else (res, None)
    h = h + a_out
    f_out, aux = _ffn(lp, cfg, common.rmsnorm(lp["ln2"], h))
    return h + f_out, kv, aux


def forward(params: Dict, cfg: ModelConfig, batch: Dict
            ) -> Tuple[torch.Tensor, Dict]:
    """-> (hidden (B, S, D), {"moe_lb_loss", "moe_z_loss"}: f32 scalars
    averaged over the layers, zeros without experts)."""
    h = embed_inputs(params, cfg, batch)
    positions = _positions(cfg, batch)
    is_local, window = _kinds(cfg, h.device)
    lb = torch.zeros((), dtype=torch.float32, device=h.device)
    z = torch.zeros((), dtype=torch.float32, device=h.device)

    def body(hcur, lp, loc, win):
        hcur, _, aux = _block(common.fsdp_gather(lp, "layers"), cfg, hcur,
                              positions, loc, win)
        return hcur, aux

    body = common.remat(cfg, body)
    layers = common.unstacked(params["layers"], cfg.n_layers)
    for i, lp in enumerate(layers):
        h, aux = body(h, lp, is_local[i], window[i])
        if aux is not None:
            lb = lb + aux["moe_lb_loss"]
            z = z + aux["moe_z_loss"]
    denom = max(cfg.n_layers, 1)
    return common.rmsnorm(params["final_norm"], h), {
        "moe_lb_loss": lb / denom, "moe_z_loss": z / denom}


def loss_fn(params: Dict, cfg: ModelConfig, batch: Dict):
    """xent + 0.01 * load-balance loss + z-loss, and the three terms."""
    h, aux = forward(params, cfg, batch)
    logits = common.logits_from_hidden(params["embed"], cfg, h)
    xent = common.softmax_xent(
        logits, batch["labels"], batch.get("loss_mask"),
        split=common.vocab_split(params["embed"], cfg))
    loss = xent + 0.01 * aux["moe_lb_loss"] + aux["moe_z_loss"]
    return loss, {"xent": xent, **aux}


def prefill(params: Dict, cfg: ModelConfig, batch: Dict):
    """Fill the cache from a full prompt: (last-position logits (B, 1, V)
    f32, the stacked cache: {"k", "v"} of (L, B, S, hkv, dh), or under
    MLA {"c_kv" (L, B, S, rank), "k_rope" (L, B, S, 1, dr)})."""
    h = embed_inputs(params, cfg, batch)
    positions = _positions(cfg, batch)
    is_local, window = _kinds(cfg, h.device)

    def body(hcur, lp, loc, win):
        hcur, kv, _ = _block(common.fsdp_gather(lp, "layers"), cfg, hcur,
                             positions, loc, win, return_kv=True)
        return hcur, kv

    body = common.remat(cfg, body)
    kvs = []
    for i, lp in enumerate(common.unstacked(params["layers"],
                                            cfg.n_layers)):
        h, kv = body(h, lp, is_local[i], window[i])
        kvs.append(kv)
    h = common.rmsnorm(params["final_norm"], h)
    logits = common.logits_from_hidden(params["embed"], cfg, h[:, -1:])
    names = ("c_kv", "k_rope") if cfg.use_mla else ("k", "v")
    return logits, {name: torch.stack([kv[j] for kv in kvs])
                    for j, name in enumerate(names)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> Dict:
    dtype = dtype_of(cfg.compute_dtype)
    lead = (cfg.n_layers, batch, max_len)
    if cfg.use_mla:
        shapes = {"c_kv": lead + (cfg.kv_lora_rank,),
                  "k_rope": lead + (1, cfg.qk_rope_head_dim)}
    else:
        kv = lead + (cfg.n_kv_heads, cfg.head_dim)
        shapes = {"k": kv, "v": kv}
    return {k: torch.zeros(shape, dtype=dtype, device=device)
            for k, shape in shapes.items()}


def cache_specs(cfg: ModelConfig, *, seq_sharded: bool = False) -> Dict:
    """Logical axes of the cache's leaves, as the reference's; with
    ``seq_sharded`` the sequence axis is named "seq" (`_grow_cache`)."""
    seq_ax = "seq" if seq_sharded else None
    if cfg.use_mla:
        return {"c_kv": (None, "batch", seq_ax, None),
                "k_rope": (None, "batch", seq_ax, None, None)}
    return {"k": (None, "batch", seq_ax, "kv_heads", None),
            "v": (None, "batch", seq_ax, "kv_heads", None)}


def decode_step(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Dict, lengths: torch.Tensor):
    """One decode step. tokens (B, 1); lengths (B,) write positions.
    Each layer writes its token into the stacked cache
    (`attention.gqa_decode_stacked`, or `mla_decode` under MLA) and
    attends to its slice. Returns (logits (B, 1, V) f32, cache), the
    cache updated in place."""
    h = _embed_scale(cfg, common.embed_tokens(params["embed"], tokens, cfg))
    is_local, window = _kinds(cfg, h.device)
    kv = cache
    for i in range(cfg.n_layers):
        lp = common.fsdp_gather(common.layer(params["layers"], i), "layers")
        a_in = common.rmsnorm(lp["ln1"], h)
        if cfg.use_mla:
            a_out, kv = attention.mla_decode(lp["attn"], cfg, a_in, kv,
                                             lengths, layer_idx=i)
        else:
            a_out, kv = attention.gqa_decode_stacked(
                lp["attn"], cfg, a_in, kv, lengths, i, window=window[i],
                is_local=is_local[i])
        h = h + a_out
        h = h + _ffn(lp, cfg, common.rmsnorm(lp["ln2"], h))[0]
    for key in cache:
        if kv[key] is not cache[key]:        # the CNN variant's new tensor
            cache[key].copy_(kv[key])
    h = common.rmsnorm(params["final_norm"], h)
    return common.logits_from_hidden(params["embed"], cfg, h), cache
