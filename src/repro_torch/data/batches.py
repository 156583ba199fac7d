"""Synthetic LM batches (PyTorch port of ``repro.data.batches``).

Schema (train/prefill): tokens (B, S) int32, labels (B, S) int32; the
vlm family adds embeds (B, S, d_model) in the compute dtype, embed_mask
(B, S) int32 (the leading quarter of the sequence is image patches) and
M-RoPE positions (B, 3, S) int32; the audio (enc-dec) family adds
enc_embeds (B, S, d_model) in the compute dtype. The numpy generator is
the reference's, drawn in the same order, so a seed gives the same
arrays bit for bit in both packages.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dtype_of


def synth_train_batch(cfg: ModelConfig, batch: int, seq: int,
                      seed: int = 0, device="cpu") -> Dict:
    rng = np.random.default_rng(seed)
    out = {
        "tokens": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(
            np.int32),
        "labels": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(
            np.int32),
    }
    out = {k: torch.as_tensor(v).to(device) for k, v in out.items()}
    if cfg.family == "vlm":
        n_img = seq // 4                      # leading image-patch region
        out["embeds"] = _embeds(cfg, rng, batch, seq, device)
        mask = np.zeros((batch, seq), np.int32)
        mask[:, :n_img] = 1
        # M-RoPE triplets: patches get (t=0, h, w) grid positions; text
        # gets sequential positions on all three axes, from ``side``
        side = max(int(np.sqrt(n_img)), 1)
        pos = np.zeros((batch, 3, seq), np.int32)
        img = np.arange(n_img)
        pos[:, 1, :n_img] = img // side
        pos[:, 2, :n_img] = img % side
        pos[:, :, n_img:] = side + np.arange(seq - n_img)
        out["embed_mask"] = torch.as_tensor(mask).to(device)
        out["positions"] = torch.as_tensor(pos).to(device)
    if cfg.family == "audio":
        out["enc_embeds"] = _embeds(cfg, rng, batch, seq, device)
    return out


def _embeds(cfg: ModelConfig, rng, batch: int, seq: int, device
            ) -> torch.Tensor:
    """(batch, seq, d_model) of 0.02 * normal: float64 draws rounded once
    to the compute dtype (as numpy's astype), then moved."""
    return torch.from_numpy(0.02 * rng.standard_normal(
        (batch, seq, cfg.d_model))).to(dtype_of(cfg.compute_dtype)).to(
            device)
