"""Synthetic LM batches (PyTorch port of ``repro.data.batches``).

Schema (train/prefill): tokens (B, S) int32, labels (B, S) int32; the
audio (enc-dec) family adds enc_embeds (B, S, d_model) in the compute
dtype. The numpy generator is the reference's, drawn in the same order,
so a seed gives the same arrays bit for bit in both packages. The vlm
extras come with their family (ROADMAP A).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dtype_of


def synth_train_batch(cfg: ModelConfig, batch: int, seq: int,
                      seed: int = 0, device="cpu") -> Dict:
    if cfg.family == "vlm":
        raise NotImplementedError(
            "vlm batches are not ported yet (ROADMAP A.2: the VLM)")
    rng = np.random.default_rng(seed)
    out = {
        "tokens": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(
            np.int32),
        "labels": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(
            np.int32),
    }
    out = {k: torch.as_tensor(v).to(device) for k, v in out.items()}
    if cfg.family == "audio":
        # float64 draws rounded once to the compute dtype (as numpy's
        # astype), then moved
        out["enc_embeds"] = torch.from_numpy(0.02 * rng.standard_normal(
            (batch, seq, cfg.d_model))).to(dtype_of(cfg.compute_dtype)).to(
                device)
    return out
