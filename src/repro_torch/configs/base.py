"""Model configuration for the LM half (PyTorch port).

The port's own copy of the reference's ``ModelConfig``, cut to the fields
the hybrid (zamba2) family reads, with the same names, defaults and
meaning, so one config reads the same in both packages. Families whose
fields are not here (MoE, MLA, M-RoPE frontends, enc-dec) are not ported
yet: ROADMAP A lists them.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.core.config import Variant


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity -----------------------------------------------------------
    name: str = "model"
    family: str = "dense"     # dense | moe | ssm | hybrid | vlm | audio

    # trunk ---------------------------------------------------------------
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 512
    vocab_size: int = 1024
    tie_embeddings: bool = False

    # attention -----------------------------------------------------------
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE (not ported)
    attn_logit_softcap: float = 0.0

    # SSM (mamba2) ------------------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128

    # hybrid (zamba2) ----------------------------------------------------
    shared_attn_every: int = 0             # shared attn after every N layers

    # numerics / execution -----------------------------------------------
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    use_flash_kernel: bool = False         # CUDA flash attention (opt-in)
    use_ssd_kernel: bool = False           # CUDA SSD scan (opt-in)
    kv_variant: Variant = Variant.DYNAMIC  # KV-cache update (paper V1/V2)
    attn_chunk: int = 512                  # q-block for chunked attention

    # ---------------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
