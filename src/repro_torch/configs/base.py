"""Model configuration for the LM half (PyTorch port).

The port's own copy of the reference's ``ModelConfig``, cut to the fields
the ported families read (dense transformer, ssm, hybrid, enc-dec), with
the same names, defaults and meaning, so one config reads the same in
both packages. The MoE and MLA fields are not here: those families are
not ported yet (ROADMAP A).
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
    d_head: int = 0           # 0 => d_model // n_heads
    d_ff: int = 512
    vocab_size: int = 1024
    tie_embeddings: bool = False

    # attention -----------------------------------------------------------
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE (not ported)
    sliding_window: int = 0                # >0 enables windowed layers
    local_global_pattern: int = 0          # N => N local layers : 1 global
    rope_local_theta: float = 0.0          # gemma3: local layers' rope base
    attn_logit_softcap: float = 0.0

    # SSM (mamba2) ------------------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128

    # hybrid (zamba2) ----------------------------------------------------
    shared_attn_every: int = 0             # shared attn after every N layers

    # enc-dec (seamless) --------------------------------------------------
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0

    # modality frontend stubs ---------------------------------------------
    frontend: str = "none"                 # none | vision | audio

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
        return self.d_head or (self.d_model // self.n_heads)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
