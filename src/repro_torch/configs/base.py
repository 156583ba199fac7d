"""Model configuration for the LM half (PyTorch port).

The port's own copies of the reference's ``ModelConfig`` and
``TrainConfig``, with the same names, defaults and meaning, so one config
reads the same in both packages: every family of the reference (dense,
MoE with MLA, the VLM's M-RoPE, ssm, hybrid, enc-dec).
``attn_batch_fallback`` is the reference's too: where "model" does not
divide the query heads, a config that sets it splits each "data" rank's
rows of the attention again over "model" (`models.attention`), else the
attention runs whole on every rank. ``TrainConfig``'s
``zero1`` splits the Adam moments over the "data" axis in the
data-parallel step (`train.steps.make_train_step` with a mesh);
``grad_compression`` is read by nothing, as by the reference's train step
(`optim.compress` is there for a caller that wants it).
``ParallelConfig`` is the reference's; `launch.mesh.make_mesh` refuses
what this port does not run yet (a pipeline "pod" axis); ``fsdp`` splits
the parameters over "data" (`train.steps`); ``seq_shard_decode`` splits
the decode KV cache along its sequence over ``seq_axes``
(`launch.cells`). ``ShapeConfig`` and ``SHAPES`` are the reference's four
input-shape cells.
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
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE (t, h, w) splits
    sliding_window: int = 0                # >0 enables windowed layers
    local_global_pattern: int = 0          # N => N local layers : 1 global
    rope_local_theta: float = 0.0          # gemma3: local layers' rope base
    attn_logit_softcap: float = 0.0

    # MLA (deepseek-v2) -----------------------------------------------------
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # MoE -------------------------------------------------------------------
    n_experts: int = 0
    n_experts_per_tok: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_variant: Variant = Variant.CNN     # paper taxonomy: dispatch impl
    router_z_loss: float = 1e-3
    # Pad the expert dimension with never-routed dead experts (granite-moe:
    # 40 -> 48), as the reference's (there: to divide the model axis).
    n_experts_padded: int = 0

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
    remat: bool = True
    # "nothing": recompute everything (min memory, +33% flops)
    # "dots":    save the outputs of the matmuls without batch dims
    #            (elementwise recomputed), at more live-activation memory
    remat_policy: str = "nothing"
    use_flash_kernel: bool = False         # CUDA flash attention (opt-in)
    use_ssd_kernel: bool = False           # CUDA SSD scan (opt-in)
    kv_variant: Variant = Variant.DYNAMIC  # KV-cache update (paper V1/V2)
    attn_chunk: int = 512                  # q-block for chunked attention
    # Where the query heads do not divide "model": fold "model" into the
    # batch for the attention (its rows split over "data" x "model")
    # rather than run it whole on every rank. Wins where attention's
    # FLOPs outweigh the per-layer gathers (granite-moe), loses for thin
    # attention (gemma3, qwen2-vl), as the reference measured; per
    # config, as the reference's.
    attn_batch_fallback: bool = False

    # ---------------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def n_experts_eff(self) -> int:
        """Expert-dim size incl. dead padding (weights / dispatch slots)."""
        return max(self.n_experts_padded, self.n_experts)

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic (or bounded-KV) archs that run the long_500k cell."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.local_global_pattern > 0 and self.sliding_window > 0

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned (arch x shape) cell."""

    name: str                 # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                 # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    microbatches: int = 1        # gradient accumulation
    zero1: bool = True           # shard optimizer state over data axis
    grad_compression: bool = False  # int8 all-reduce of the gradients
    checkpoint_every: int = 100
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    fsdp: bool = False           # shard params over data axis too (ZeRO-3)
    pod_axis_role: str = "data"  # data | pipeline
    seq_shard_decode: bool = False    # shard decode KV along sequence
    seq_axes: Tuple[str, ...] = ("model",)  # physical axes for "seq"
