"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000,
ssm_state=64; Mamba2 trunk + shared attention block. [arXiv:2411.15242; hf]

The single shared attention block (weights reused) runs after every 6th
Mamba2 layer; each invocation keeps its own KV cache slot. The same
numbers as the reference's ``repro/configs/zamba2_1p2b.py``.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b",
        family="hybrid",
        n_layers=38,           # mamba2 layers
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,             # shared attention block's MLP
        vocab_size=32000,
        ssm_state=64,
        ssm_expand=2,
        ssm_head_dim=64,
        shared_attn_every=6,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return config().with_(
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        ssm_state=16, ssm_head_dim=16, ssm_chunk=16, shared_attn_every=2,
        vocab_size=256, param_dtype="float32", compute_dtype="float32",
        remat=False)
