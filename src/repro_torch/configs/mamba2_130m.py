"""mamba2-130m [ssm]: 24L d_model=768, attention-free, vocab=50280,
ssm_state=128, SSD (state-space duality). [arXiv:2405.21060]

The same numbers as the reference's ``repro/configs/mamba2_130m.py``.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m",
        family="ssm",
        n_layers=24,
        d_model=768,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_chunk=64,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return config().with_(
        n_layers=2, d_model=64, ssm_state=16, ssm_head_dim=16, ssm_chunk=16,
        vocab_size=256, param_dtype="float32", compute_dtype="float32",
        remat=False)
