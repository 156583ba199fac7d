"""qwen2-vl-2b [vlm]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936; M-RoPE, dynamic resolution. [arXiv:2409.12191; hf]

The vision frontend is a stub, as in the reference: a batch carries
precomputed patch embeddings, an embed mask and (B, 3, S) M-RoPE
position triplets (temporal / height / width). The same numbers as the
reference's ``repro/configs/qwen2_vl_2b.py``.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b",
        family="vlm",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        d_head=128,
        d_ff=8960,
        vocab_size=151936,
        mrope_sections=(16, 24, 24),   # t/h/w splits of d_head/2 = 64
        rope_theta=1e6,
        frontend="vision",
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=256, mrope_sections=(2, 3, 3),
        param_dtype="float32", compute_dtype="float32",
        remat=False)
