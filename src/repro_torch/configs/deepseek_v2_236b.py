"""deepseek-v2-236b [moe]: 60L d_model=5120 128H d_ff=1536 vocab=102400,
MLA kv_lora=512, 2 shared + 160 routed experts top-6. [arXiv:2405.04434; hf]

MLA: low-rank compressed KV (c_kv rank 512 + a decoupled 64-dim rope
key); decode runs with absorbed weights in the compressed space, so the
cache stays (S, 512 + 64) per layer whatever the 128 heads. The same
numbers as the reference's ``repro/configs/deepseek_v2_236b.py``.
At full depth the bf16 weights take about 475 GB, so
one card runs it at full width with fewer layers.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,      # MHA semantics; MLA compresses the cache
        d_ff=1536,
        vocab_size=102400,
        use_mla=True,
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        n_experts=160,
        n_experts_per_tok=6,
        n_shared_experts=2,
        moe_d_ff=1536,
    )


def smoke() -> ModelConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=4, q_lora_rank=32, kv_lora_rank=16,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        d_ff=64, moe_d_ff=64, n_experts=8, n_experts_per_tok=2,
        n_shared_experts=1, vocab_size=256,
        param_dtype="float32", compute_dtype="float32",
        remat=False)
