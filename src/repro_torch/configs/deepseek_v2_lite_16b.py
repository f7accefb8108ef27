"""deepseek-v2-lite-16b [moe+mla] — 27L d_model=2048 16H d_ff=1408
vocab=102400, MLA kv_lora=512, MoE 2 shared + 64 routed top-6.
[arXiv:2405.04434; hf]

The assignment line says "64e top-6"; the arXiv model card lists 160 routed
experts. We implement the inline numbers (64) — the field is a knob.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b", family="moe",
        n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab_size=102400,
        mlp_type="swiglu", norm_type="rmsnorm",
        moe=MoEConfig(n_routed=64, n_shared=2, top_k=6, d_ff_expert=1408),
        mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                      qk_rope_head_dim=64, v_head_dim=128),
    )


def smoke() -> ModelConfig:
    return config().replace(
        name="deepseek-v2-lite-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=96, vocab_size=512, vocab_pad_to=64,
        moe=MoEConfig(n_routed=8, n_shared=1, top_k=2, d_ff_expert=96, capacity_factor=2.0),
        mla=MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
        compute_dtype="float32", remat=False,
    )
