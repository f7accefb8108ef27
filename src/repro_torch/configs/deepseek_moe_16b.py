"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (kv=16) d_ff=1408
vocab=102400, MoE: 2 shared + 64 routed top-6, fine-grained experts.
[arXiv:2401.06066; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b", family="moe",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab_size=102400,
        mlp_type="swiglu", norm_type="rmsnorm",
        moe=MoEConfig(n_routed=64, n_shared=2, top_k=6, d_ff_expert=1408),
    )


def smoke() -> ModelConfig:
    return config().replace(
        name="deepseek-moe-16b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=96, vocab_size=512, vocab_pad_to=64,
        moe=MoEConfig(n_routed=8, n_shared=1, top_k=2, d_ff_expert=96, capacity_factor=2.0),
        compute_dtype="float32", remat=False,
    )
