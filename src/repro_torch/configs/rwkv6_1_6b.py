"""rwkv6-1.6b [ssm] — 24L d_model=2048 (attention-free) d_ff=7168
vocab=65536 — "Finch": data-dependent decay linear attention.
[arXiv:2404.05892; unverified]

Runs long_500k (O(1) recurrent state)."""
from repro_torch.configs.base import ModelConfig, RWKVConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b", family="ssm",
        n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,  # heads = d/64
        d_ff=7168, vocab_size=65536,
        mlp_type="swiglu", norm_type="layernorm",
        rwkv=RWKVConfig(head_dim=64, decay_lora=64, chunk=64),
    )


def smoke() -> ModelConfig:
    return config().replace(
        name="rwkv6-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=512, vocab_pad_to=64,
        rwkv=RWKVConfig(head_dim=16, decay_lora=8, chunk=8),
        compute_dtype="float32", remat=False,
    )
