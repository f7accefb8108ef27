"""qwen2-72b [dense] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — GQA, QKV bias. [arXiv:2407.10671; hf]

Largest assigned model: 2-D weight sharding (FSDP x TP) is required for the
f32 params + Adam moments to fit 16 GB/chip (DESIGN.md §5)."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b", family="dense",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=29568, vocab_size=152064, qkv_bias=True,
        mlp_type="swiglu", norm_type="rmsnorm",
    )


def smoke() -> ModelConfig:
    return config().replace(
        name="qwen2-72b-smoke", n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
        d_ff=256, vocab_size=512, vocab_pad_to=64,
        compute_dtype="float32", remat=False,
    )
