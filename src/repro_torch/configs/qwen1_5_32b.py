"""qwen1.5-32b [dense] — 64L d_model=5120 40H (GQA kv=40) d_ff=27392
vocab=152064, QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]

40 heads % 16 mesh shards != 0: attention activations rely on GSPMD implicit
padding on the head axis (documented waste, DESIGN.md §6).
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b", family="dense",
        n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40,
        d_ff=27392, vocab_size=152064, qkv_bias=True,
        mlp_type="swiglu", norm_type="rmsnorm",
    )


def smoke() -> ModelConfig:
    return config().replace(
        name="qwen1.5-32b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=512, vocab_pad_to=64,
        compute_dtype="float32", remat=False,
    )
