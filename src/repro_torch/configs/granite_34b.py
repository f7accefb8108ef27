"""granite-34b [dense] — 88L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152 — llama-arch, code model. [arXiv:2405.04324; hf]

kv=1 < 16 model shards: the single KV head is replicated over the model axis
(standard MQA TP semantics)."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-34b", family="dense",
        n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
        d_ff=24576, vocab_size=49152,
        mlp_type="swiglu", norm_type="rmsnorm",
    )


def smoke() -> ModelConfig:
    return config().replace(
        name="granite-34b-smoke", n_layers=3, d_model=64, n_heads=4, n_kv_heads=1,
        d_ff=128, vocab_size=512, vocab_pad_to=64,
        compute_dtype="float32", remat=False,
    )
