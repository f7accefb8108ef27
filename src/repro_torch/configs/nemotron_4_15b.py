"""nemotron-4-15b [dense] — 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000 — GQA, squared-ReLU MLP. [arXiv:2402.16819; unverified]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b", family="dense",
        n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=24576, vocab_size=256000,
        mlp_type="relu2", norm_type="layernorm",
    )


def smoke() -> ModelConfig:
    return config().replace(
        name="nemotron-4-15b-smoke", n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
        d_ff=192, vocab_size=512, vocab_pad_to=64,
        compute_dtype="float32", remat=False,
    )
