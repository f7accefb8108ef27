"""phi-3-vision-4.2b [vlm] — 32L d_model=3072 32H (kv=32) d_ff=8192
vocab=32064 — phi3-mini backbone + CLIP STUB (input_specs feeds patch
embeddings merged into the token stream).
[hf:microsoft/Phi-3-vision-128k-instruct; hf]

long_500k skipped (full attention)."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b", family="vlm",
        n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab_size=32064,
        mlp_type="swiglu", norm_type="rmsnorm",
        frontend="vision", n_frontend_tokens=576,
    )


def smoke() -> ModelConfig:
    return config().replace(
        name="phi-3-vision-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=512, vocab_pad_to=64, n_frontend_tokens=8,
        compute_dtype="float32", remat=False,
    )
