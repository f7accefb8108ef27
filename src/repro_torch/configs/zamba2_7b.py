"""zamba2-7b [hybrid] — 81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000,
ssm_state=64 — Mamba2 backbone + weight-shared attention every 6 layers.
[arXiv:2411.15242; unverified]

Simplifications (DESIGN.md §6): shared block applied on the residual stream
(no embedding concat, no per-invocation LoRA). Runs long_500k (hybrid: O(1)
SSM state + O(seq) shared-attn KV reads per decode step)."""
from repro_torch.configs.base import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b", family="hybrid",
        n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
        d_ff=14336, vocab_size=32000,
        mlp_type="swiglu", norm_type="rmsnorm",
        ssm=SSMConfig(d_state=64, expand=2, head_dim=64, conv_width=4, chunk=128),
        attn_every=6,
    )


def smoke() -> ModelConfig:
    return config().replace(
        name="zamba2-7b-smoke", n_layers=5, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=512, vocab_pad_to=64,
        ssm=SSMConfig(d_state=16, expand=2, head_dim=16, conv_width=4, chunk=16),
        attn_every=2,
        compute_dtype="float32", remat=False,
    )
