"""whisper-base [audio] — 6L d_model=512 8H (kv=8) d_ff=2048 vocab=51865 —
enc-dec, conv frontend STUB per assignment (input_specs feeds frame
embeddings). [arXiv:2212.04356; unverified]

vocab 51865 padded to 51968 for TP divisibility; 8 heads < 16 shards relies
on GSPMD padding (tiny model; waste documented in DESIGN.md §6).
long_500k skipped (enc-dec audio, out of family scope)."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base", family="audio",
        n_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
        d_ff=2048, vocab_size=51865,
        mlp_type="gelu", norm_type="layernorm", use_rope=False,
        encdec=True, dec_ratio=4, frontend="audio",
    )


def smoke() -> ModelConfig:
    return config().replace(
        name="whisper-base-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=512, vocab_pad_to=64,
        compute_dtype="float32", remat=False,
    )
