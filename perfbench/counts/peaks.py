"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet: dense rates,
no sparsity, at the card's full 700 W power limit).  A card set below 700 W
(``nvidia-smi``'s ``power.limit``) runs slower under load, so every share of
these peaks is printed beside the card's limit."""

BF16_FLOPS = 989e12      # bf16 / fp16 on the tensor cores
F32_FLOPS = 67e12        # float32 outside the tensor cores (TF32 off)
F64_FLOPS = 67e12        # float64 on the DMMA tensor cores
HBM_BYTES_PER_S = 3.35e12
POWER_LIMIT_W = 700.0    # the limit the peaks assume
