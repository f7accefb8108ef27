"""Model FLOPs of one training step of the port's dense decoder.

A step is a forward and a backward pass.  Matrix products cost 2 FLOPs a
multiply-add forward and twice that backward, so 6 N D for the matrix
parameters N over D tokens (the embedding is a lookup, not a product; the
untied head is a product).  Attention adds its two products, Q K^T and P V,
over the full (s, s) square the port computes (the causal mask is applied,
not skipped): 4 s^2 h d_head forward a sequence and layer, 12 s^2 h d_head
with the backward.  Recomputation under activation checkpointing is not
counted: these are the model's FLOPs, not the card's.
"""


def matrix_params(cfg: dict) -> int:
    """Parameters of the step's matrix products: per layer Q, K, V, O and
    the MLP's matrices (three for SwiGLU, two otherwise), and the head."""
    d, f = cfg["d_model"], cfg["d_ff"]
    dh = cfg.get("d_head") or d // cfg["n_heads"]
    q = d * cfg["n_heads"] * dh
    kv = 2 * d * cfg["n_kv_heads"] * dh
    mlp = (3 if cfg["mlp_type"] == "swiglu" else 2) * d * f
    head = 0 if cfg.get("tie_embeddings") else d * cfg["vocab_size"]
    return cfg["n_layers"] * (2 * q + kv + mlp) + head


def step_flops(cfg: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one step on ``batch`` sequences of ``seq`` tokens."""
    dh = cfg.get("d_head") or cfg["d_model"] // cfg["n_heads"]
    dense = 6.0 * matrix_params(cfg) * batch * seq
    attn = 12.0 * cfg["n_layers"] * batch * seq * seq * cfg["n_heads"] * dh
    return dense + attn
