"""Model FLOPs of one training step of a DeepSeek-V2 configuration as one chip
runs it (``configs/deepseek-v2-lite-ep8.json``: the published keys and
``expert_parallel``).

As ``counts.granite``: a matrix product costs 2 FLOPs a multiply-add
forward and twice that backward, 6 N D for N matrix parameters over D
tokens, recomputation not counted.  What a token's step multiplies:

* each layer's MLA as the paper writes it, unabsorbed: the query
  projection, the latent's down-projection (512 + 64), the key and value
  up-projections from the latent, the output projection, and the attention
  products over the full (s, s) square, as the port computes it (the causal
  mask applied, not skipped): 2 s^2 h (dn + dr) for the scores and
  2 s^2 h dv for the weighted values a sequence forward, three times that
  with the backward;
* the router's product (hidden x every routed expert);
* the held experts at the share of the choices they expect,
  ``k * n_held / n_routed`` a token, three matrices of hidden x expert
  width each; the shared experts' three matrices of hidden x
  ``n_shared * expert width`` for every token;
* the leading dense layers' SwiGLU of ``intermediate_size``;
* the head over the vocabulary slice (the embedding is a lookup).

So the count reads the same work whatever implements it: the port's
absorbed attention, its capacity drops or its dispatch products change
none of it.
"""


def _dims(cfg: dict) -> dict:
    ep = cfg["expert_parallel"]
    return {"d": cfg["hidden_size"], "h": cfg["num_attention_heads"],
            "dn": cfg["qk_nope_head_dim"], "dr": cfg["qk_rope_head_dim"],
            "dv": cfg["v_head_dim"], "r": cfg["kv_lora_rank"],
            "n_dense": cfg["first_k_dense_replace"],
            "n_moe": cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]}, ep


def mla_params(cfg: dict) -> int:
    """One layer's MLA matrix parameters: wq, w_dkv, w_uk, w_uv, wo."""
    z, _ = _dims(cfg)
    d, h, r = z["d"], z["h"], z["r"]
    return (d * h * (z["dn"] + z["dr"]) + d * (r + z["dr"]) + r * h * z["dn"]
            + r * h * z["dv"] + h * z["dv"] * d)


def token_params(cfg: dict) -> float:
    """Matrix parameters a token's step multiplies (the expected expert share
    included); a float, since a token takes ``k * n_held / n_routed``
    experts."""
    z, ep = _dims(cfg)
    d = z["d"]
    routed, held, k = ep["routed_experts"], cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    f = cfg["moe_intermediate_size"]
    moe = d * routed + k * held / routed * 3 * d * f + 3 * d * cfg["n_shared_experts"] * f
    dense = 3 * d * cfg["intermediate_size"]
    head = 0 if cfg["tie_word_embeddings"] else d * cfg["vocab_size"]
    return (z["n_dense"] * (mla_params(cfg) + dense) + z["n_moe"] * (mla_params(cfg) + moe)
            + head)


def step_flops(cfg: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one step on ``batch`` sequences of ``seq`` tokens."""
    z, _ = _dims(cfg)
    layers = z["n_dense"] + z["n_moe"]
    matrices = 6.0 * token_params(cfg) * batch * seq
    attn = 6.0 * layers * batch * seq * seq * z["h"] * (z["dn"] + z["dr"] + z["dv"])
    return matrices + attn
