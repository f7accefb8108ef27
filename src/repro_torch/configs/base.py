"""Model / run configuration dataclasses.

The port's own copy of ``repro.configs.base``: data only, the same fields,
defaults and values, so a config built here equals the reference's field by
field.  One ``ModelConfig`` describes any architecture in the assigned pool;
family-specific blocks live in optional sub-configs.  Exact production
configs are in ``repro_torch/configs/<arch>.py``; every arch also exposes
``smoke()`` — a reduced same-family config for CPU tests.  The port's own
options (``MoEPortConfig``, ``MLAPortConfig``) are subclasses that a config
uses in place of the reference's sub-configs.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class MoEConfig:
    n_routed: int = 64
    n_shared: int = 2
    top_k: int = 6
    d_ff_expert: int = 1408      # fine-grained expert width
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    # GShard dispatch group size: the one-hot dispatch tensor is
    # O(group_size * capacity) = O(group_size^2 * k / E) per group, so groups
    # are kept small and fixed regardless of global batch.
    group_size: int = 1024


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


# The port's own options, beyond the reference's fields: subclasses, so that a
# config without them equals the reference's field by field.  Every option
# defaults off; a default instance computes what its base class computes.


@dataclass(frozen=True)
class MoEPortConfig(MoEConfig):
    """``MoEConfig`` with DeepSeek-V2's options and an expert share.

    * ``n_held`` experts, from index ``held_start``, live in this layer (0:
      all ``n_routed``): the router keeps its ``n_routed`` outputs and top-k,
      and the layer computes only its held experts' part for the choices that
      land on them (one device's share of an expert-parallel group; what the
      absent experts would add is left out);
    * ``norm_topk``: renormalise the top-k gates to sum to one;
    * ``first_dense``: the first layers of the decoder are dense MLPs of
      ``ModelConfig.d_ff`` (DeepSeek's ``first_k_dense_replace``);
    * ``seq_aux_alpha``: the sequence-wise balance loss's weight (0: off),
      added to the train loss once for each MoE layer.
    """

    n_held: int = 0
    held_start: int = 0
    norm_topk: bool = True
    first_dense: int = 0
    seq_aux_alpha: float = 0.0


@dataclass(frozen=True)
class YarnConfig:
    """DeepSeek-V2's YaRN rope scaling (the config's ``rope_scaling``)."""

    factor: float = 40.0
    original_max_position: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 0.707
    mscale_all_dim: float = 0.707


@dataclass(frozen=True)
class MLAPortConfig(MLAConfig):
    """``MLAConfig`` with YaRN on the rope dimensions (``yarn`` None: plain
    RoPE)."""

    yarn: YarnConfig | None = None


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    expand: int = 2
    head_dim: int = 64
    conv_width: int = 4
    chunk: int = 128


@dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64
    chunk: int = 128


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | audio | hybrid | vlm | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int | None = None    # default d_model // n_heads
    mlp_type: str = "swiglu"     # swiglu | relu2 | gelu
    qkv_bias: bool = False
    norm_type: str = "rmsnorm"   # rmsnorm | layernorm
    rope_theta: float = 10_000.0
    use_rope: bool = True        # whisper uses sinusoidal/absolute positions
    tie_embeddings: bool = False
    vocab_pad_to: int = 256      # TP divisibility padding
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    rwkv: RWKVConfig | None = None
    attn_every: int = 0          # hybrid: shared attention block period
    encdec: bool = False
    dec_ratio: int = 4           # enc-dec: decoder length = seq // dec_ratio
    frontend: str | None = None  # audio | vision (STUB per assignment)
    n_frontend_tokens: int = 0   # vlm: patch tokens prepended to the stream
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True           # activation checkpointing across layers
    remat_policy: str = "full"   # full | dots (save matmul outputs)
    scan_layers: bool = True
    attn_block_k: int = 0        # >0: blockwise (flash) attention KV block
    kv_cache_dtype: str | None = None  # "int8": quantized decode cache (+scales)
    mla_q_chunk: int = 0         # >0: query-chunked MLA prefill/train
    moe_shard_constraints: bool = False  # explicit EP sharding annotations
    fsdp_gather_params: bool = False     # ZeRO-3 weight all-gather at use

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return ((self.vocab_size + p - 1) // p) * p

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str                    # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 3e-4
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_clip: float = 1.0
    # paper-technique features
    spectral_rank: int = 0       # >0: streaming-SVD low-rank moment projection
    compress_rank: int = 0       # >0: low-rank DP gradient compression
    basis_refresh_every: int = 0 # >0: agree/re-factorize spectral bases every N steps


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    seed: int = 0
    steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep_checkpoints: int = 3
