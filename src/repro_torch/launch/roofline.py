"""Roofline terms and the analytic FLOP counts, in PyTorch.

Counterpart of ``repro.launch.roofline``.  Three terms per (arch, shape,
mesh), in seconds, from per-device counts:

  compute    = FLOPs / peak_flops          [dense bf16 tensor cores]
  memory     = bytes / hbm_bw              [HBM3]
  collective = collective_bytes / link_bw  [NVLink, or the network past 8 cards]

``HW`` holds the peaks of one NVIDIA H100 SXM5 80GB, from NVIDIA's H100
Tensor Core GPU data sheet (not measured here):

* ``PEAK_FLOPS`` = 989e12: dense BF16 tensor-core FLOP/s (1979 with 2:4
  sparsity, which no product here uses);
* ``HBM_BW`` = 3.35e12: HBM3 bytes/s;
* ``NVLINK_BW`` = 450e9: fourth-generation NVLink, 900 GB/s a card both ways,
  450 GB/s a direction, all to all through NVSwitch within one HGX board of
  at most 8 cards;
* ``NET_BW`` = 50e9: a ConnectX-7 NDR InfiniBand port, 400 Gb/s a card, the
  link of a collective over more than 8 cards.

The counts are the port's own: ``launch.dryrun`` takes FLOPs and bytes from
a pass on the meta device, and ``collective_bytes`` reckons wire bytes from
the sharding rules (``dist.sharding``), since the port has no compiled HLO
to parse.  Its ring factors are the reference's, per device for a group of
g devices:

  all-gather:      out_bytes * (g-1)/g
  reduce-scatter:  in_bytes  * (g-1)/g
  all-reduce:      2 * bytes * (g-1)/g

``model_flops``, ``svd_update_flops``, ``sketch_flops``,
``sparse_lowering_flops`` and ``_active_param_count`` are the reference's
arithmetic, unchanged: the useful work a roofline's FLOPs are held against.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.dist.sharding import AXIS_SIZES, spec_divisor

__all__ = ["HBM_BW", "HW", "NET_BW", "NVLINK_BW", "NVLINK_GROUP", "PEAK_FLOPS",
           "collective_bytes", "model_flops", "roofline_terms", "sketch_flops",
           "sparse_lowering_flops", "svd_update_flops"]

# NVIDIA H100 SXM5 80GB, one card (data sheet; see the module docstring)
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9
NVLINK_GROUP = 8
NET_BW = 50e9


@dataclass
class HW:
    """Peaks of ``chips`` H100 cards; ``link_bw`` defaults to NVLink within
    a group of at most ``NVLINK_GROUP`` cards and to the network above."""

    chips: int
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    link_bw: float | None = None

    def __post_init__(self):
        if self.link_bw is None:
            self.link_bw = NVLINK_BW if self.chips <= NVLINK_GROUP else NET_BW


def roofline_terms(cost: dict, coll: dict, hw: HW) -> dict:
    """The three terms of per-device ``cost`` (``flops``, ``bytes accessed``)
    and collective bytes ``coll`` on ``hw``."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    cbytes = sum(v for k, v in coll.items() if k != "count")
    return {
        "flops_per_device": flops,
        "bytes_per_device": byts,
        "collective_bytes_per_device": cbytes,
        "t_compute_s": flops / hw.peak_flops,
        "t_memory_s": byts / hw.hbm_bw,
        "t_collective_s": cbytes / hw.link_bw,
    }


def _leaves_with_keys(tree, keys=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_keys(v, keys + (k,))
    else:
        yield keys, tree


def _at(specs, keys):
    for k in keys:
        specs = specs[k]
    return specs


def _itemsize(dtype) -> int:
    import torch

    return torch.empty((), dtype=dtype, device="meta").element_size()


def collective_bytes(params, specs, *, tokens: int, train: bool, gather: bool,
                     compute_dtype="bfloat16", multi_pod: bool = False, moe=None,
                     sizes: dict | None = None) -> dict:
    """Per-device wire bytes by collective kind, reckoned from the parameter
    specs: a model of what the sharding rules imply for one step, not what a
    partitioner emits.  ``params`` is a tree of dicts whose leaves have a
    ``shape`` and a ``dtype`` (meta tensors), ``specs`` its
    ``param_pspecs``; ``tokens`` the step's global token count (one a
    sequence at decode); the axis sizes are the production ones (``sizes``,
    default ``AXIS_SIZES``; the batch lies over ``data``, and ``pod`` too when
    ``multi_pod``).  Three kinds of traffic are counted:

    * ``gather`` (``cfg.fsdp_gather_params``): every sharded leaf all-gathered
      whole in the compute dtype once a step (``gather_for_compute``
      replicates every leaf), g = the pieces its spec cuts it into;
    * ``train``: each gradient reduced over the data-parallel group in the
      leaf's dtype: a reduce-scatter over ``data`` where the spec shards the
      leaf over ``data`` (then an all-reduce of the piece over ``pod``), an
      all-reduce over the whole group otherwise;
    * every application of a leaf of two axes or more that the spec splits
      over ``model`` (a product ``x @ w`` with ``w`` of shape (..., k, n), one
      application per entry of the leading axes): one all-reduce over
      ``model`` of its float32 output, (tokens on this device) x n / (the
      pieces of n), twice in a train step (forward and backward).  An MoE
      expert stack (``wg`` / ``wu`` / ``wd`` under ``moe``, not its shared
      expert; ``moe`` the config's ``MoEConfig``) sees ``capacity_factor *
      top_k / n_routed`` of the tokens an expert.

    ``all-to-all`` and ``collective-permute`` stay 0: the rules place no
    operand that needs them.  ``count`` is the number of collectives."""
    from repro_torch.models.layers import as_dtype

    sizes = AXIS_SIZES if sizes is None else sizes
    out = {"all-gather": 0.0, "all-reduce": 0.0, "reduce-scatter": 0.0,
           "all-to-all": 0.0, "collective-permute": 0.0, "count": 0}
    cd_bytes = _itemsize(as_dtype(compute_dtype))
    data, pod, model = sizes["data"], (sizes["pod"] if multi_pod else 1), sizes["model"]
    dp = data * pod
    tok_dev = tokens / dp

    def ring(g):
        return (g - 1) / g

    for keys, leaf in _leaves_with_keys(params):
        spec = tuple(_at(specs, keys))
        shape = tuple(leaf.shape)
        numel = math.prod(shape)
        cut = math.prod(spec_divisor(ax, sizes) for ax in spec)
        flat = [a for ax in spec if ax is not None
                for a in (ax if isinstance(ax, tuple) else (ax,))]
        if gather and cut > 1:
            out["all-gather"] += numel * cd_bytes * ring(cut)
            out["count"] += 1
        if train and dp > 1:
            nbytes = numel * _itemsize(leaf.dtype)
            if "data" in flat:
                out["reduce-scatter"] += nbytes / (cut // data) * ring(data)
                out["count"] += 1
                if pod > 1:
                    out["all-reduce"] += 2.0 * nbytes / cut * ring(pod)
                    out["count"] += 1
            else:
                out["all-reduce"] += 2.0 * nbytes / cut * ring(dp)
                out["count"] += 1
        if len(shape) >= 2 and "model" in flat and model > 1:
            apps = math.prod(shape[:-2])
            n_cut = spec_divisor(spec[len(shape) - 1], sizes) if len(spec) == len(shape) else 1
            share = 1.0
            if (moe is not None and "moe" in keys and "shared" not in keys
                    and keys[-1] in ("wg", "wu", "wd")):
                share = moe.capacity_factor * moe.top_k / moe.n_routed
            passes = 2 if train else 1
            out["all-reduce"] += (passes * apps * 2.0 * tok_dev * share * shape[-1] / n_cut
                                  * 4 * ring(model))
            out["count"] += passes * apps
    return out


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE), D = tokens processed.

    For decode shapes D = global_batch (one token each); train counts fwd+bwd
    (factor 6); prefill/decode count forward only (factor 2).
    """
    n_params_active = _active_param_count(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        factor = 6.0
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        factor = 2.0
    else:
        tokens = shape.global_batch * 1
        factor = 2.0
    return factor * n_params_active * tokens


def svd_update_flops(m: int, n: int, r: int, batch: int = 1) -> float:
    """Analytic MODEL_FLOPS of one batched truncated rank-1 SVD update:
    Brand projections and deflections ``~4r(m+n)``, the (r+1)-sized
    Algorithm-6.1 core (four chained eigen-updates and the sign fix,
    ``~24(r+1)^3`` under the direct method), and the two basis rotations
    ``~2r(r+1)(m+n)``.  The useful work of ``launch.perf_iter --svd``."""
    per = 4.0 * r * (m + n) + 2.0 * r * (r + 1) * (m + n) + 24.0 * (r + 1) ** 3
    return batch * per


def sketch_flops(m: int, n: int, k: int, *, oversample: int = 8,
                 power_iters: int = 1, batch: int = 1) -> float:
    """Analytic MODEL_FLOPS of one randomized range-finder sketch
    (``updates.sketch.sketch_svd``) at l = min(k + oversample, m, n) samples:
    the (1 + 2·power_iters + 1) dense l-wide passes over the delta, the tall
    QRs ``~2(m + n)l²`` per orthonormalization, and the (2l)³-scale
    Jordan-Wielandt core."""
    l = max(1, min(k + oversample, m, n))  # noqa: E741
    passes = 2.0 * (2.0 + 2.0 * power_iters) * m * n * l
    qr = 2.0 * (1.0 + 2.0 * power_iters) * (m + n) * l * l
    core = 24.0 * (2 * l) ** 3
    return batch * (passes + qr + core)


def sparse_lowering_flops(m: int, n: int, k: int, nnz: int, *,
                          oversample: int = 8, batch: int = 1) -> float:
    """Analytic MODEL_FLOPS of lowering one ``Sparse`` COO delta to its k
    pairs (``updates.sketch.sparse_sketch_svd``, the two-sided single-pass
    sketch): two ``kernels.sparse_proj`` applications (``2·nnz·l`` each), two
    tall QRs, the core products with their two l×l solves, and the
    Jordan-Wielandt core: O((m + n)·l² + nnz·l), never the densified m·n."""
    l = max(1, min(k + oversample, m, n))  # noqa: E741
    passes = 2.0 * 2.0 * nnz * l
    qr = 2.0 * 2.0 * (m + n) * l * l
    core_gemms = 2.0 * (2.0 * m + n) * l * l
    solves = 2.0 * (2.0 / 3.0) * l ** 3
    core = 24.0 * (2 * l) ** 3
    return batch * (passes + qr + core_gemms + solves + core)


def _active_param_count(cfg) -> float:
    """Analytic per-token-active parameter count (excl. embeddings)."""
    d = cfg.d_model
    L = cfg.n_layers
    if cfg.rwkv is not None:
        per_layer = 5 * d * d + 2 * d * cfg.d_ff + 2 * d * cfg.rwkv.decay_lora
        return L * per_layer
    if cfg.ssm is not None and cfg.attn_every:
        d_inner = cfg.ssm.expand * d
        per_mamba = (d * (2 * d_inner + 2 * cfg.ssm.d_state + d_inner // cfg.ssm.head_dim)
                     + d_inner * d)
        n_attn = L // cfg.attn_every
        attn = 2 * d * cfg.n_heads * cfg.head_dim + 2 * d * cfg.n_kv_heads * cfg.head_dim
        mlp = 3 * d * cfg.d_ff
        # shared weights are stored once but applied n_attn times: active
        # (compute) parameters count per application
        return L * per_mamba + n_attn * (attn + mlp)
    if cfg.mla is not None:
        m = cfg.mla
        attn = (d * cfg.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                + m.kv_lora_rank * cfg.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                + cfg.n_heads * m.v_head_dim * d)
    else:
        attn = (d * cfg.n_heads * cfg.head_dim * 2
                + d * cfg.n_kv_heads * cfg.head_dim * 2)
    if cfg.moe is not None:
        mo = cfg.moe
        ffn = 3 * d * mo.d_ff_expert * (mo.top_k + mo.n_shared)
    else:
        mult = 3 if cfg.mlp_type == "swiglu" else 2
        ffn = mult * d * cfg.d_ff
    total = cfg.n_layers * (attn + ffn)
    if cfg.encdec:
        total *= 2  # encoder + decoder stacks
    return float(total)
