"""Shared model building blocks (functions over explicit parameter dicts), in
PyTorch.

Counterpart of ``repro.models.layers``.  ``dot`` is the reference's matmul in
the compute dtype with float32 accumulation and output
(``preferred_element_type``): on a card it multiplies compute-dtype operands
with float32 output (``aten::mm.dtype``); on the CPU, where that overload is
not registered, it upcasts the compute-dtype operands to float32, which gives
the same products (a bf16 x bf16 product is exact in float32).  Its backward
is the reference's transpose rule: the float32 cotangent times the
compute-dtype operand, accumulated in float32 and rounded to the compute
dtype.  A float32 compute dtype is a plain float32 matmul; TF32 stays off
(``torch.backends.cuda.matmul.allow_tf32`` is False by default and nothing
here sets it).

With a bf16 compute dtype on a card the backward takes the same products on
the bf16 tensor cores: the cotangent splits exactly into three bf16 planes
(``kernels.split_bf16x3``), and a bf16 x bf16 product is exact in float32, so
the planes' products summed in float32 are the float32 product in another
order of sums.  Each product's contraction runs in chunks of at most
``SPLIT_CHUNK`` terms, a chunk over its three planes stacked (the other
operand's chunk three times, ``kernels.repeat_bf16x3``), and the chunks are
summed in float32 outside the tensor cores (see ``SPLIT_CHUNK``).  float16
(whose pieces would leave its narrow exponent range), float32 and the CPU
keep the float32 product.  With ``obs`` enabled the backward counts its
products by path (``read_counters``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import obs as _obs
from repro_torch.kernels.split_bf16x3 import repeat_bf16x3, split_bf16x3

__all__ = [
    "dot",
    "bdot",
    "rmsnorm",
    "layernorm",
    "norm_apply",
    "norm_init",
    "mlp_init",
    "mlp_apply",
    "rope_freqs",
    "rope_apply",
    "yarn_mscale",
    "yarn_range",
    "embed_init",
    "embed_lookup",
    "unembed",
    "cross_entropy",
    "uniform_init",
    "as_dtype",
    "read_counters",
]

_COUNTS = {"split": 0, "float32": 0}   # backward products by path, while obs is enabled


def as_dtype(name) -> torch.dtype:
    """A config's dtype name (``"bfloat16"``) as a ``torch.dtype``."""
    if isinstance(name, torch.dtype):
        return name
    return getattr(torch, str(name))


def uniform_init(gen: torch.Generator, shape, scale, dtype) -> torch.Tensor:
    """Uniform in ``[-scale, scale)`` on the generator's device; on the meta
    device (``api.state.SHAPE_ONLY``) an empty tensor, nothing drawn."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=as_dtype(dtype), device="meta")
    x = torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (x * (2 * scale) - scale).to(as_dtype(dtype))


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D or 3-D) of compute-dtype operands with float32
    accumulation and output."""
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.is_cuda:
        op = torch.mm if a.dim() == 2 else torch.bmm
        return op(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


# The tensor cores' float32 accumulator rounds toward zero, so a bf16 product's
# error grows with its contraction's length, past a float32 product's (which
# grows with its square root) from a few hundred terms on (an H100: 4.4e-6
# against 1.1e-6 at 4096 terms, 2.8e-5 against 2.8e-6 at 24576).  The split
# products cut the contraction into chunks of at most SPLIT_CHUNK terms (the
# three planes stacked, 3 x SPLIT_CHUNK a product) and sum the chunks in
# float32 outside the tensor cores: at 512 they read 0.1-0.6x the float32
# product's error at the benchmark's shapes, 1024 up to 1.24x, and each halving
# adds the chunk sums' traffic (PERF.md's chunk sweep).
SPLIT_CHUNK = 512
# A chunk's output of at least this many bytes is added in place (one product
# a chunk); smaller ones run as one batched product whose chunk outputs, at
# most _PARTIALS_BYTES at a time, are summed after it: a product a chunk pays
# a launch each for small outputs (chaining every chunk made an H100's fwd+bwd
# 1.7 % slower at granite-34b's widths, 0.6 % at DeepSeek-V2-Lite's), and
# batching every chunk pays the large outputs' partials (2-3 % slower).
_CHAIN_BYTES = 1 << 24
_PARTIALS_BYTES = 1 << 31


def _mm_acc(out: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> None:
    """``out += a @ b`` in place: compute-dtype operands (3-D), float32
    ``out`` (on the CPU, as in ``_mm_f32``, the operands upcast)."""
    if a.is_cuda:
        torch.baddbmm(out, a, b, out_dtype=torch.float32, out=out)
    else:
        out += torch.matmul(a.float(), b.float())


def _chunks(k: int) -> tuple[int, int]:
    """``(c, length)``: ``k`` contraction terms in ``c`` chunks of ``length``
    (a multiple of 8, at most ``SPLIT_CHUNK`` rounded up to one)."""
    length = -(-k // (8 * max(1, -(-k // SPLIT_CHUNK)))) * 8 or 8
    return max(1, -(-k // length)), length


def _chunked_product(x: torch.Tensor, y: torch.Tensor, c: int, b: int) -> torch.Tensor:
    """``sum_j x_j @ y_j`` over ``c`` chunks: ``x`` (c B, m, k), ``y``
    (c B, k, n) -> float32 (B, m, n), the chunks summed in float32."""
    m, n = x.shape[1], y.shape[2]
    per = 4 * b * m * n
    group = 1 if per >= _CHAIN_BYTES else max(1, _PARTIALS_BYTES // per)
    out = None
    for j in range(0, c, group):
        xs, ys = x[j * b:(j + group) * b], y[j * b:(j + group) * b]
        if out is not None and group == 1:
            _mm_acc(out, xs, ys)
            continue
        part = _mm_f32(xs, ys).view(-1, b, m, n)
        part = part.sum(0) if part.shape[0] > 1 else part[0]
        out = part if out is None else out.add_(part)
    return out


def _split_products(g, a, b, need_a: bool, need_b: bool):
    """``g @ b^T`` and ``a^T @ g`` of a float32 ``g`` (..., M, N) and bf16
    ``a`` (..., M, K), ``b`` (..., K, N), on the bf16 tensor cores through
    ``g``'s three planes, one split for each product (its chunks run along
    that product's contraction); float32 results (None where not needed)."""
    two_d = g.dim() == 2
    if two_d:
        g, a, b = g[None], a[None], b[None]
    bsz, m, n = g.shape
    g = g.contiguous()
    ga = gb = None
    if need_a:                                      # contraction over N
        c, length = _chunks(n)
        planes = split_bf16x3(g, 2, length).view(c * bsz, m, 3 * length)
        other = repeat_bf16x3(b.contiguous(), 2, length).view(c * bsz, -1, 3 * length)
        ga = _chunked_product(planes, other.mT, c, bsz)
        del planes, other
    if need_b:                                      # contraction over M
        c, length = _chunks(m)
        planes = split_bf16x3(g, 1, length).view(c * bsz, 3 * length, n)
        other = repeat_bf16x3(a.contiguous(), 1, length).view(c * bsz, 3 * length, -1)
        gb = _chunked_product(other.mT, planes, c, bsz)
    if two_d:
        ga = None if ga is None else ga[0]
        gb = None if gb is None else gb[0]
    return ga, gb


class _DotF32(torch.autograd.Function):
    """Compute-dtype product with float32 output and the reference's backward
    (float32 cotangent x compute-dtype operand, rounded to the compute dtype,
    then to each input's dtype)."""

    @staticmethod
    def forward(ctx, a, b, cd):
        ac, bc = a.to(cd), b.to(cd)
        ctx.save_for_backward(ac, bc)
        ctx.dtypes = (a.dtype, b.dtype)
        return _mm_f32(ac, bc)

    @staticmethod
    def backward(ctx, g):
        ac, bc = ctx.saved_tensors
        da, db = ctx.dtypes
        need_a, need_b = ctx.needs_input_grad[:2]
        g = g.float()
        split = ac.dtype == torch.bfloat16 and g.is_cuda
        if _obs.enabled():
            _COUNTS["split" if split else "float32"] += 1
        if split:
            ga, gb = _split_products(g, ac, bc, need_a, need_b)
        else:
            ga = torch.matmul(g, bc.float().mT) if need_a else None
            gb = torch.matmul(ac.float().mT, g) if need_b else None
        return (ga if ga is None else ga.to(ac.dtype).to(da),
                gb if gb is None else gb.to(bc.dtype).to(db), None)


def read_counters() -> dict:
    """``{"split", "float32"}``: the backward products of ``dot``/``bdot``
    that took the three bf16 planes and those that took the float32 product,
    counted while ``obs`` was enabled since the last read; reset on read and
    added to the obs registry's counters ``dot_bwd_split`` and
    ``dot_bwd_float32``."""
    out = dict(_COUNTS)
    for k in _COUNTS:
        _COUNTS[k] = 0
    reg = _obs.registry()
    reg.counter("dot_bwd_split").inc(out["split"])
    reg.counter("dot_bwd_float32").inc(out["float32"])
    return out


def _dot2(a: torch.Tensor, b: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    if cd == torch.float32:
        return _mm_f32(a.float(), b.float())
    return _DotF32.apply(a, b, cd)


def dot(x: torch.Tensor, w: torch.Tensor, compute_dtype) -> torch.Tensor:
    """``x @ w`` in the compute dtype with float32 accumulation (the
    reference's MXU convention): ``x`` (..., k), ``w`` (k, n) -> float32
    (..., n).  The leading axes fold into one 2-D product."""
    cd = as_dtype(compute_dtype)
    lead = x.shape[:-1]
    out = _dot2(x.reshape(-1, x.shape[-1]), w, cd)
    return out.reshape(*lead, w.shape[-1])


def bdot(a: torch.Tensor, b: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Batched ``a @ b`` ((B, m, k) x (B, k, n)) in the compute dtype with
    float32 accumulation and output (the attention einsums)."""
    return _dot2(a, b, as_dtype(compute_dtype))


def rmsnorm(x, w, eps=1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * w.float()
    return out.to(x.dtype)


def layernorm(x, w, b, eps=1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps) * w.float() + b.float()
    return out.to(x.dtype)


def norm_init(d, norm_type, dtype, device, lead=()):
    """Norm weights; ``lead`` prepends axes (the stacked layers)."""
    dt, shape = as_dtype(dtype), tuple(lead) + (d,)
    if norm_type == "rmsnorm":
        return {"w": torch.ones(shape, dtype=dt, device=device)}
    return {"w": torch.ones(shape, dtype=dt, device=device),
            "b": torch.zeros(shape, dtype=dt, device=device)}


def norm_apply(x, p, norm_type):
    if norm_type == "rmsnorm":
        return rmsnorm(x, p["w"])
    return layernorm(x, p["w"], p["b"])


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------


def mlp_init(gen, d_model, d_ff, mlp_type, dtype, lead=()):
    """MLP weights; ``lead`` prepends axes (the decoder's stacked layers)."""
    lead = tuple(lead)
    scale_in = (1.0 / d_model) ** 0.5
    scale_out = (1.0 / d_ff) ** 0.5
    if mlp_type == "swiglu":
        return {
            "wg": uniform_init(gen, lead + (d_model, d_ff), scale_in, dtype),
            "wu": uniform_init(gen, lead + (d_model, d_ff), scale_in, dtype),
            "wd": uniform_init(gen, lead + (d_ff, d_model), scale_out, dtype),
        }
    return {
        "wi": uniform_init(gen, lead + (d_model, d_ff), scale_in, dtype),
        "wd": uniform_init(gen, lead + (d_ff, d_model), scale_out, dtype),
    }


def mlp_apply(x, p, mlp_type, compute_dtype):
    if mlp_type == "swiglu":
        g = dot(x, p["wg"], compute_dtype)
        u = dot(x, p["wu"], compute_dtype)
        h = F.silu(g) * u
        return dot(h.to(x.dtype), p["wd"], compute_dtype).to(x.dtype)
    h = dot(x, p["wi"], compute_dtype)
    if mlp_type == "relu2":  # nemotron squared-ReLU
        h = torch.square(F.relu(h))
    else:  # gelu: jax.nn.gelu's default is the tanh approximation
        h = F.gelu(h, approximate="tanh")
    return dot(h.to(x.dtype), p["wd"], compute_dtype).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def yarn_mscale(factor: float, mscale: float) -> float:
    """DeepSeek-V2's ``yarn_get_mscale``: 0.1 m ln(s) + 1 (1 when s <= 1)."""
    return 0.1 * mscale * math.log(factor) + 1.0 if factor > 1 else 1.0


def yarn_range(head_dim, theta, yarn) -> tuple[int, int]:
    """The rotary pairs' ramp ends ``(lo, hi)``: pair i below ``lo`` keeps its
    frequency, from ``hi`` on it is divided by the factor.  The correction
    dimension of ``beta`` rotations over the original context L0 is
    ``d ln(L0 / (2 pi beta)) / (2 ln theta)``."""
    def corr(beta):
        return head_dim * math.log(yarn.original_max_position / (2 * math.pi * beta)) \
            / (2 * math.log(theta))

    return (max(math.floor(corr(yarn.beta_fast)), 0),
            min(math.ceil(corr(yarn.beta_slow)), head_dim - 1))


def rope_freqs(head_dim, theta, device=None, yarn=None):
    """The rotary inverse frequencies ``theta^(-2i/d)``; with ``yarn``
    (``configs.base.YarnConfig``) DeepSeek-V2's YaRN blend of them with the
    same divided by the factor, along a linear ramp over pairs ``yarn_range``."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    extra = 1.0 / torch.pow(float(theta), exps)  # (half,)
    if yarn is None:
        return extra
    inter = 1.0 / (yarn.factor * torch.pow(float(theta), exps))
    lo, hi = yarn_range(head_dim, theta, yarn)
    ramp = ((torch.arange(half, dtype=torch.float32, device=device) - lo)
            / ((hi - lo) or 0.001)).clamp(0.0, 1.0)
    return inter * ramp + extra * (1.0 - ramp)


def rope_apply(x, positions, theta, yarn=None):
    """x: (..., seq, heads, head_dim); positions: (..., seq) int32.  With
    ``yarn`` the frequencies are ``rope_freqs``' blend and cos and sin are
    scaled by ``yarn_mscale(s, mscale) / yarn_mscale(s, mscale_all_dim)``."""
    half = x.shape[-1] // 2
    inv = rope_freqs(x.shape[-1], theta, device=x.device, yarn=yarn)
    ang = positions[..., :, None].float() * inv[None, :]  # (..., seq, half)
    sin = torch.sin(ang)[..., :, None, :]
    cos = torch.cos(ang)[..., :, None, :]
    if yarn is not None:
        mscale = yarn_mscale(yarn.factor, yarn.mscale) / yarn_mscale(yarn.factor,
                                                                    yarn.mscale_all_dim)
        if mscale != 1.0:
            sin, cos = sin * mscale, cos * mscale
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_init(gen, padded_vocab, d_model, dtype):
    return {"table": uniform_init(gen, (padded_vocab, d_model), d_model ** -0.5, dtype)}


def embed_lookup(tokens, p):
    return F.embedding(tokens.long(), p["table"])


def unembed(x, p, compute_dtype):
    """Logits = x @ table^T (tied); returns f32 logits."""
    return dot(x, p["table"].mT, compute_dtype)


def cross_entropy(logits, labels, vocab_size):
    """Mean token NLL; ignores padded vocab tail via label validity."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    return torch.mean(nll)
